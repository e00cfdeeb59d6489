"""K2's instruction count per coordinate, from its SASS.

    PYTHONPATH=src python -m benchmarks_torch.k2_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.k2_sass --sass F   # a saved dump

Builds the kernels (``repro_torch.kernels._build``), disassembles
``griewank_aggregates.so`` with ``cuobjdump -sass`` and counts the
instructions of ``griewank_aggregates_kernel``. The kernel's tile body is
unrolled: 16 coordinates a thread, in two variants (the plain tile with a
32-bit index, and the guarded tile, ragged or past 2^31, with a 64-bit
one). The count is of the first: its 16 ``MUFU.RSQ`` have no 64-bit
conversion. The body runs from its 16 loads to its branch to the tile's
tree; a warp runs it for 16 x 32 coordinates, so a warp of 32 coordinates
issues the body over 16. Of each coordinate's code, the out-of-line calls
are left out where the hot path branches over them: the far sin/cos
(|u| >= 105615, Payne-Hanek) always, and the log branch (sin^2 u >= 0.5)
from ``log1p``, whose own code is the inline region after that branch.
``log`` is the call's stub and the called function. A warp issues a
branch's instructions when any of its 32 coordinates takes it, so a warp
whose lanes take both issues both. Printed apart, per tile and warp: the
prologue (the tile loop's head up to the body) and the tree (the
shared-memory exchange, the barrier, warp 0's levels 128..1 and its
publication of the partial; ``tree_other_warps`` for the 7 warps that only
store and wait); and the fold CTA's code with its chain's instructions per
tile.

The function's own count (``function``) keeps only the arithmetic
Griewank needs per coordinate, by pipe: ``rsqrt``, one sin/cos range
reduction and both polynomials, one of ``log1pf``/``logf`` (the
special-value fix-ups that a forward branch skips left out), the products,
compares and selects, and the tile sum's adds in each thread. It leaves out
moves, branches, calls and loads, and, outside the sin/cos span (from
``MUFU.RSQ`` to the ``sin^2 u < 0.5`` test), every integer instruction and
conversion: the index, its conversion to float, the addresses and the tile
loop. ``chip_smoke.py`` prices it at each pipe's rate for K2's bound, and
prints the build's count beside it. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

KERNEL = "griewank_aggregates_kernel"
LEAVES = 16          # coordinates a thread holds in a tile
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA\s+(?:\w+\s+)?0x([0-9a-f]+)")
_CALL = re.compile(r"^CALL\.REL\.NOINC\s+0x([0-9a-f]+)")


def disassemble() -> str:
    """Build the kernels and return ``cuobjdump -sass`` of K2's library."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    _build.build_all()
    lib = _build.build_dir() / "griewank_aggregates.so"
    out = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def instructions(sass: str, kernel: str = KERNEL) -> list[tuple[int, str]]:
    """(address, instruction) of one kernel's SASS, its out-of-line device
    functions included."""
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _LINE.search(line)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2).strip()))
    if not out:
        raise ValueError(f"no SASS for {kernel}")
    return out


# Pipes of the function's instructions, with the per-SM rate of each
# (results a clock, compute capability 9.0: the CUDA C++ Programming
# Guide's table of arithmetic instruction throughput): float32 add,
# multiply and fma 128; compares, selects, min/max, integer add, logic,
# shifts and integer multiply-add 64; MUFU (rsqrt) and conversions 16.
PIPES = {"fp32": 128, "alu": 64, "mufu": 16, "conv": 16}
_NOT_WORK = ("BRA", "BSSY", "BSYNC", "MOV", "IMAD.MOV", "CS2R", "LDG",
             "LDC", "ULDC", "NOP", "CALL", "RET", "WARPSYNC")


def opcode(ins: str) -> str:
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def pipe(ins: str) -> str | None:
    """The pipe an instruction issues to, or None for what is not
    arithmetic (control, moves, calls, loads, uniform-datapath
    instructions)."""
    op = opcode(ins)
    if op.startswith(_NOT_WORK) or op.startswith("U") or (
            op.startswith("HFMA2.MMA") and "-RZ, RZ" in ins):
        return None
    if op.startswith(("FFMA", "FMUL", "FADD")):
        return "fp32"
    if op.startswith("MUFU"):
        return "mufu"
    if op.startswith(("F2I", "I2F.", "F2F")) or op == "I2F":
        return "conv"
    return "alu"


def branch_target(ins: str) -> int | None:
    m = _BRA.match(ins)
    return int(m.group(2), 16) if m else None


def call_target(ins: str) -> int | None:
    m = _CALL.match(ins)
    return int(m.group(1), 16) if m else None


def _unconditional(ins: str) -> bool:
    return not ins.startswith("@") and opcode(ins) == "BRA"


def hot_path(ins: list[tuple[int, str]]) -> list[int]:
    """Indices into ``ins`` of the plain tile's hot path: its 16 loads, the
    test that every |x| is below 105614, and the near body the test
    branches to, up to its branch to the tile's tree. The generic body
    that the test falls through to (each coordinate's own |u| test and the
    far sin/cos call) is left out."""
    k_test = next(k for k, (_, i) in enumerate(ins)
                  if opcode(i).startswith("FSETP") and "105614" in i)
    k_bra = next(k for k in range(k_test + 1, len(ins))
                 if branch_target(ins[k][1]) is not None)
    addr = {a: k for k, (a, _) in enumerate(ins)}
    k_near = addr[branch_target(ins[k_bra][1])]
    loads, start = 0, k_test
    while loads < LEAVES:
        start -= 1
        if opcode(ins[start][1]).startswith("LDG"):
            loads += 1
    last_rsq = max(a for a, i in ins if i.startswith("MUFU.RSQ"))
    k_end = next(k for k in range(k_near, len(ins))
                 if _unconditional(ins[k][1])
                 and branch_target(ins[k][1]) > last_rsq)
    path = list(range(start, k_bra + 1)) + list(range(k_near, k_end + 1))
    n_rsq = sum(ins[k][1].startswith("MUFU.RSQ") for k in path)
    if n_rsq != LEAVES:
        raise ValueError(f"{n_rsq} MUFU.RSQ on the hot path, not {LEAVES}")
    return path


def _skips(ins, lo, hi):
    """Ranges [from, to) that forward conditional branches inside
    ins[lo:hi] jump over."""
    out = []
    for a, i in ins[lo:hi]:
        t = branch_target(i)
        if t is not None and i.startswith("@") and t > a:
            out.append((a, t))
    return out


def coordinate_regions(ins, path):
    """Per coordinate of the hot path: the log branch's stub (its call)
    and the inline log1p region, as address ranges [lo, hi)."""
    stub, log1p = [], []
    for n, k in enumerate(path):
        i = ins[k][1]
        if opcode(i).startswith("FSETP.GEU") and i.rstrip(", PT").endswith(
                "0.5"):
            j = next(j for j in path[n + 1:]
                     if branch_target(ins[j][1]) is not None)
            t = branch_target(ins[j][1])
            join = next(branch_target(ins[m][1]) for m in path
                        if ins[j][0] < ins[m][0] < t
                        and _unconditional(ins[m][1]))
            stub.append((ins[j][0] + 0x10, t))
            log1p.append((t, join))
    if len(stub) != LEAVES:
        raise ValueError(f"{len(stub)} log branches on the hot path, not "
                         f"{LEAVES}")
    return stub, log1p


def function_body(ins, entry):
    """(lo, hi) index range of the out-of-line function at ``entry``,
    its RET included."""
    lo = next(k for k, (a, _) in enumerate(ins) if a == entry)
    hi = next(k for k in range(lo, len(ins))
              if opcode(ins[k][1]).startswith("RET")) + 1
    return lo, hi


def tile_loop(ins, path):
    """(head, merge, skip_k, skip, back): the tile loop's head, the tree's
    first instruction, warps 1..7's branch past warp 0's levels and its
    target, and the loop's backward branch (indices into ``ins``)."""
    addr = {a: k for k, (a, _) in enumerate(ins)}
    start, end = path[0], path[-1]
    merge = addr[branch_target(ins[end][1])]
    back = next(k for k in range(merge, len(ins))
                if (t := branch_target(ins[k][1])) is not None
                and t <= ins[start][0])
    head = addr[branch_target(ins[back][1])]
    bar = next(k for k in range(merge, back)
               if opcode(ins[k][1]).startswith("BAR"))
    skip_k = next(k for k in range(bar, back)
                  if ins[k][1].startswith("@")
                  and branch_target(ins[k][1]) is not None)
    skip = addr[branch_target(ins[skip_k][1])]
    return head, merge, skip_k, skip, back


def fold_code(ins):
    """The fold CTA's code (the target of the entry's branch for CTA 0, up
    to the first out-of-line function or divergence handler) and its
    chain: the innermost loop whose body adds staged rows (LDS and FADD, no
    global load), in instructions per tile."""
    entry = next(branch_target(i) for _, i in ins[:16]
                 if branch_target(i) is not None)
    addr = {a: k for k, (a, _) in enumerate(ins)}
    lo = addr[entry]
    ends = [t for _, i in ins if (t := call_target(i)) is not None] + [
        branch_target(i) for _, i in ins if opcode(i).startswith("BRA.DIV")]
    hi = min([addr[t] for t in ends if t is not None and t > entry]
             + [len(ins)])
    region = ins[lo:hi]
    loops = []
    for k, (a, i) in enumerate(region):
        t = branch_target(i)
        if t is not None and t < a:
            body = [x for b, x in region if t <= b <= a]
            n_add = sum(opcode(x).startswith("FADD") for x in body)
            if n_add and any(opcode(x).startswith("LDS") for x in body) \
                    and not any(opcode(x).startswith("LDG") for x in body):
                loops.append((len(body), n_add))
    chain = min(loops) if loops else None
    return {"instructions": hi - lo,
            "chain_instructions_per_tile":
                None if chain is None else chain[0] / chain[1]}


def count(sass: str) -> dict:
    ins = instructions(sass)
    path = hot_path(ins)
    stub, log1p = coordinate_regions(ins, path)

    def n_in(ranges):
        return sum(lo <= ins[k][0] < hi for k in path for lo, hi in ranges)
    entries = {call_target(ins[k][1]) for k in path
               if call_target(ins[k][1]) is not None}
    if len(entries) != 1:
        raise ValueError(f"the hot path calls {entries}")
    log_lo, log_hi = function_body(ins, entries.pop())
    n_stub, n_log1p = n_in(stub), n_in(log1p)
    body = len(path) - n_stub
    head, merge, skip_k, skip, back = tile_loop(ins, path)
    return {"kernel": KERNEL,
            "hot_path": [hex(ins[path[0]][0]), hex(ins[path[-1]][0])],
            "body_instructions": body,
            "common": (body - n_log1p) / LEAVES,
            "log1p": n_log1p / LEAVES,
            "log": n_stub / LEAVES + (log_hi - log_lo),
            "per_coordinate_log1p_path": body / LEAVES,
            "tile_prologue": path[0] - head,
            "tree_warp0": back + 1 - merge,
            "tree_other_warps": (skip_k + 1 - merge) + (back + 1 - skip),
            "fold": fold_code(ins),
            "kernel_instructions": len(ins),
            "function": function_count(ins, path, stub, log1p,
                                       (log_lo, log_hi))}


def function_count(ins, path, stub, log1p, log_fn) -> dict:
    """Griewank's own instructions per coordinate by pipe, ``common`` and
    each branch (see the module's docstring)."""
    out = {r: dict.fromkeys(PIPES, 0) for r in ("common", "log1p", "log")}

    def inside(a, ranges):
        return any(lo <= a < hi for lo, hi in ranges)
    # the sin/cos spans: each MUFU.RSQ up to its log branch's stub
    rsq = [ins[k][0] for k in path if ins[k][1].startswith("MUFU.RSQ")]
    spans = list(zip(rsq, [lo for lo, _ in stub]))
    addr = {a: k for k, (a, _) in enumerate(ins)}
    skipped = [r for lo, hi in log1p for r in _skips(ins, addr[lo], addr[hi])]
    for k in path:
        a, i = ins[k]
        p = pipe(i)
        if p is None or inside(a, stub):
            continue
        if inside(a, log1p):
            if not inside(a, skipped):
                out["log1p"][p] += 1
        elif inside(a, spans) or p in ("fp32", "mufu") or (
                p == "alu" and opcode(i)[0] == "F"):
            out["common"][p] += 1
    lo, hi = log_fn
    fix = _skips(ins, lo, hi)
    for a, i in ins[lo:hi]:
        if (p := pipe(i)) and not inside(a, fix):
            out["log"][p] += 1
    return {r: {p: v / (LEAVES if r != "log" else 1) for p, v in d.items()}
            for r, d in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None,
                    help="count a saved cuobjdump -sass dump instead of "
                         "building and disassembling")
    ap.add_argument("--out", default=None,
                    help="also write the dump to this path")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as fh:
            sass = fh.read()
    else:
        sass = disassemble()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(sass)
    result = count(sass)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
