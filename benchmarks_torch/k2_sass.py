"""K2's instruction count per coordinate, from its SASS.

    PYTHONPATH=src python -m benchmarks_torch.k2_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.k2_sass --sass F   # a saved dump

Builds the kernels (``repro_torch.kernels._build``), disassembles
``griewank_aggregates.so`` with ``cuobjdump -sass`` and counts the
instructions of ``griewank_tile_partials``'s per-coordinate loop, split into
what every coordinate issues and the two branches of ``griewank_planes``
(``log1pf`` where sin²u < 0.5, ``logf`` otherwise): a warp issues a
branch's instructions when any of its 32 coordinates takes it, so a warp
whose lanes take both issues both. The slow path of ``sinf``/``cosf``
(Payne-Hanek reduction, |u| >= 105615, starting at the ``+INF`` test) is
left out: Griewank's |u| = |x|/sqrt(i) never exceeds 600. That count is
static, and it is what this build of K2 issues: index, address, load and
loop instructions included, and both branches wherever a warp diverges.

The function's own count (``function``) keeps only the arithmetic
Griewank needs per coordinate, by pipe: the library sequences of
``rsqrtf``, ``sinf``/``cosf`` (fast path) and one of ``log1pf``/``logf``
(the special-value fix-ups that normal inputs branch over left out), the
products, compares and selects, and the three masked adds. It leaves out
moves, branches and loads, and, outside the sin/cos sequences, every
integer instruction and conversion: the 64-bit index, the ragged-tile
test on it, its conversion to
float, the addresses and the loop. ``chip_smoke.py`` prices it at each
pipe's rate for K2's bound, and prints the build's count beside it. Prints
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

KERNEL = "griewank_tile_partials"
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA\s+(?:\w+\s+)?0x([0-9a-f]+)")


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
    """(address, instruction) of one kernel's SASS."""
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
             "LDC", "ULDC", "NOP")


def pipe(ins: str) -> str | None:
    """The pipe an instruction issues to, or None for what is not
    arithmetic (control, moves, loads, uniform-datapath instructions)."""
    op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
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


def count(sass: str) -> dict:
    """Instructions per coordinate of the loop: ``common`` (issued for
    every coordinate), ``log1p`` and ``log`` (each branch's own), and the
    address ranges they came from."""
    ins = instructions(sass)
    addr = [a for a, _ in ins]
    # the loop: the backward branch with the widest span
    back = [(a, t) for a, i in ins if (t := branch_target(i)) is not None
            and t < a]
    end, head = max(back, key=lambda at: at[0] - at[1])
    loop = [(a, i) for a, i in ins if head <= a <= end]
    skip: list[tuple[int, int]] = []
    # sinf/cosf slow paths: from the |u| == inf test to the target of the
    # branch just before it (the fast path's jump over them)
    for k, (a, i) in enumerate(loop):
        if i.startswith("FSETP.NEU") and "+INF" in i:
            t = branch_target(loop[k - 1][1])
            if t is None or t <= a:
                raise ValueError(f"no fast-path branch before {a:#x}")
            skip.append((a, t))
    # the s2 < 0.5 branch: FSETP ... 0.5, then a branch to the log1p path;
    # the log path falls through and ends in an unconditional branch
    k = next(k for k, (_, i) in enumerate(loop)
             if i.startswith("FSETP.GEU") and i.rstrip(", PT").endswith(
                 "0.5"))
    log1p_at = branch_target(loop[k + 1][1])
    log_at = loop[k + 2][0]
    join = next(branch_target(i) for a, i in loop
                if log_at <= a < log1p_at and i.startswith("BRA"))
    regions = {"log": (log_at, log1p_at), "log1p": (log1p_at, join)}

    def n_in(lo, hi):
        return sum(lo <= a < hi for a, _ in loop)

    fn = function_count(loop, skip, regions)
    n_skip = sum(n_in(*r) for r in skip)
    n_log, n_log1p = (n_in(*regions[r]) for r in ("log", "log1p"))
    return {"kernel": KERNEL, "loop": [hex(head), hex(end)],
            "loop_instructions": len(loop), "slow_paths": [
                [hex(lo), hex(hi)] for lo, hi in skip],
            "slow_path_instructions": n_skip,
            "common": len(loop) - n_skip - n_log - n_log1p,
            "log1p": n_log1p, "log": n_log,
            "per_coordinate_log1p_path": len(loop) - n_skip - n_log,
            "per_coordinate_both_branches": len(loop) - n_skip,
            "function_instructions": len(addr), "function": fn}


def function_count(loop, skip, regions) -> dict:
    """Griewank's own instructions per coordinate by pipe, ``common`` and
    each branch (see the module's docstring). The sin/cos span runs from
    ``MUFU.RSQ`` to the ``sin^2 u < 0.5`` test; outside it, in the common
    path, only float instructions count (float32 arithmetic, MUFU, float
    compares and selects). Inside a branch, what
    a forward conditional branch skips (the fix-ups of inf, NaN and zero)
    is left out."""
    def skipped(a):
        return any(lo <= a < hi for lo, hi in skip)

    span_lo = next(a for a, i in loop if i.startswith("MUFU.RSQ"))
    span_hi = regions["log"][0]
    out = {r: dict.fromkeys(PIPES, 0) for r in ("common", "log1p", "log")}
    for name, (lo, hi) in regions.items():
        body = [(a, i) for a, i in loop if lo <= a < hi]
        fix = [(a, t) for a, i in body if (t := branch_target(i))
               and i.startswith("@") and a < t < hi]
        for a, i in body:
            if not any(f < a < t for f, t in fix) and (p := pipe(i)):
                out[name][p] += 1
    for a, i in loop:
        if skipped(a) or any(lo <= a < hi for lo, hi in regions.values()):
            continue
        p = pipe(i)
        if p and (span_lo <= a <= span_hi or p in ("fp32", "mufu")
                  or (p == "alu" and i.lstrip("@!P0123456789T ")[0] == "F")):
            out["common"][p] += 1
    return out


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
