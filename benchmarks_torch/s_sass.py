"""S's (the RG-LRU's) gate instructions per element, from its SASS.

    PYTHONPATH=src python -m benchmarks_torch.s_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.s_sass --sass F   # a saved dump

Builds the kernels (``repro_torch.kernels._build``), disassembles
``rglru_scan.so`` with ``cuobjdump -sass`` and counts, in the bf16
instantiation of ``rglru_kernel``, what a gate thread issues for one row of
a tile: from its first 16-byte shared load after the wait for the tile
(``SYNCS.PHASECHK``) to its last 16-byte store of (a, g), straight-line
code for 8 channels (two sigmoids by table, ``expf``, the clamp, the square
root, the products). Counts by pipe as ``k2_sass.pipe`` sorts them
(``fp32``, ``alu``, ``mufu``, ``conv``), shared loads and stores apart
(``mem``), moves and the like as ``other``, and per element (the row over
8). ``chip_smoke.py`` counts its own build with ``count(disassemble())``
and prices the per-element counts at the issue rate and at each pipe's
rate beside S's bytes bound. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

from benchmarks_torch.k2_sass import instructions, opcode, pipe

KERNEL = "rglru_kernelI13__nv_bfloat16E"
ELEMENTS = 8          # bf16 channels in a row of 16 bytes


def disassemble() -> str:
    """Build the kernels and return ``cuobjdump -sass`` of S's library."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    _build.build_all()
    lib = _build.build_dir() / "rglru_scan.so"
    out = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def gate_row(ins: list[tuple[int, str]]) -> list[str]:
    """The instructions of one gate row, as described above."""
    ops = [opcode(i) for _, i in ins]
    wait = next(n for n, op in enumerate(ops)
                if op.startswith("SYNCS.PHASECHK"))
    first = next(n for n in range(wait, len(ops)) if ops[n] == "LDS.128")
    bar = next(n for n in range(first, len(ops)) if ops[n].startswith("BAR"))
    last = max(n for n in range(first, bar) if ops[n] == "STS.128")
    row = [i for _, i in ins[first:last + 1]]
    if any(opcode(i).startswith(("BRA", "BSSY", "CALL")) for i in row):
        raise ValueError("the gate row is not straight-line code")
    return row


def count(sass: str) -> dict:
    row = gate_row(instructions(sass, KERNEL))
    by_pipe = {}
    for i in row:
        p = "mem" if opcode(i).startswith(("LDS", "STS")) else (
            pipe(i) or "other")
        by_pipe[p] = by_pipe.get(p, 0) + 1
    return {"row": by_pipe, "row_total": len(row),
            "per_element": {p: n / ELEMENTS for p, n in by_pipe.items()},
            "per_element_total": len(row) / ELEMENTS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None,
                    help="count a saved cuobjdump -sass dump instead of "
                         "building and disassembling")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as fh:
            sass = fh.read()
    else:
        sass = disassemble()
    result = count(sass)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
