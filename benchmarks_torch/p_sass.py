"""P's (ABO-ZO's perturbation) instruction count per element, from its SASS.

    PYTHONPATH=src python -m benchmarks_torch.p_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.p_sass --sass F   # a saved dump

Builds the kernels (``repro_torch.kernels._build``), disassembles
``abo_zo_perturb.so`` with ``cuobjdump -sass`` and counts the
instructions of the bf16 instantiation's grid-stride loop (from the
loop's branch target to its backward branch: one element a thread an
iteration), by class: ``alu_only`` (shifts and logic, ``SHF``/``LOP3``,
which only the integer ALU pipe runs: 64 results a clock on each SM),
``int_add`` (integer adds and multiply-adds, which the compiler spreads
over the ALU and the FMA pipe), ``fp32``, ``conv``, ``mem`` and ``other``
(compares, selects, branches, moves).

The function's own count (``function``) is threefry-2x32's 20 rounds (an
add, a rotation and an xor each), its key schedule (2 + 5·2 adds, the
constants folded into the keys outside the loop), the 64-bit counter
(2 adds), the sign (an xor, a compare and a select), the bf16 widening
(1) and narrowing (a conversion) and the float32 add: 41 shift/logic, 35
adds, 2 other, 1 fp32, 1 conv. ``chip_smoke.py``
prices it for P's bound (the shift/logic at the ALU pipe's rate, the whole
at the issue rate) and prints the build's loop count beside it. Prints one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

from benchmarks_torch.k2_sass import branch_target, instructions, opcode

KERNEL = "abo_zo_perturbI13__nv_bfloat16"
FUNCTION = {"alu_only": 41, "int_add": 35, "other": 2, "fp32": 1, "conv": 1}


def disassemble() -> str:
    """Build the kernels and return ``cuobjdump -sass`` of P's library."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    _build.build_all()
    lib = _build.build_dir() / "abo_zo_perturb.so"
    out = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def kind(ins: str) -> str:
    op = opcode(ins)
    if op.startswith(("SHF", "LOP3")):
        return "alu_only"
    if op.startswith(("IADD3", "IMAD", "VIADD")) and not op.startswith(
            "IMAD.MOV"):
        return "int_add"
    if op.startswith(("FADD", "FFMA", "FMUL")):
        return "fp32"
    if op.startswith(("F2F", "F2I", "I2F")):
        return "conv"
    if op.startswith(("LDG", "STG")):
        return "mem"
    return "other"


def count(sass: str) -> dict:
    ins = instructions(sass, KERNEL)
    back = [(a, branch_target(i)) for a, i in ins
            if branch_target(i) is not None and branch_target(i) < a]
    if len(back) != 1:
        raise ValueError(f"expected one backward branch, found {back}")
    end, start = back[0]
    body = {}
    for a, i in ins:
        if start <= a <= end:
            k = kind(i)
            body[k] = body.get(k, 0) + 1
    return {"loop": body, "loop_total": sum(body.values()),
            "function": FUNCTION, "function_total": sum(FUNCTION.values())}


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
