"""What W's machine code (``csrc/rwkv6_wkv.cu``) is made of, from its SASS.

    PYTHONPATH=src python -m benchmarks_torch.w_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.w_sass --sass F   # a saved dump

Builds the kernels (``repro_torch.kernels._build``), disassembles
``rwkv6_wkv.so`` with ``cuobjdump -sass`` and counts, in each
instantiation of ``wkv_kernel`` (bf16 and float32 at head sizes 16 and
64), the instructions that show its design: tensor-core products
(``HMMA``: the split-TF32 ``mma.sync``), TMA loads (``UTMALDG``), bulk
copies from shared memory to the cluster's other CTAs (``UBLKCP``),
mbarrier operations (``SYNCS``), the cluster barrier (``UCGABAR``),
generic loads (``LD``), shared loads and stores (``LDS``, ``STS``), the
SFU (``MUFU``), and atomics and reductions (``ATOM``, ``RED``), which must
be none. Static counts of the code, not of a run.
``chip_smoke.py`` prints them for its own build. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

from benchmarks_torch.k2_sass import instructions, opcode

KERNEL = "wkv_kernel"
FAMILIES = ("HMMA", "UTMALDG", "UBLKCP", "SYNCS", "UCGABAR", "LD", "LDS",
            "STS", "MUFU", "ATOM", "ATOMS", "RED")


def disassemble() -> str:
    """Build the kernels and return ``cuobjdump -sass`` of W's library."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    _build.build_all()
    lib = _build.build_dir() / "rwkv6_wkv.so"
    out = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def functions(sass: str) -> list[str]:
    """The mangled names of W's kernel instantiations in the dump."""
    names = re.findall(r"Function : (\S+)", sass)
    return [n for n in names if KERNEL in n]


def count(sass: str) -> dict:
    """{instantiation: {family: static count, "total": all instructions}}."""
    out = {}
    for name in functions(sass):
        by = dict.fromkeys(FAMILIES, 0)
        ins = instructions(sass, name)
        for _, i in ins:
            fam = opcode(i).split(".")[0]
            if fam.startswith("UCGABAR"):       # _ARV, _WAIT
                fam = "UCGABAR"
            if fam in by:
                by[fam] += 1
        by["total"] = len(ins)
        out[name] = by
    if not out:
        raise ValueError(f"no SASS for {KERNEL}")
    return out


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
