"""Where K3 at head_dim 256 or 64 frees its shared-memory stages, from its
SASS.

    PYTHONPATH=src python -m benchmarks_torch.k3_sass            # on the H100
    PYTHONPATH=src python -m benchmarks_torch.k3_sass --kernel d64
    PYTHONPATH=src python -m benchmarks_torch.k3_sass --sass F   # a saved dump

A consumer of ``csrc/flash_attention_sm90_d256.cu`` (or of
``csrc/flash_attention_sm90_d64.cu``, each of its instantiations read on
its own) frees a Q, K or V stage with an mbarrier arrival (``SYNCS.ARRIVE``) once the tensor-core
products that read it are done, which it learns by waiting on their
groups (``WARPGROUP.DEPBAR``). An arrival issued after a product
(``HGMMA``) with no wait between them lets the producer's next TMA load
overwrite the stage under the product. The outputs show that race only
when the load lands first, and a load from L2 takes longer than a
product, so no comparison of outputs sees it (``k3_fault_check``'s
``d256_release_early``). This reads the order in the code instead: the
arrivals in the kernel's SASS, in address order, that follow a product
with no wait since. There must be none. It cannot tell apart a release
made between two waits (a V stage freed after the wait for S but before
the one for its P·V). ``chip_smoke.py`` checks its own build the same
way. Prints one JSON line; exits 1 if an arrival is early.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from benchmarks_torch.k2_sass import instructions, opcode

KERNEL = "flash_attn_sm90_d256"
# --kernel: (the kernel's name in its functions' names, its library)
KERNELS = {"d256": (KERNEL, "flash_attention_sm90_d256"),
           "d64": ("flash_attn_sm90_d64", "flash_attention_sm90_d64")}


def disassemble(library: str = "flash_attention_sm90_d256") -> str:
    """Build the kernels and return ``cuobjdump -sass`` of one library."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    _build.build_all()
    lib = _build.build_dir() / f"{library}.so"
    out = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True)
    return out.stdout


def _functions(sass: str, kernel: str) -> list[str]:
    """The names of the functions whose name holds ``kernel`` (one a
    template instantiation)."""
    return [line.split("Function :", 1)[1].strip()
            for line in sass.splitlines()
            if "Function :" in line and kernel in line]


def releases(sass: str, kernel: str = KERNEL) -> dict:
    """{"arrivals": mbarrier arrivals, "products": HGMMA instructions,
    "early": addresses of the arrivals that follow a product with no wait
    on the products' groups between them}, summed over every function
    whose name holds ``kernel``, each read on its own."""
    names = _functions(sass, kernel)
    if not names:
        raise ValueError(f"no SASS for {kernel}")
    out = {"arrivals": 0, "products": 0, "early": []}
    for name in names:
        unwaited = False
        for addr, i in instructions(sass, name):
            op = opcode(i)
            if op.startswith("HGMMA"):
                out["products"] += 1
                unwaited = True
            elif op.startswith("WARPGROUP.DEPBAR"):
                unwaited = False
            elif op.startswith("SYNCS.ARRIVE"):
                out["arrivals"] += 1
                if unwaited:
                    out["early"].append(hex(addr))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None,
                    help="read a saved cuobjdump -sass dump instead of "
                         "building and disassembling")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="d256")
    args = ap.parse_args(argv)
    kernel, library = KERNELS[args.kernel]
    if args.sass:
        with open(args.sass) as f:
            sass = f.read()
    else:
        sass = disassemble(library)
    result = releases(sass, kernel)
    print(json.dumps(result))
    if result["early"]:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
