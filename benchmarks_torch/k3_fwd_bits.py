"""K3's Hopper forward built from another commit's source beside the
checkout's: the same machine code, the same bits, the same time.

    git show REV:src/repro_torch/kernels/csrc/flash_attention_sm90.cu \
        > build/k3_fwd_bits/ref.cu                       # here, with git
    PYTHONPATH=src python -m benchmarks_torch.k3_fwd_bits \
        --ref build/k3_fwd_bits/ref.cu                   # on the H100

Written for the move of the forward's mbarrier, TMA, descriptor and wgmma
helpers into ``csrc/sm90.cuh``: ``--ref`` is a self-contained
``flash_attention_sm90.cu`` from before the move. Builds it and the
checkout's source into ``build/k3_fwd_bits/`` (one ``nvcc`` each, the
build's flags), then

* compares their SASS (``cuobjdump -sass``), instruction by instruction,
  with addresses, encodings and symbol names left out;
* holds the two builds' outputs and log-sum-exps bit for bit at the shapes
  of ``SHAPES`` (bf16, inputs from ``--seed``);
* times both in turns (ref, checkout, checkout, ref; CUDA events over 20
  calls after a warm-up) at the model's layer shape (1, 32/8, 8192, 128)
  causal.

Prints one JSON line with the readings and the card's name and power
limit; exits 1 if the SASS or any bit differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# (b, hq, hkv, sq, sk, d, causal, window)
SHAPES = [(1, 8, 2, 384, 384, 128, True, None),
          (1, 32, 8, 333, 333, 120, True, 96),
          (1, 4, 2, 200, 200, 128, True, None),
          (2, 4, 2, 100, 300, 128, False, None),
          (1, 32, 8, 8192, 8192, 128, True, None)]
TIMED = SHAPES[-1]
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def build(sources: dict[str, Path]) -> dict[str, Path]:
    """Each source into build/k3_fwd_bits/<name>.so, all nvcc's at once."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT.parent / "k3_fwd_bits"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def sass(lib: Path) -> list[str]:
    """The instructions of every function in ``lib``, in order, without
    addresses, encodings or symbol names."""
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return [m.group(1) for line in text.splitlines()
            if (m := _INSN.match(line))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", required=True,
                    help="a self-contained flash_attention_sm90.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    if not torch.cuda.is_available():
        sys.exit("k3_fwd_bits needs a CUDA device")
    dev = torch.device("cuda")
    libs = build({"ref": Path(args.ref),
                  "checkout": _build.CSRC / "flash_attention_sm90.cu"})
    code = {n: sass(p) for n, p in libs.items()}
    launchers = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path.resolve()))
        fn = lib.flash_attention_sm90_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launchers[name] = (lib, fn)

    def run(name, q, k, v, causal, window, lse):
        fa._launcher_sm90 = lambda: launchers[name]
        return fa.flash_attention_sm90(q, k, v, causal=causal, window=window,
                                       lse=lse)

    saved = fa._launcher_sm90
    out = {"sass_instructions": {n: len(c) for n, c in code.items()},
           "same_sass": code["ref"] == code["checkout"], "shapes": []}
    try:
        for shape in SHAPES:
            b, hq, hkv, sq, sk, d, causal, window = shape
            g = torch.Generator(device=dev).manual_seed(args.seed + sq + d)
            q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                       for s in ((b, hq, sq, d), (b, hkv, sk, d),
                                 (b, hkv, sk, d)))
            got = {}
            for name in launchers:
                lse = torch.empty((b, hq, sq), dtype=torch.float32,
                                  device=dev)
                got[name] = (run(name, q, k, v, causal, window, lse), lse)
            torch.cuda.synchronize()
            same = (torch.equal(got["ref"][0].view(torch.int16),
                                got["checkout"][0].view(torch.int16))
                    and torch.equal(got["ref"][1].view(torch.int32),
                                    got["checkout"][1].view(torch.int32)))
            reading = {"shape": list(shape), "same_bits": same}
            if shape == TIMED:
                turns = {n: [] for n in launchers}
                for name in ("ref", "checkout"):
                    run(name, q, k, v, causal, window, None)     # warm-up
                for name in ("ref", "checkout", "checkout", "ref"):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(20):
                        run(name, q, k, v, causal, window, None)
                    end.record()
                    torch.cuda.synchronize()
                    turns[name].append(start.elapsed_time(end) / 20)
                reading["ms"] = turns
            out["shapes"].append(reading)
            del q, k, v, got
    finally:
        fa._launcher_sm90 = saved
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    if not out["same_sass"] or not all(r["same_bits"] for r in out["shapes"]):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
