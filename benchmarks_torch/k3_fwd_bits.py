"""K3's Hopper forward built from another commit's source beside the
checkout's: the same bits, and for the head_dim 128 kernel the same machine
code and time; for the head_dim 256 kernel the two times in turns.

    git show REV:src/repro_torch/kernels/csrc/flash_attention_sm90.cu \
        > build/k3_fwd_bits/ref.cu                       # here, with git
    PYTHONPATH=src python -m benchmarks_torch.k3_fwd_bits \
        --ref build/k3_fwd_bits/ref.cu                   # on the H100

    git show REV:src/repro_torch/kernels/csrc/flash_attention_sm90_d256.cu \
        > build/k3_fwd_bits/ref_d256.cu
    PYTHONPATH=src python -m benchmarks_torch.k3_fwd_bits --kernel d256 \
        --ref build/k3_fwd_bits/ref_d256.cu

``--kernel sm90`` (the default) was written for the move of the forward's
mbarrier, TMA, descriptor and wgmma helpers into ``csrc/sm90.cuh``: ``--ref``
is a self-contained ``flash_attention_sm90.cu`` from before the move. It
compares the two builds' SASS (``cuobjdump -sass``), instruction by
instruction, with addresses, encodings and symbol names left out, holds
outputs and log-sum-exps bit for bit at the shapes of ``SHAPES`` and times
both at the model's layer shape (1, 32/8, 8192, 128) causal.

``--kernel d256`` holds the redesigned head_dim 256 kernel against an
earlier ``flash_attention_sm90_d256.cu`` (its C entry without the cluster
and grid arguments, as before the redesign; ``sm90.cuh`` is the
checkout's): outputs and log-sum-exps bit for bit at every head_dim 256
shape of ``chip_smoke.ATTN_SHAPES``, each also against the plain version
(max abs and per row), and both timed at recurrentgemma-2b's layer shape
(1, 10/1, 8192, 256) causal, window 2048. The machine code differs by
design, so no SASS is compared. Where the two sources' key blocks
(``kBN``) differ, the bits are reported and not held.

Each build goes into ``build/k3_fwd_bits/`` (one ``nvcc`` each, the
build's flags, all at once); times are CUDA events over 20 calls after a
warm-up, in turns (ref, checkout, checkout, ref). Prints one JSON line
with the readings and the card's name and power limit; exits 1 if the SASS
(sm90) or any held bit differs.
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

ROOT = Path(__file__).resolve().parents[1]

# (b, hq, hkv, sq, sk, d, causal, window)
SHAPES = [(1, 8, 2, 384, 384, 128, True, None),
          (1, 32, 8, 333, 333, 120, True, 96),
          (1, 4, 2, 200, 200, 128, True, None),
          (2, 4, 2, 100, 300, 128, False, None),
          (1, 32, 8, 8192, 8192, 128, True, None)]
TIMED = SHAPES[-1]
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
_KBN = re.compile(r"constexpr int kBN = (\d+);")
_ARGS_SM90 = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
              + [ctypes.c_longlong] * 12
              + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 ctypes.c_void_p, ctypes.c_void_p])
# the head_dim 256 entry before the redesign (no cluster and grid)
_ARGS_D256_REF = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 12
                  + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                     ctypes.c_void_p, ctypes.c_void_p])
# and after it: the cluster and the grid before the stream
_ARGS_D256 = _ARGS_D256_REF[:-1] + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def build(sources: dict[str, Path]) -> tuple[dict[str, Path], dict]:
    """Each source into build/k3_fwd_bits/<name>.so, all nvcc's at once;
    the libraries and each build's registers, spills and shared memory
    (``-Xptxas -v``)."""
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
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
        logs[name] = [ln.split("ptxas info    : ")[-1] for ln in
                      log.splitlines() if "registers" in ln or "spill" in ln]
    return libs, logs


def sass(lib: Path) -> list[str]:
    """The instructions of every function in ``lib``, in order, without
    addresses, encodings or symbol names."""
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return [m.group(1) for line in text.splitlines()
            if (m := _INSN.match(line))]


def _entry(path: Path, symbol: str, argtypes) -> tuple:
    lib = ctypes.CDLL(str(path.resolve()))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", required=True,
                    help="a self-contained flash_attention_sm90.cu, or with "
                         "--kernel d256 a flash_attention_sm90_d256.cu")
    ap.add_argument("--kernel", choices=("sm90", "d256"), default="sm90")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    if not torch.cuda.is_available():
        sys.exit("k3_fwd_bits needs a CUDA device")
    dev = torch.device("cuda")
    d256 = args.kernel == "d256"
    src = _build.CSRC / ("flash_attention_sm90_d256.cu" if d256
                         else "flash_attention_sm90.cu")
    libs, logs = build({"ref": Path(args.ref), "checkout": src})
    out = {"kernel": args.kernel, "build": logs, "shapes": []}
    if d256:
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        shapes = [s for s in chip_smoke.ATTN_SHAPES if s[5] == 256]
        timed = chip_smoke.D256_SHAPE
        kbn = {n: _KBN.search(p.read_text()).group(1)
               for n, p in (("ref", Path(args.ref)), ("checkout", src))}
        out["key_block"] = kbn
        hold_bits = kbn["ref"] == kbn["checkout"]
        lib_new, fn_new = _entry(libs["checkout"],
                                 "flash_attention_sm90_d256_launch",
                                 _ARGS_D256)
        lib_ref, fn_ref = _entry(libs["ref"],
                                 "flash_attention_sm90_d256_launch",
                                 _ARGS_D256_REF)
        launchers = {
            "checkout": (lib_new, fn_new),
            # the wrapper's call without its last cluster and grid arguments
            "ref": (lib_ref, lambda *a: fn_ref(*a[:-3], a[-1]))}
        slots_fn = lib_new.flash_attention_sm90_d256_slots
        slots_fn.argtypes = [ctypes.c_int]
        slots_fn.restype = ctypes.c_int
        slots = {c: slots_fn(c) for c in (1, 2)}
        out["slots"] = slots
        launcher = "_launcher_sm90_d256"
        patched = {"_d256_slots": lambda index: slots}
        wrapper = "flash_attention_sm90_d256"
    else:
        shapes, timed, hold_bits = SHAPES, TIMED, True
        code = {n: sass(p) for n, p in libs.items()}
        out["sass_instructions"] = {n: len(c) for n, c in code.items()}
        out["same_sass"] = code["ref"] == code["checkout"]
        launchers = {n: _entry(p, "flash_attention_sm90_launch", _ARGS_SM90)
                     for n, p in libs.items()}
        launcher, patched = "_launcher_sm90", {}
        wrapper = "flash_attention_sm90"
    saved = {name: getattr(fa, name) for name in [launcher, *patched]}

    def run(name, q, k, v, causal, window, lse):
        setattr(fa, launcher, lambda: launchers[name])
        return getattr(fa, wrapper)(q, k, v, causal=causal, window=window,
                                    lse=lse)

    try:
        for attr, value in patched.items():
            setattr(fa, attr, value)
        for shape in shapes:
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
            if d256:
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                window=window)
                new = got["checkout"][0]
                reading["max_abs_err"] = float(
                    (new.float() - want.float()).abs().max())
                reading["row_rel_err"] = chip_smoke.row_rel_err(new, want)
                reading["plan"] = fa.d256_plan(b, hq, hkv, sq, slots)
                del want, new
            if shape == timed:
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
        for attr, value in saved.items():
            setattr(fa, attr, value)
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    if (not out.get("same_sass", True)
            or (hold_bits and not all(r["same_bits"] for r in out["shapes"]))):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
