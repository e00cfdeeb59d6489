"""W (``csrc/rwkv6_wkv.cu``) against variants of itself, timed in turns.

    PYTHONPATH=src python -m benchmarks_torch.w_variants     # on the H100
    PYTHONPATH=src python -m benchmarks_torch.w_variants --only base,kper1

Each variant is a text copy of W's source (``sm90.cuh`` beside it) under
``build/w_variants/<name>/`` with a few lines replaced, built by nvcc with
the kernels' own flags and called through its C entry at rwkv6-3b's layer
shape, (1, 8192, 40, 64) bf16, with the smoke's inputs (``wkv_inputs``,
seed 0). The base is held to W's plain version (relative 1e-5, as
chip_smoke.py's WKV_TOL); the others take a part out (``no_products``:
the product warps only wait and signal; ``no_decays``: the decay warps
stage no decays, v's fragments stay; ``no_a``: the A warps stage nothing;
``no_staging``: neither), compute something else and are only timed: what
a part costs on the critical path is the base's time less the variant's.

All variants and the base run in alternating rounds (CUDA events over 20
launches each), so that they share the card's state. Prints one JSON line:
per variant its times, mean, and error where it is held.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 8192, 40, 64)
TOL = 1e-5

# where the decay warps' and the A warps' code begins, and the decays end
_DECAYS = ("        const int hs = warp - 4, c = lane >> 4, i = lane & 15;\n"
           "        Group& gr = sm.grp[slot][q][c];\n")
_DECAYS_END = "        if (hs == 0) gr.d[i] = ex2(lb[kC]);\n"
_A = "      } else {\n        // A's share"
# name: (held to the plain version, [(text, replacement), ...])
VARIANTS = {
    "base": (True, []),
    "no_products": (False, [("      if (warp < NQ) {\n        // this warp's",
                             "      if (warp < 0) {\n        // this warp's")]),
    "no_decays": (False, [(_DECAYS, _DECAYS + "        if (n < 0) {\n"),
                          (_DECAYS_END, _DECAYS_END + "        }\n")]),
    "no_a": (False, [(_A, _A.replace("} else {", "} else if (false) {"))]),
    "no_staging": (False, [(_DECAYS, _DECAYS + "        if (n < 0) {\n"),
                           (_DECAYS_END, _DECAYS_END + "        }\n"),
                           (_A, _A.replace("} else {",
                                           "} else if (false) {"))]),
}


def build(name: str, subs):
    """Copy W's source with ``subs`` applied and start nvcc on it: (the
    library, the compiler's process)."""
    from repro_torch.kernels import _build
    src = _build.CSRC / "rwkv6_wkv.cu"
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {src.name}")
        text = text.replace(old, new)
    out = ROOT / "build" / "w_variants" / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    (out / "rwkv6_wkv.cu").write_text(text)
    shutil.copy(_build.CSRC / "sm90.cuh", out / "sm90.cuh")
    lib = out / "rwkv6_wkv.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
         str(out / "rwkv6_wkv.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launcher(lib: Path):
    dll = ctypes.CDLL(str(lib))
    fn = dll.rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import wkv_inputs
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names (base always runs)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--heads", type=int, default=SHAPE[2],
                    help="heads of the shape (40 is rwkv6-3b's; 20 puts at "
                         "most one CTA on an SM)")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.only is None else (
        ["base"] + [n for n in args.only.split(",") if n != "base"])
    if not torch.cuda.is_available():
        raise SystemExit("w_variants needs a card")
    t0 = time.perf_counter()
    jobs = {n: build(n, VARIANTS[n][1]) for n in names}
    fns, logs = {}, {}
    for n, (lib, proc) in jobs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{logs[n]}")
        fns[n] = launcher(lib)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (SHAPE[0], SHAPE[1], args.heads, SHAPE[3])
    r, k, v, logw, u = wkv_inputs(dev, g, shape, torch.bfloat16)
    b, t, h, hd = shape
    y = torch.empty(shape, dtype=torch.float32, device=dev)
    st = torch.empty(b, h, hd, hd, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), y.data_ptr(), st.data_ptr(), b, t, h, hd, 1,
                  stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    want_y, want_s = wkv_ref(r, k, v, logw, u)
    out = {}
    for n in names:
        call(fns[n])
        torch.cuda.synchronize()
        err = None
        if VARIANTS[n][0]:
            err = max(float((y - want_y).abs().max() / want_y.abs().max()),
                      float((st - want_s).abs().max() / want_s.abs().max()))
        out[n] = {"ms": [], "rel_err": err,
                  "regs": [ln.strip() for ln in logs[n].splitlines()
                           if "registers" in ln]}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for n in names:
            call(fns[n])
            start.record()
            for _ in range(20):
                call(fns[n])
            end.record()
            torch.cuda.synchronize()
            out[n]["ms"].append(start.elapsed_time(end) / 20)
    for n in names:
        out[n]["mean_ms"] = sum(out[n]["ms"]) / len(out[n]["ms"])
        if VARIANTS[n][0] and out[n]["rel_err"] > TOL:
            out[n]["held"] = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"shape": shape, "device": smi, "build_s": build_s,
              "variants": out}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
