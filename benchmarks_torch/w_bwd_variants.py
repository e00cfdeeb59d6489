"""W-bwd (``csrc/rwkv6_wkv_bwd.cu``) against the step form it replaced and
against variants of itself, timed in turns.

    git show d4c7ca7:src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu \\
        > build/w_bwd_variants/step.cu                       # here, once
    PYTHONPATH=src python -m benchmarks_torch.w_bwd_variants  # on the H100
    PYTHONPATH=src python -m benchmarks_torch.w_bwd_variants --only base,step

``step`` is the step form (two sweeps over T on the CUDA cores, a float32
checkpoint of every 16-step chunk, dv summed over four row slices by a
second kernel), built from the source the parent commit holds: read by
``git show`` where the tree is a git checkout, else from ``--step-src``.
The others are text copies of the chunked kernel's source (``sm90.cuh``
beside it) with a few lines replaced:

- ``no_loops``: warps 5-6 stage nothing (the decay loops' share);
- ``no_finals``: warp 7 writes nothing (dr, dk, dlogw);
- ``no_ckpt``: every chunk's state goes to and comes from one place,
  which stays in L2 (the checkpoint's traffic to device memory, the cost
  that a checkpoint every n-th chunk would cut);
- ``no_loop_loads``: the decay loops make each step's rows of w and k or
  r from the last step's with 16 operations instead of reading them from
  shared memory (what the loops' reads cost, against their arithmetic);
- ``clocked``: the source as it is with ``-DRWKV6_BWD_CLOCK``, whose
  cycle counts each role's lane 0 writes; they are printed a chunk, each
  role's mean over the CTAs (the clock reads may move across a barrier,
  so a role's barrier share is not to be trusted, its parts are).

Each is built under ``build/w_bwd_variants/<name>/`` by nvcc with the
kernels' own flags and called at rwkv6-3b's layer shape, (1, 4096, 40, 64)
bf16 (``--heads 20`` leaves one CTA on an SM), with the smoke's inputs
(``wkv_inputs``, seed 0) and no dS, as the training step calls it.
``base`` and ``step`` are held to the plain version (``wkv_bwd_ref``) at
chip_smoke.py's RTRAIN_TOL; the variants compute something else and are
only timed: what a part costs is the base's time less the variant's. A
variant that faults ends the CUDA context, so run each in its own process.

``--check`` first holds ``base`` at every ``W_BWD_SHAPES`` case of
chip_smoke.py (with dS), overall and per head, and its bits on a repeat.

All variants run in alternating rounds (CUDA events over 10 launches each),
so that they share the card's state. Prints one JSON line: per variant its
times, mean, error where it is held, and ptxas's register line.
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
OUT = ROOT / "build" / "w_bwd_variants"
SHAPE = (1, 4096, 40, 64)
STEP_REV = "d4c7ca7"
STEP_PATH = "src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu"

_LOOPS = ("      if (m + 1 < chunks && m + 1 >= 0) {\n"
          "        const bool one = warp == kLoop1Warp;")
_FINALS = "    } else if (m >= 1) {\n      // ---"
_CK_STORE = "      float* ck = ck_at(c);\n"
_CK_LOAD = "    const float* ck = ck_at(chunks - 1 - m);\n"
# name: (held to the plain version, [(text, replacement), ...]); None is
# the step form
VARIANTS = {
    "base": (True, []),
    "step": (True, None),
    "no_loops": (False, [(_LOOPS, _LOOPS.replace("m + 1 < chunks &&",
                                                 "m + 1 < 0 &&"))]),
    "no_ckpt": (False, [(_CK_STORE, _CK_STORE.replace("(c)", "(0)")),
                        (_CK_LOAD, _CK_LOAD.replace("(chunks - 1 - m)",
                                                    "(0)"))]),
    "no_finals": (False, [(_FINALS, _FINALS.replace("m >= 1", "m < 0"))]),
    "no_loop_loads": (False, [
        ("              load8(&sc.w[s][8 * h], wn);\n"
         "              load8(&sc.x[s - 1][8 * h], kn);\n",
         "              for (int e = 0; e < 8; ++e) {\n"
         "                wn[e] = wr[e] * 0.5f;\n"
         "                kn[e] = kr[e] + 1.0f;\n"
         "              }\n"),
        ("              load8(&sc.w[tt][8 * h], wn);\n"
         "              load8(&sc.x[tt + 1][8 * h], rn);\n",
         "              for (int e = 0; e < 8; ++e) {\n"
         "                wn[e] = wr[e] * 0.5f;\n"
         "                rn[e] = rr[e] + 1.0f;\n"
         "              }\n")]),
    "clocked": (False, []),
}


def step_source(path: str | None) -> str:
    """The step form's source: ``path``, else ``git show`` of the parent."""
    if path is not None:
        return Path(path).read_text()
    default = OUT / "step.cu"
    if default.exists():
        return default.read_text()
    return subprocess.run(["git", "show", f"{STEP_REV}:{STEP_PATH}"],
                          cwd=ROOT, check=True, capture_output=True,
                          text=True).stdout


def build(name: str, text: str):
    """Write ``text`` as the variant's source and start nvcc on it: (the
    library, the compiler's process)."""
    from repro_torch.kernels import _build
    out = OUT / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    (out / "rwkv6_wkv_bwd.cu").write_text(text)
    shutil.copy(_build.CSRC / "sm90.cuh", out / "sm90.cuh")
    lib = out / "rwkv6_wkv_bwd.so"
    extra = ["-DRWKV6_BWD_CLOCK"] if name == "clocked" else []
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(out), "-o",
         str(lib), str(out / "rwkv6_wkv_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def source_of(name: str, step_src: str | None) -> str:
    if VARIANTS[name][1] is None:
        return step_source(step_src)
    from repro_torch.kernels import _build
    text = (_build.CSRC / "rwkv6_wkv_bwd.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in rwkv6_wkv_bwd.cu")
        text = text.replace(old, new)
    return text


def caller(name: str, lib: Path):
    """A function (r, k, v, logw, u, dy, dS) -> the five gradients through
    the variant's library: the port's wrapper for the chunked kernel, the
    step form's own scratch for the step form."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops
    dll = ctypes.CDLL(str(lib))
    fn = dll.rwkv6_wkv_bwd_launch
    fn.restype = ctypes.c_int
    if VARIANTS[name][1] is not None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]

        def call(*args):
            saved = ops._launcher_bwd
            ops._launcher_bwd = lambda: (dll, fn)
            try:
                return ops.rwkv6_wkv_bwd(*args)
            finally:
                ops._launcher_bwd = saved
        return call
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]

    def call_step(r, k, v, logw, u, dy, dS=None):
        b, t, h, hd = r.shape
        dev = r.device
        dr, dk, dv = (torch.empty_like(r) for _ in range(3))
        dlogw = torch.empty(r.shape, dtype=torch.float32, device=dev)
        du = torch.empty((h, hd), dtype=torch.float32, device=dev)
        ckpt = torch.empty((b, h, -(-t // 16), hd, hd), dtype=torch.float32,
                           device=dev)
        dv_part = torch.empty((hd // 16, b, t, h, hd), dtype=torch.float32,
                              device=dev)
        du_part = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), dy.data_ptr(),
                  None if dS is None else dS.data_ptr(), ckpt.data_ptr(),
                  dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  dlogw.data_ptr(), dv_part.data_ptr(), du_part.data_ptr(),
                  du.data_ptr(), b, t, h, hd, int(r.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"step form: launch failed: {code}")
        return dr, dk, dv, dlogw, du
    return call_step


def rel_errs(got, want, dtype) -> dict:
    import torch
    names = ("dr", "dk", "dv", "dlogw", "du")
    out = {}
    for n, a, w in zip(names, got, want):
        out[n] = float((a.float() - w.float()).abs().max()
                       / w.float().abs().max().clamp_min(1e-30))
    return out


def check_base(call, dev) -> list:
    """``base`` at every W_BWD_SHAPES case against the plain version."""
    import torch
    from chip_smoke import RTRAIN_TOL, W_BWD_SHAPES, wkv_inputs
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref
    rows = []
    for b, t, h, hd, name, shift in W_BWD_SHAPES:
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(t + hd)
        r, k, v, logw, u = wkv_inputs(dev, g, (b, t, h, hd), dtype, shift)
        dy = torch.randn((b, t, h, hd), generator=g, device=dev)
        dS = torch.randn((b, h, hd, hd), generator=g, device=dev)
        got = call(r, k, v, logw, u, dy, dS)
        again = call(r, k, v, logw, u, dy, dS)
        want = wkv_bwd_ref(r, k, v, logw, u, dy, dS)
        torch.cuda.synchronize()
        rel = rel_errs(got, want, dtype)
        head = {n: float(((a.float() - w.float()).abs().amax((0, 1, 3))
                          / w.float().abs().amax((0, 1, 3)).clamp_min(1e-30))
                         .max())
                for n, a, w in zip(("dr", "dk", "dv"), got, want)}
        lim = {n: RTRAIN_TOL[name if n in ("dr", "dk", "dv") else "float32"]
               for n in rel}
        held = (all(rel[n] <= lim[n] for n in rel)
                and all(head[n] <= lim[n] for n in head)
                and all(torch.equal(a, c) for a, c in zip(got, again))
                and all(bool(torch.isfinite(a).all()) for a in got))
        rows.append({"shape": (b, t, h, hd), "dtype": name, "shift": shift,
                     "rel": rel, "worst_head": head, "held": held})
    return rows


ROLES = {0: "products 0", 1: "products 1", 2: "products 2",
         3: "products 3", 4: "TMA, decays, dv", 5: "loop 1", 6: "loop 2",
         7: "finals"}
SLOTS = ("fwd_work", "fwd_barrier", "bwd_work", "bwd_barrier",
         "fwd_mbar_wait", "bwd_mbar_wait", "loop_rows", "loop_body")


def clocked(call, r, k, v, logw, u, dy) -> dict:
    """The clocked build's cycle counts, each role's mean over the CTAs, a
    chunk (its sweep's chunks + 1 or + 2 steps)."""
    import torch
    b, t, h, hd = r.shape
    buf = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    call(r, k, v, logw, u, dy, buf)
    torch.cuda.synchronize()
    ctas = b * h * (hd // 16)
    c = buf.view(torch.int32).flatten()[:ctas * 8 * 8].view(ctas, 8, 8)
    c = c.double().mean(0) / (-(-t // 16))
    return {ROLES[w]: dict(zip(SLOTS, [round(float(x), 1) for x in c[w]]))
            for w in range(8)}


def main(argv=None) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RTRAIN_TOL, wkv_inputs
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names (base always runs)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--step-src", default=None,
                    help="the step form's source, where this tree is not a "
                         "git checkout and build/w_bwd_variants/step.cu is "
                         "missing")
    ap.add_argument("--heads", type=int, default=SHAPE[2],
                    help="heads of the shape (40 is rwkv6-3b's; 20 puts at "
                         "most one CTA on an SM)")
    ap.add_argument("--check", action="store_true",
                    help="hold base at every W_BWD_SHAPES case first")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.only is None else (
        ["base"] + [n for n in args.only.split(",") if n != "base"])
    if not torch.cuda.is_available():
        raise SystemExit("w_bwd_variants needs a card")
    t0 = time.perf_counter()
    jobs = {n: build(n, source_of(n, args.step_src)) for n in names}
    calls, logs = {}, {}
    for n, (lib, proc) in jobs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{logs[n]}")
        calls[n] = caller(n, lib)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    base = ctypes.CDLL(str(jobs["base"][0]))
    result = {"shape": (SHAPE[0], SHAPE[1], args.heads, SHAPE[3]),
              "build_s": build_s,
              "clusters_resident": base.rwkv6_wkv_bwd_clusters(SHAPE[3], 1),
              "smem_bytes": base.rwkv6_wkv_bwd_smem_bytes(SHAPE[3], 1)}
    if args.check:
        result["check"] = check_base(calls["base"], dev)
        print(json.dumps({"check": result["check"]}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (SHAPE[0], SHAPE[1], args.heads, SHAPE[3])
    r, k, v, logw, u = wkv_inputs(dev, g, shape, torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=dev)
    want = wkv_bwd_ref(r, k, v, logw, u, dy)
    out = {}
    for n in names:
        got = calls[n](r, k, v, logw, u, dy)
        torch.cuda.synchronize()
        err = None
        if VARIANTS[n][0]:
            err = rel_errs(got, want, torch.bfloat16)
        out[n] = {"ms": [], "rel_err": err,
                  "regs": [ln.strip() for ln in logs[n].splitlines()
                           if "registers" in ln or "spill" in ln]}
    del want
    if "clocked" in names:
        result["clocked"] = clocked(calls["clocked"], r, k, v, logw, u, dy)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for n in names:
            calls[n](r, k, v, logw, u, dy)
            start.record()
            for _ in range(10):
                calls[n](r, k, v, logw, u, dy)
            end.record()
            torch.cuda.synchronize()
            out[n]["ms"].append(start.elapsed_time(end) / 10)
    for n in names:
        out[n]["mean_ms"] = sum(out[n]["ms"]) / len(out[n]["ms"])
        if VARIANTS[n][0]:
            lim = {x: RTRAIN_TOL["bfloat16" if x in ("dr", "dk", "dv")
                                 else "float32"] for x in out[n]["rel_err"]}
            out[n]["held"] = all(out[n]["rel_err"][x] <= lim[x] for x in lim)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result.update({"device": smi, "variants": out})
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
