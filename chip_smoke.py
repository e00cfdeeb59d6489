#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:
  1. device: the card's name and power limit;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. K2 (Griewank aggregates) against its plain version, timed;
  4. K1 (one whole ABO pass) against its plain version, timed;
  5. the main path, kernel route: ``abo_minimize(GRIEWANK, 1e8,
     use_kernel=True)``, with launch counts and peak device memory;
  6. the plain tensor route: ``abo_minimize`` of Griewank and the sphere at
     n = 1e6;
  7. one JSON line with every kernel's launches, error and times;
  8. the last line, ``{"ok": true, "device": {...}}``.

Imports torch and the port only. Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 without the
# tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Elementary float32 operations per coordinate (K2) and per candidate probe
# (K1), each transcendental counted as one (so the bound is a lower bound).
# K2: index->float, rsqrt, u, cos, sin, square, compare, min, negate, log1p,
#     half, abs, max, log, select, x*x, /4000, cos<0, mask compare, 3 mask
#     multiplies, 3 adds = 24.
# K1: offset (convert, multiply, subtract), window (multiply, add), clamp 2,
#     incumbent and padding selects 2, the 16 plane operations of K2 after
#     rsqrt (u .. cos<0), 3 deltas, 3 aggregate adds, combine (parity 3,
#     compare, expm1 or exp, multiply, add or subtract, select), argmin
#     compare = 40.
K2_OPS_PER_COORD = 24
K1_OPS_PER_PROBE = 40
# The plain route is held to the 1e-6 of tests/test_abo.py, except where the
# JAX package itself misses it: the sphere at n = 1e6 ends at
# 9.72658017417416e-06 there (XLA:CPU, default config), and the port is
# held to that value, with 0.1% for the card's order of summation.
PLAIN_TOL = {"sphere": 9.72658017417416e-06 * 1.001}
# The kernel route solves Griewank at the paper's Table scale cut by 10;
# the plain route solves at examples/quickstart.py's n.
MAIN_N = 10**8
PLAIN_N = 10**6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, src)
    import repro_torch
    check(os.path.dirname(os.path.abspath(repro_torch.__file__))
          == os.path.join(src, "repro_torch"),
          f"imported repro_torch from {repro_torch.__file__}, not {src}")
    from repro_torch.core import ABOConfig, abo_minimize
    from repro_torch.kernels import _build
    from repro_torch.kernels.coord_sweep.ops import sweep_pass
    from repro_torch.kernels.coord_sweep.ref import (abo_minimize_kernel_ref,
                                                     sweep_pass_ref)
    from repro_torch.kernels.griewank.ops import griewank_aggregates
    from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
    from repro_torch.objectives import GRIEWANK, SPHERE

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def uniform(n):
        return torch.rand(n, generator=gen, device=dev) * 1200.0 - 600.0

    # ---- 1. device -----------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)

    # ---- 2. build ------------------------------------------------------
    info = _build.build_all()
    print(f"[build] {len(info['built'])} kernels built in "
          f"{info['seconds']:.1f} s into {_build.build_dir()}", flush=True)
    for name, log in info["log"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = []

    # ---- 3. K2 against its plain version ---------------------------------
    k2_err = 0.0
    for n in (3 * 4096 + 5, MAIN_N + 17):
        x = uniform(n)
        got = griewank_aggregates(x)[0, :3].double()
        want = griewank_aggregates_ref(x, n_valid=n)[0, :3].double()
        err = (got - want).abs()
        rel = err / want.abs().clamp(min=1e-30)
        print(f"[K2] n={n} kernel {got.tolist()} plain {want.tolist()} "
              f"rel {rel.tolist()}", flush=True)
        check(bool(rel[0] <= 1e-5) and bool(rel[1] <= 1e-5)
              and bool(err[2] <= max(1.0, 1e-5 * float(want[2].abs()))),
              f"K2 disagrees with its plain version at n={n}")
        k2_err = max(k2_err, float(err.max()))
    griewank_aggregates(x)                                   # warm-up
    k2_ms = cuda_ms(lambda: griewank_aggregates(x), 20)
    k2_plain_ms = cuda_ms(lambda: griewank_aggregates_ref(
        x, n_valid=x.numel()), 2)
    k2_bound, k2_by = bound_ms(4 * x.numel() + 4 * 128,
                               K2_OPS_PER_COORD * x.numel())
    print(f"[K2] n={x.numel()}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.2f} ms, bound {k2_bound:.4f} ms ({k2_by})",
          flush=True)
    del x

    # ---- 4. K1 against its plain version ---------------------------------
    def k1_case(n_blocks, block, m, lam, is_first):
        """One pass of the kernel and of its plain version from the same
        start, compared; returns (max aggregate error, x identical share,
        kernel ms, plain ms)."""
        n = n_blocks * block - 17                 # padding coordinates
        x2d = uniform(n_blocks * block).view(n_blocks, block)
        aggs = griewank_aggregates_ref(x2d, n_valid=n)
        kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam,
                  is_first=is_first)
        xk, xr, out = x2d.clone(), x2d.clone(), {}
        ms = cuda_ms(lambda: out.update(k=sweep_pass(xk, aggs, **kw)), 1)
        plain_ms = cuda_ms(lambda: out.update(r=sweep_pass_ref(
            xr, aggs, lower=-600.0, upper=600.0, **kw)), 1)
        ak, ar = out["k"][1], out["r"][1]
        same = float((xk == xr).double().mean())
        a_in, dk = aggs[0, :3].double(), (ak - ar)[0, :3].double().abs()
        frozen = bool((xk.view(-1)[n:] == x2d.view(-1)[n:]).all())
        print(f"[K1] {n_blocks}x{block} m={m} lam={lam} first={is_first}: "
              f"x identical {same:.6f}, aggs diff {dk.tolist()}, padding "
              f"frozen {frozen}, kernel {ms:.2f} ms, plain {plain_ms:.1f} ms",
              flush=True)
        check(same >= 0.999 and frozen
              and bool((dk <= 1e-3 * (1 + a_in.abs())).all()),
              "K1 disagrees with its plain version")
        return float(dk.max()), same, ms, plain_ms

    k1_err, k1_same = 0.0, 1.0
    for lam, is_first in ((0.0, True), (0.5, False), (1.0, False)):
        err, same, _, _ = k1_case(64, 4096, 50, lam, is_first)
        k1_err, k1_same = max(k1_err, err), min(k1_same, same)
    main_blocks = -(-MAIN_N // 4096)
    err, same, k1_ms, k1_plain_ms = k1_case(main_blocks, 4096, 50, 0.5, False)
    k1_err, k1_same = max(k1_err, err), min(k1_same, same)
    k1_bound, k1_by = bound_ms(8 * main_blocks * 4096 + 2 * 4 * 128,
                               K1_OPS_PER_PROBE * 50 * main_blocks * 4096)
    print(f"[K1] one pass at {main_blocks}x4096 m=50: kernel {k1_ms:.1f} ms, "
          f"plain {k1_plain_ms:.1f} ms, bound {k1_bound:.3f} ms ({k1_by})",
          flush=True)

    # ---- 5. main path, kernel route --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep_pass.launches = griewank_aggregates.launches = 0
    t0 = time.perf_counter()
    r = abo_minimize(GRIEWANK, MAIN_N, config=ABOConfig(use_kernel=True),
                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep_pass": sweep_pass.launches,
                "griewank_aggregates": griewank_aggregates.launches}
    peak = torch.cuda.max_memory_allocated()
    sol_bytes = 4 * MAIN_N
    print(f"[main/kernel] n={MAIN_N}: fun {r.fun!r}, wall {wall:.2f} s, "
          f"{r.fe / wall:.4g} probes/s, {wall / 5:.2f} s per pass (wall/5), "
          f"launches {launches}, peak {peak} B = {peak / sol_bytes:.4f} x "
          f"solution bytes {sol_bytes}", flush=True)
    print(f"[main/kernel] history {r.history.tolist()}", flush=True)
    check(tuple(r.x.shape) == (MAIN_N,) and bool(torch.isfinite(r.x).all())
          and math.isfinite(r.fun), "kernel-route x or fun is not finite")
    check(launches == {"sweep_pass": 5, "griewank_aggregates": 2},
          f"kernel route launched {launches}, want 5 and 2")
    check(peak <= 1.25 * sol_bytes + 64 * 2**20,
          f"peak device memory {peak} > 1.25 x {sol_bytes} + 64 MiB")
    # Quality. The route carries float32 aggregates with no per-pass resync,
    # as the JAX package's kernel route does, and that algorithm itself
    # misses 1e-6 from n ~ 2e6 on (benchmarks/kernel_route_quality.py). So
    # at n it is held to the same route with the kernels' plain versions on
    # the card, from the same start: x identical on >= 99.9% of coordinates
    # and fun within a relative 1e-5 (measured at MAIN_N: all of x, the same
    # fun; at other n the trajectories can part at near-ties, e.g. 99.58% of
    # x at n = 2e6, benchmarks_torch/kernel_route_quality.py). At n = 1e6,
    # where the JAX package reaches 2.6e-8, it is held to the 1e-6 of
    # tests/test_abo.py.
    t0 = time.perf_counter()
    plain = abo_minimize_kernel_ref(MAIN_N, device=dev)
    same = float((plain.x == r.x).double().mean())
    print(f"[main/kernel] plain versions at n={MAIN_N}: fun {plain.fun!r}, "
          f"{time.perf_counter() - t0:.1f} s; x identical {same:.6f}",
          flush=True)
    check(same >= 0.999
          and abs(r.fun - plain.fun) <= 1e-5 * abs(plain.fun) + 1e-6,
          f"kernel-route fun {r.fun} (x identical {same}) disagrees with "
          f"its plain versions' {plain.fun}")
    del r, plain
    r = abo_minimize(GRIEWANK, 10**6, config=ABOConfig(use_kernel=True),
                     device=dev)
    print(f"[main/kernel] n=1000000: fun {r.fun!r}", flush=True)
    check(r.fun < 1e-6, f"kernel-route fun {r.fun} >= 1e-6 at n = 1e6")
    # the same route on a small input against the plain versions on the CPU
    small = ABOConfig(block_size=512, samples_per_pass=64, use_kernel=True)
    rk = abo_minimize(GRIEWANK, 4096, config=small, device=dev)
    rc = abo_minimize(GRIEWANK, 4096, config=small, device="cpu")
    same = float((rk.x.cpu() == rc.x).double().mean())
    print(f"[main/kernel] n=4096 card {rk.fun!r} cpu {rc.fun!r}, x identical "
          f"{same:.6f}", flush=True)
    check(abs(rk.fun - rc.fun) <= 1e-6 and same >= 0.999,
          "kernel route on the card disagrees with the plain route on the CPU")

    # ---- 6. plain tensor route ---------------------------------------------
    sweep_pass.launches = griewank_aggregates.launches = 0
    for obj in (GRIEWANK, SPHERE):
        t0 = time.perf_counter()
        r = abo_minimize(obj, PLAIN_N, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tol = PLAIN_TOL.get(obj.name, 1e-6)
        print(f"[main/plain] {obj.name} n={PLAIN_N}: fun {r.fun!r} "
              f"(limit {tol!r}), wall {wall:.2f} s, {r.fe / wall:.4g} "
              f"probes/s", flush=True)
        check(r.fun < tol, f"plain-route {obj.name} fun {r.fun} >= {tol}")
        check(bool(torch.isfinite(r.x).all()), "plain-route x not finite")
    print(f"[main/plain] kernel launches {sweep_pass.launches}, "
          f"{griewank_aggregates.launches} (the plain route has none)")

    foreign = sorted(m for m in sys.modules if m.split(".")[0]
                     in ("jax", "jaxlib", "repro", "benchmarks"))
    check(not foreign, f"the smoke imported {foreign[:5]}: JAX, the JAX "
          "package or its benchmarks")

    # ---- 7. kernels line ---------------------------------------------------
    kernels.append({
        "name": "sweep_pass", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sweep_pass.cu",
        "replaces": "src/repro/kernels/coord_sweep/kernel.py:123",
        "launches": launches["sweep_pass"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None,
        "max_abs_err_of": "aggregates", "x_identical": k1_same})
    kernels.append({
        "name": "griewank_aggregates", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/griewank_aggregates.cu",
        "replaces": "src/repro/kernels/griewank/kernel.py:48",
        "launches": launches["griewank_aggregates"], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
        "bound_by": k2_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))

    # ---- 8. result -----------------------------------------------------------
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
