"""Solution quality of the JAX package's kernel route as n grows (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.kernel_route_quality \
        --n 100000 1000000 2000000

Runs the algorithm of ``repro.kernels.coord_sweep.ops.abo_minimize_kernel``
(default config: block 4096, m = 50, 5 passes, golden-section start) with
the kernel's jnp oracle ``sweep_pass_ref`` in place of the Pallas kernel,
which the kernel matches (tests/test_kernels.py) and which runs at these
sizes on a CPU where interpret mode does not. Per pass it prints the
objective of the carried float32 aggregates (the route's history; it does
no per-pass resync) and the exact objective of x; at the end one JSON line
per n. The kernel route of the PyTorch port is held against these values.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

from repro.core.abo import ABOConfig
from repro.kernels.coord_sweep.ops import pack_aggs
from repro.kernels.coord_sweep.ref import sweep_pass_ref
from repro.objectives.griewank import GRIEWANK

_sweep = jax.jit(sweep_pass_ref, static_argnames=(
    "m", "n_valid", "lower", "upper", "half_width", "lam", "is_first"))


def kernel_route(n: int, cfg: ABOConfig) -> dict:
    bsz, m = cfg.block_size, cfg.samples_per_pass
    n_pad = -(-n // bsz) * bsz
    x = jnp.full((n_pad,), GRIEWANK.lower
                 + 0.6180339887 * (GRIEWANK.upper - GRIEWANK.lower),
                 jnp.float32)
    x2d = x.reshape(-1, bsz)
    aggs = pack_aggs(GRIEWANK.aggregates(x, n, agg_dtype=jnp.float32))
    shrink, w0 = cfg.resolved_shrink(), 0.5 * (GRIEWANK.upper
                                               - GRIEWANK.lower)
    carried, exact = [], []
    t0 = time.perf_counter()
    for p in range(cfg.n_passes):
        lam = p / (cfg.n_passes - 1) if cfg.n_passes > 1 else 1.0
        x2d, aggs = _sweep(x2d, aggs, m=m, n_valid=n, lower=GRIEWANK.lower,
                           upper=GRIEWANK.upper,
                           half_width=float(w0 * shrink ** p),
                           lam=float(lam), is_first=(p == 0))
        carried.append(float(GRIEWANK.combine(aggs[0, :3])))
        exact.append(float(GRIEWANK.value(x2d.reshape(-1)[:n])))
        print(f"n={n} pass {p}: carried {carried[-1]!r} exact {exact[-1]!r}",
              flush=True)
    return {"n": n, "fun": exact[-1], "history": carried,
            "exact_per_pass": exact, "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[10**5, 10**6,
                                                         2 * 10**6])
    args = ap.parse_args()
    rows = [kernel_route(n, ABOConfig()) for n in args.n]
    for row in rows:
        print(json.dumps({"platform": jax.devices()[0].platform, **row}))


if __name__ == "__main__":
    main()
