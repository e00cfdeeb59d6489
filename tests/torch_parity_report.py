"""Measure how far the PyTorch port is from the JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Prints, on the inputs of the parity tests (tests/test_torch_*.py), the
largest discrepancies those tests hold to a tolerance: objective terms and
aggregates, one sweep pass of the kernel route's plain version against the
JAX oracle, float32 seeded starts, and whole solves of both routes at
``--n-solve`` (default 1e6) for Griewank and the sphere. The tolerances in
the tests and in PERF.md come from these numbers.
"""
from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np
import torch

import repro.core.abo as JA
import repro.objectives as J
import repro_torch.core.abo as TA
import repro_torch.objectives as T
from repro.kernels.coord_sweep.ops import pack_aggs
from repro.kernels.coord_sweep.ref import sweep_pass_ref as j_sweep_ref
from repro_torch.kernels.coord_sweep.ref import sweep_pass_ref

SIZES = [100, 4096, 10_000, 3 * 4096 + 5]
SHAPES = [(1, 128, 16), (4, 256, 64), (3, 512, 128), (2, 128, 33)]
CASES = [(0.0, True), (0.5, False), (1.0, False)]


def objectives_report() -> dict:
    out = {}
    for name, oj in J.OBJECTIVES.items():
        ot = T.OBJECTIVES[name]
        term_err, agg_rel = np.zeros(oj.n_aggs), np.zeros(oj.n_aggs)
        for n in SIZES:
            x = np.random.RandomState(1).uniform(oj.lower, oj.upper,
                                                 n).astype(np.float32)
            tj = np.asarray(oj.terms(jnp.arange(n), jnp.asarray(x)), np.float64)
            tt = ot.terms(torch.arange(n), torch.from_numpy(x)).double().numpy()
            term_err = np.maximum(term_err, (np.abs(tt - tj)
                                             / (1 + np.abs(tj))).max(axis=0))
            pad = np.ones(-n % 4096, np.float32)    # see test_torch_objectives
            aj = np.asarray(oj.aggregates(jnp.asarray(np.concatenate([x, pad])),
                                          n), np.float64)
            at = ot.aggregates(torch.from_numpy(x), n).double().numpy()
            agg_rel = np.maximum(agg_rel, np.abs(at - aj) / np.abs(aj))
        out[name] = {"term_err_over_1_plus_abs": term_err.tolist(),
                     "aggregate_rel_err": agg_rel.tolist()}
    return out


def sweep_report() -> dict:
    x_same, agg_err = 1.0, np.zeros(3)
    for n_blocks, block, m in SHAPES:
        for lam, is_first in CASES:
            rng = np.random.RandomState(block + m)
            x2d = rng.uniform(-600, 600, (n_blocks, block)).astype(np.float32)
            n = n_blocks * block - 17
            aggs = np.asarray(pack_aggs(J.GRIEWANK.aggregates(
                jnp.asarray(x2d.reshape(-1)), n, agg_dtype=jnp.float32)))
            kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam,
                      is_first=is_first)
            xj, aj = j_sweep_ref(jnp.asarray(x2d), jnp.asarray(aggs),
                                 lower=-600.0, upper=600.0, **kw)
            xt, at = sweep_pass_ref(torch.from_numpy(x2d.copy()),
                                    torch.from_numpy(aggs.copy()),
                                    lower=-600.0, upper=600.0, **kw)
            x_same = min(x_same, float((xt.numpy() == np.asarray(xj)).mean()))
            err = np.abs(at.numpy()[0, :3].astype(np.float64)
                         - np.asarray(aj)[0, :3])
            agg_err = np.maximum(agg_err,
                                 err / (1 + np.abs(aggs[0, :3].astype(float))))
    return {"x_identical_min": x_same,
            "aggs_err_over_1_plus_abs_in": agg_err.tolist()}


def seeded_report() -> dict:
    mismatches = 0
    for seed in (0, 7, 123456789, 2**31 + 5):
        a = np.asarray(JA.seeded_start(seed, 200_000, jnp.float32, -600.0,
                                       600.0)).view(np.uint32)
        b = TA.seeded_start(seed, 200_000, torch.float32, -600.0, 600.0,
                            device="cpu").numpy().view(np.uint32)
        mismatches += int((a != b).sum())
    return {"float32_bit_mismatches": mismatches}


def solves_report(n: int) -> dict:
    out = {}
    for name in ("griewank", "sphere"):
        rj = JA.abo_minimize(J.OBJECTIVES[name], n)
        rt = TA.abo_minimize(T.OBJECTIVES[name], n, device="cpu")
        out[name] = {"n": n, "jax_fun": rj.fun, "torch_fun": rt.fun,
                     "x_identical": float((rt.x.numpy()
                                           == np.asarray(rj.x)).mean())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-solve", type=int, default=10**6)
    args = ap.parse_args()
    for key, fn in (("objectives", objectives_report), ("sweep", sweep_report),
                    ("seeded_start", seeded_report),
                    ("solves", lambda: solves_report(args.n_solve))):
        print(json.dumps({key: fn()}), flush=True)


if __name__ == "__main__":
    main()
