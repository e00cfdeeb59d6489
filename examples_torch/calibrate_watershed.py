"""Model calibration with ABO — the paper's motivating domain (hydrology).

A toy conceptual watershed ("abc" linear-reservoir family): each of N
sub-catchments has one recession parameter k_i; observed discharge is a
known mixture of per-catchment unit responses. Calibrating k against
observations is a separable least-squares problem:

    J(k) = Σ_i w_i · (g(k_i) − y_i)²

which means ABO's O(1)-probe machinery applies verbatim. Port of
``examples/calibrate_watershed.py`` on ``repro_torch``: the objective is
the port's ``SeparableObjective``, built from the index with no O(N)
tables, and the solve runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples_torch/calibrate_watershed.py [--n 100000] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.device import device_label, resolve_device
from repro_torch.objectives.base import SeparableObjective


def k_true(idx, dt):
    """True parameters k*_i ∈ (0.2, 0.8), generated from the index (no O(N)
    tables — the zero-RAM discipline)."""
    return 0.5 + 0.3 * torch.sin(0.37 * (idx + 1).to(dt))


def make_watershed_objective(n: int) -> tuple[SeparableObjective, None]:
    def g(k):
        # steady-state storage response of a linear reservoir, nonlinear in k
        return k / (1.0 + k * k)

    def terms(idx, x):
        dt = x.dtype
        resid = g(x) - g(k_true(idx, dt))
        w = 1.0 + 0.5 * torch.cos(0.11 * (idx + 1).to(dt))   # gauge weights
        return (w * resid * resid)[..., None]

    obj = SeparableObjective(
        name="watershed_abc", n_aggs=1, terms=terms,
        combine=lambda a: a[..., 0], lower=0.01, upper=1.5)
    return obj, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    obj, _ = make_watershed_objective(args.n)
    print(f"calibrating {args.n:,} sub-catchment recession parameters...")
    t0 = time.time()
    r = abo_minimize(obj, args.n, config=ABOConfig(n_passes=6), device=dev)
    dt = time.time() - t0                # fun is a host number: synced
    print(f"  J(k) residual  : {r.fun:.3e}")
    print(f"  wall time      : {dt:.2f}s  ({r.fe:,} probes)  "
          f"({device_label(dev)})")
    # recover a few parameters and compare against truth
    truth = k_true(torch.arange(5), torch.float32)
    print(f"  k[0:5] found   : {[f'{float(v):.4f}' for v in r.x[:5]]}")
    print(f"  k[0:5] true    : {[f'{float(v):.4f}' for v in truth]}")
    return r


if __name__ == "__main__":
    main()
