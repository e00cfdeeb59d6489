"""Solution quality and time of the PyTorch port's kernel route as n grows.

    PYTHONPATH=src python -m benchmarks_torch.kernel_route_quality \
        --n 100000 1000000 100000000 --plain-max 100000000

On the card (CUDA required): for each n it runs ``abo_minimize(GRIEWANK, n,
config=ABOConfig(use_kernel=True))`` and, for n <= ``--plain-max``, the
same route with the kernels' plain versions on the card
(``abo_minimize_kernel_ref``, the JAX package's algorithm transcribed;
``benchmarks/kernel_route_quality.py`` runs the JAX package's own on a
CPU). One JSON line per run: fun, the carried history, wall
time, and the share of coordinates where the two runs' x agree. Imports
torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.kernels.coord_sweep.ref import abo_minimize_kernel_ref
from repro_torch.objectives import GRIEWANK


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[10**5, 10**6, 2 * 10**6, 10**7, 10**8])
    ap.add_argument("--plain-max", type=int, default=10**7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    cfg = ABOConfig(use_kernel=True)
    for n in args.n:
        t0 = time.perf_counter()
        r = abo_minimize(GRIEWANK, n, config=cfg, device=dev)
        torch.cuda.synchronize()
        row = {"device": name, "n": n, "route": "kernel", "fun": r.fun,
               "history": r.history.tolist(),
               "seconds": time.perf_counter() - t0}
        if n <= args.plain_max:
            t0 = time.perf_counter()
            p = abo_minimize_kernel_ref(n, config=cfg, device=dev)
            torch.cuda.synchronize()
            row.update(plain_fun=p.fun, plain_history=p.history.tolist(),
                       plain_seconds=time.perf_counter() - t0,
                       x_identical=float((p.x == r.x).double().mean()))
            del p
        print(json.dumps(row), flush=True)
        del r


if __name__ == "__main__":
    main()
