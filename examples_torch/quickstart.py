"""Quickstart: the paper's headline result, in seconds, on the card.

Minimizes the 1,000,000-dimensional Griewank function with ABO — the
algorithm from "Super-speeds with Zero-RAM" (Amo-Boateng, 2017) — and
reports objective, function evaluations, wall time and memory, mirroring
the paper's Tables 1-3. Port of ``examples/quickstart.py`` on
``repro_torch``: it runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples_torch/quickstart.py [--n 1000000] [--device cpu]
"""
import argparse
import resource
import time

import torch

from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.device import device_label, peak_memory_mb, resolve_device
from repro_torch.objectives import GRIEWANK


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--paper-pure", action="store_true",
                    help="disable the beyond-paper continuation schedule")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)

    cfg = ABOConfig(coupling_schedule="none" if args.paper_pure else "linear")
    print(f"ABO on Griewank, n={args.n:,} decision variables "
          f"(m = {cfg.n_passes * cfg.samples_per_pass} probes/coordinate)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    r = abo_minimize(GRIEWANK, args.n, config=cfg, device=dev)
    dt = time.time() - t0                # fun is a host number: synced

    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    theory_mb = args.n * 4 / 2**20
    print(f"  best objective : {r.fun:.3e}   (the paper's laptop figure at "
          f"1e6: ~1.1e-9)")
    print(f"  function evals : {r.fe:,}       (= 250·N, paper Table 3)")
    print(f"  wall time      : {dt:.2f}s       ({label})")
    print(f"  probes/second  : {r.fe/dt:.3e}  ({label})")
    print(f"  peak RSS       : {rss_mb:.0f} MB, peak device memory "
          f"{peak_memory_mb(dev)}  (solution vector alone: {theory_mb:.0f} MB)")
    print(f"  pass history   : {[f'{float(h):.2e}' for h in r.history]}")
    return r


if __name__ == "__main__":
    main()
