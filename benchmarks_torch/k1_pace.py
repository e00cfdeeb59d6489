"""What sets the pace of one K1 pass: the probes of a block, or the fixed
cost a block pays (base planes, the fold trees, the cluster barrier).

    PYTHONPATH=src python -m benchmarks_torch.k1_pace [--blocks 2048]

On the card (CUDA required). Times one pass of ``sweep_pass`` over
(blocks, 4096) uniform coordinates with a cluster of 16 CTAs and with one
CTA, for several candidate counts m. A lane of a virtual thread probes
ceil(m / C) candidates of each of its ceil(4096 / 1024) = 4 coordinates,
so the time per block is fitted, by least squares, as

    fixed + per_step x 4 x ceil(m / C)

and ``fixed`` is what a block costs with no probes at all. One JSON line a
(C, m) reading, then one a fit. Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

M_VALUES = (3, 16, 17, 32, 33, 48, 50, 64)
BLOCK = 4096


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels.coord_sweep.ops import sweep_pass
    from repro_torch.kernels.griewank.ref import griewank_aggregates_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x2d = torch.rand((args.blocks, BLOCK), generator=gen, device=dev)
    x2d = x2d * 1200.0 - 600.0
    n = x2d.numel()
    aggs = griewank_aggregates_ref(x2d, n_valid=n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cluster in (16, 1):
        rows = []
        for m in M_VALUES:
            xs = [x2d.clone() for _ in range(2)]
            sweep_pass(xs[0], aggs, m=m, n_valid=n, half_width=37.5,
                       lam=0.5, is_first=False, cluster=cluster)  # warm-up
            torch.cuda.synchronize()
            start.record()
            sweep_pass(xs[1], aggs, m=m, n_valid=n, half_width=37.5,
                       lam=0.5, is_first=False, cluster=cluster)
            end.record()
            torch.cuda.synchronize()
            us = 1e3 * start.elapsed_time(end) / args.blocks
            steps = (BLOCK // 1024) * math.ceil(m / cluster)
            rows.append((steps, us))
            print(json.dumps({"cluster": cluster, "m": m, "blocks":
                              args.blocks, "us_per_block": us,
                              "probe_steps_per_lane": steps}), flush=True)
            del xs
        k = len(rows)
        sx = sum(s for s, _ in rows)
        sy = sum(u for _, u in rows)
        sxx = sum(s * s for s, _ in rows)
        sxy = sum(s * u for s, u in rows)
        per_step = (k * sxy - sx * sy) / (k * sxx - sx * sx)
        fixed = (sy - per_step * sx) / k
        at50 = (BLOCK // 1024) * math.ceil(50 / cluster)
        print(json.dumps({"cluster": cluster, "fit": "fixed + per_step x "
                          "steps", "fixed_us": fixed, "per_step_us": per_step,
                          "probe_share_at_m50": per_step * at50
                          / (fixed + per_step * at50)}), flush=True)


if __name__ == "__main__":
    main()
