"""Runs ``chip_smoke.py``'s serving phase (``[http]``) several times on the
card, keeping every run's server logs.

    PYTHONPATH=src python -m benchmarks_torch.http_repeat [--repeats 4]

Builds the kernels, runs the smoke's engine phase once (the serving phase
holds its jobs to that run's results), then the serving phase
``--repeats`` times: (a) one worker under a 24-job burst, (b) the router
over two workers with worker 0 killed at its 2nd step. Each run prints
the smoke's own ``[http]`` lines and its verdict; a failed run is counted,
not fatal. The logs of the servers, the router and the workers of run
``i`` are copied to ``--out``/``run{i}`` (default
``chiprun_out/http_repeat``). Exits 1 if any run failed. Fails without a
card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import torch

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(chip_smoke.ROOT,
                                                  "chiprun_out",
                                                  "http_repeat"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("http_repeat needs a card")
    chip_smoke.import_port()
    from repro_torch.kernels import _build

    logs = os.path.join(chip_smoke.ROOT, "build", "http_smoke")
    run = [0]
    rmtree = shutil.rmtree

    def keep_logs(path, *a, **kw):
        """The phase removes its directory at its start and end: copy the
        logs out first."""
        if os.path.abspath(str(path)) == logs and os.path.isdir(path):
            dst = os.path.join(args.out, f"run{run[0]}")
            rmtree(dst, ignore_errors=True)
            shutil.copytree(path, dst, ignore=shutil.ignore_patterns(
                "*.npy", "step_*", "*.trace.json"))
        return rmtree(path, *a, **kw)

    os.makedirs(args.out, exist_ok=True)
    shutil.rmtree = keep_logs
    try:
        _build.build_all()
        dev = torch.device("cuda")
        uninterrupted = chip_smoke.engine_phase(dev, 0)
        failed = 0
        for i in range(args.repeats):
            run[0] = i
            t0 = time.perf_counter()
            try:
                chip_smoke.http_phase(dev, uninterrupted)
                verdict = "ok"
            except SystemExit:     # chip_smoke.fail printed the reason
                failed += 1
                verdict = "FAIL"
                keep_logs(logs, ignore_errors=True)
            print(f"[http_repeat] run {i}: {verdict} in "
                  f"{time.perf_counter() - t0:.1f} s | "
                  f"{chip_smoke.nvidia_smi_line()}", flush=True)
    finally:
        shutil.rmtree = rmtree
    print(f"[http_repeat] {failed} of {args.repeats} runs failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
