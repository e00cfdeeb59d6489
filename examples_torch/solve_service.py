"""Quickstart: many concurrent ABO solves through one batched sweep.

    PYTHONPATH=src python examples_torch/solve_service.py [--device cpu]

Port of ``examples/solve_service.py`` on ``repro_torch.engine``; it runs on
the card unless ``--device cpu`` is given. The engine packs jobs into
shared solve lanes (a (K, B, m) probe tile per block instead of K separate
(B, m) launches) and refills a lane the moment its job finishes, so a
small lane budget serves an arbitrarily deep queue. The minimal client
loop is::

    from repro_torch.engine import SolveEngine, JobSpec

    eng = SolveEngine(lanes=8)                      # concurrency budget
    jid = eng.submit(JobSpec("griewank", 1000, seed=0))
    eng.run()                                       # drain the queue
    res = eng.result(jid)                           # ABOResult, same fields
    print(res.fun)                                  # as abo_minimize's

Each job's fun, x and history are bit for bit the port's ``abo_minimize``
with the same objective, n, config and seed. Jobs of *different* n share
one block-paged pool per objective: each lane's coordinate blocks live in
its family's pages and the row-compacted sweep touches only occupied block
rows. The dict-level front end used below (``SolveService``) is the one
``python -m repro_torch.launch.solve_server --http PORT`` serves over HTTP.
"""
import argparse
import time

import torch

from repro_torch.device import device_label, resolve_device
from repro_torch.engine import SolveService

N_JOBS = 12
LANES = 4
SIZES = (1100, 1400, 1666, 1800)     # distinct exact pads, shared rungs
CONFIG = {"samples_per_pass": 20, "n_passes": 4, "block_size": 256}


def job(i: int) -> dict:
    """The i-th request of the workload: a plain dict, wire-format ready."""
    return {"objective": ("griewank", "sphere", "rastrigin")[i % 3],
            "n": SIZES[i % len(SIZES)], "config": dict(CONFIG), "seed": i,
            "tag": f"demo-{i}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    svc = SolveService(lanes=LANES, device=dev)

    job_ids = [svc.submit(job(i))["job_id"] for i in range(N_JOBS)]
    print(f"submitted {N_JOBS} jobs over n in {SIZES} onto {LANES} lanes")

    # poll-while-stepping: a real deployment would poll over HTTP while the
    # server steps; in-process we interleave the two by hand
    t0 = time.time()
    while svc.engine.pending():
        svc.step()
        s = svc.stats()
        fill = s["fill_ratio"]
        print(f"  step {s['steps']:3d}: active={s['active_lanes']} "
              f"queued={s['queued']} done={s['jobs'].get('done', 0)}"
              + (f" fill={fill:.0%}" if fill is not None else ""))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    print(f"drained in {dt:.2f}s ({N_JOBS / dt:.1f} jobs/s, "
          f"{svc.stats()['families_created']} executable families for "
          f"{len(set(SIZES))} problem sizes) ({device_label(dev)})")
    results = {jid: svc.result(jid) for jid in job_ids}
    for jid in job_ids[:3]:
        r = results[jid]
        print(f"  {jid}: f={r['fun']:.3e} after {len(r['history'])} passes")
    return job_ids, results


if __name__ == "__main__":
    main()
