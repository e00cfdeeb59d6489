"""How long a burst of requests waits for the front door's engine lock
while the engine always has work.

    PYTHONPATH=src python -m benchmarks_torch.serve_lock_burst \\
        [--requests 24] [--step-s 0.5]

On the CPU; the engine is replaced by a stub whose ``step`` takes
``--step-s`` seconds, either asleep (the interpreter lock released, as
while a step waits on the card) or spinning in Python (the lock held),
and whose ``pending()`` is always true, so the stepper never idles. The
burst is ``--requests`` concurrent ``GET /stats``, each on its own
connection, against ``repro_torch.serve.frontend.Frontend`` with its
:class:`FifoLock` and with the reference's ``threading.Lock`` in its
place. One JSON line a (lock, step kind): every request's seconds from
its send to its reply, sorted. A host-side measurement: it times no
device.
"""
from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def burst(lock, step_s: float, kind: str, n: int) -> list[float]:
    from repro_torch.engine import SolveService
    from repro_torch.serve.frontend import Frontend, FrontendConfig

    svc = SolveService(lanes=1, device="cpu")
    svc.engine.pending = lambda: True

    def step():
        if kind == "sleep":
            time.sleep(step_s)
            return
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < step_s:
            sum(range(1000))

    svc.step = step
    fe = Frontend(svc, 0, FrontendConfig(deadline_s=300.0))
    fe._engine_lock = lock
    threading.Thread(target=fe.httpd.serve_forever, daemon=True).start()
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    waits = [0.0] * n

    def one(i):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("GET", "/stats")
            conn.getresponse().read()
        finally:
            conn.close()
        waits[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    fe.httpd.shutdown()
    fe._stop_stepper.set()
    with fe._wake:
        fe._wake.notify_all()
    fe.stepper_thread.join(timeout=60)
    fe.httpd.server_close()
    return sorted(waits)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--step-s", type=float, default=0.5)
    args = ap.parse_args(argv)
    from repro_torch.serve.frontend import FifoLock
    for name, make in (("FifoLock", FifoLock),
                       ("threading.Lock", threading.Lock)):
        for kind in ("sleep", "spin"):
            waits = burst(make(), args.step_s, kind, args.requests)
            print(json.dumps({"lock": name, "step": kind,
                              "step_s": args.step_s,
                              "requests": args.requests,
                              "seconds": [round(w, 3) for w in waits]}),
                  flush=True)


if __name__ == "__main__":
    main()
