"""Thin dict-in/dict-out front-end over :class:`SolveEngine`.

Port of :mod:`repro.engine.service`: the same payloads and error codes.
This is the boundary a wire protocol (CLI, HTTP, RPC) talks to: every
method takes and returns JSON-serializable payloads, never tensors; the
port's HTTP front door, ``repro_torch.serve.frontend``, serves it.

Error payloads follow the serving tier's standard envelope
(``repro_torch.serve.errors``): every miss carries a machine-readable
``code`` (``unknown_job`` / ``not_done`` / ``conflict``) next to the
human ``error`` string, plus ``status`` when the job exists — an HTTP
front-end maps codes to statuses via ``errors.status_for`` without
string-matching error text, and an embedding application branches the
same way.
"""
from __future__ import annotations

import numpy as np

from repro_torch.engine.jobs import CANCELLED, DONE, FAILED, JobSpec
from repro_torch.engine.scheduler import SolveEngine

# status reported for ids this engine has no record of (either never
# submitted here, or evicted by the retention GC)
UNKNOWN = "unknown"


def _unknown(job_id: str) -> dict:
    return {"job_id": job_id, "status": UNKNOWN,
            "error": "unknown job", "code": "unknown_job"}


class SolveService:
    def __init__(self, engine: SolveEngine | None = None, **engine_kw):
        self.engine = engine or SolveEngine(**engine_kw)

    # ------------------------------------------------------------- endpoints
    def submit(self, request: dict) -> dict:
        """request: {objective, n, config?: {...}, seed?, x0?, tag?}"""
        spec = JobSpec.from_dict(request)
        job_id = self.engine.submit(spec)
        return {"job_id": job_id, "status": self.engine.jobs[job_id].status}

    def poll(self, job_id: str) -> dict:
        if job_id not in self.engine.jobs:
            return _unknown(job_id)
        return self.engine.poll(job_id)

    def result(self, job_id: str, mark_fetched: bool = True) -> dict:
        """``mark_fetched=True`` (the in-process default, where returning
        the dict IS delivery) lets later snapshots drop the solution
        vector; a wire front-end should pass False and call
        :meth:`self.mark_fetched` only after its reply actually went out,
        so a failed write can't strand the client without x."""
        if job_id not in self.engine.jobs:
            return _unknown(job_id)
        rec = self.engine.jobs[job_id]
        if rec.status in (CANCELLED, FAILED):
            # terminal-without-result: the status payload IS the answer
            # (the HTTP front-end maps conflict to 409, not a generic
            # error)
            out = {"job_id": job_id, "status": rec.status,
                   "error": rec.error or f"job {rec.status}, no result",
                   "code": "conflict"}
            return out
        if rec.status != DONE:
            return {"job_id": job_id, "status": rec.status,
                    "error": "not done", "code": "not_done"}
        out = {"job_id": job_id, "status": DONE, "fun": rec.fun,
               "history": list(rec.history)}
        # x can be gone after a fetch -> kill -> resume cycle (snapshots
        # evict delivered solution vectors); fun/history still stand
        if rec.x is not None:
            out["x"] = np.asarray(rec.x, np.float64).tolist()
        if mark_fetched:
            # through the engine, not a bare attribute write: the delivery
            # is journaled and the retention GC may evict the record now
            self.engine.mark_fetched(job_id)
        return out

    def mark_fetched(self, job_id: str) -> None:
        self.engine.mark_fetched(job_id)

    def cancel(self, job_id: str) -> dict:
        if job_id not in self.engine.jobs:
            return _unknown(job_id)
        ok = self.engine.cancel(job_id)
        rec = self.engine.jobs.get(job_id)   # retain_done=0 can evict the
        #                                      record inside cancel itself
        return {"job_id": job_id, "cancelled": ok,
                "status": rec.status if rec is not None else CANCELLED}

    def stats(self) -> dict:
        """Service stats: the historical flat keys plus the canonical
        registry snapshot under ``"metrics"``.

        The canonical source is ``SolveEngine.stats()`` (the obs metrics
        registry — one census, sampled here once). The top-level keys
        (``steps``, ``active_lanes``, ``pool_device_bytes``, ...) are
        kept as ALIASES for existing clients and tests.

        .. deprecated::
            New consumers should read ``out["metrics"]`` (or scrape
            ``/metrics``); the aliases mirror it and won't grow new
            fields.
        """
        eng = self.engine
        by_status: dict[str, int] = {}
        for rec in eng.jobs.values():
            by_status[rec.status] = by_status.get(rec.status, 0) + 1
        snap = eng.stats()               # refreshes gauges; one census
        out = {"steps": eng.step_count, "lanes": eng.lanes,
               "devices": eng.n_dev,
               "active_lanes": int(snap["engine_active_lanes"]),
               "queued": int(snap["engine_queue_depth"]),
               "jobs": by_status,
               "families": int(snap["engine_families"]),
               "families_created": int(snap["engine_families_created"]),
               "executables": int(snap["engine_executables"]),
               "retain_done": eng.retain_done,
               **eng.pad_stats(), **eng.memory_stats(),
               "metrics": snap}
        if eng.ckpt is not None and eng.journal_every is not None:
            out["journal"] = eng.ckpt.journal_stats()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition of the engine registry (the
        ``/metrics`` endpoint body)."""
        return self.engine.render_prometheus()

    # ------------------------------------------------------------- execution
    def step(self) -> int:
        return self.engine.step()

    def drain(self, max_steps: int | None = None) -> int:
        return self.engine.run(max_steps=max_steps)
