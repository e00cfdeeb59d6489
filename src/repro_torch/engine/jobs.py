"""Job model for the batched multi-tenant solve engine.

Port of :mod:`repro.engine.jobs`. ``JobSpec.to_dict`` writes the same JSON
as the reference's for the same spec, and the journal record kinds are the
same strings, so either package reads the other's records. A DONE job's
result is the port's ``ABOResult``, with x and the history as CPU tensors.

A *job* is one ABO solve request: objective name, dimensionality, config,
and an optional seed/x0. The engine (repro_torch.engine.scheduler) owns a
table of ``JobState`` records and drives the QUEUED -> RUNNING -> DONE
lifecycle; CANCELLED short-circuits it at any point before completion.

Both classes round-trip through plain JSON dicts — that is what lets the
checkpoint aux sidecar capture the whole job table atomically with the
in-flight solver arrays, and what the service front-end speaks over the
wire.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core.abo import ABOConfig, ABOResult

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"       # terminal: non-finite fun/x quarantined, or TTL expiry
STATUSES = (QUEUED, RUNNING, DONE, CANCELLED, FAILED)

# Journal record kinds (the append-only checkpoint journal, see
# scheduler.SolveEngine). The journal is an *intent log* of client inputs
# — everything else (lane placement, pass progress, results) is
# deterministically re-derivable from the last base snapshot plus these,
# which is what keeps journal records tiny and replay bit-exact:
#   submit  {"job_id", "spec": JobSpec.to_dict()}
#   cancel  {"job_id"}
#   fetched {"job_id"}   # result delivered -> snapshots may drop x / GC
#   expire  {"job_id"}   # TTL/deadline passed while queued — wall-clock
#                          decisions are journaled so replay re-derives the
#                          same FAILED set without re-reading the clock
J_SUBMIT = "submit"
J_CANCEL = "cancel"
J_FETCHED = "fetched"
J_EXPIRE = "expire"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What to solve. Frozen + hashable so bucket keys can embed configs."""

    objective: str                   # name in repro_torch.objectives.OBJECTIVES
    n: int                           # number of decision variables
    config: ABOConfig = dataclasses.field(default_factory=ABOConfig)
    seed: int | None = None          # random feasible start
    x0: tuple[float, ...] | None = None   # explicit start (overrides seed)
    tag: str = ""                    # free-form client label
    ttl_s: float | None = None       # queue-time budget: a job still QUEUED
    #                                  this many seconds after submit is
    #                                  expired (FAILED) instead of placed

    def __post_init__(self):
        if not isinstance(self.config, ABOConfig):
            # reject early: a str/list here would otherwise surface as an
            # AttributeError deep inside the engine's step loop
            raise ValueError(
                "config must be an ABOConfig (or a dict via from_dict), "
                f"got {type(self.config).__name__}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.seed is not None:
            # reject early what PRNGKey would reject at refill time, deep
            # inside the engine's step loop (seeds >= 2**31 are fine: the
            # scheduler folds them to uint32 exactly as PRNGKey does)
            if not isinstance(self.seed, (int, np.integer)) \
                    or isinstance(self.seed, bool):
                raise ValueError(
                    f"seed must be an int, got {type(self.seed).__name__}")
            if not -(2 ** 63) <= self.seed < 2 ** 63:
                raise ValueError(
                    f"seed must fit in 64 signed bits, got {self.seed}")
        if self.x0 is not None and len(self.x0) != self.n:
            raise ValueError(
                f"x0 has {len(self.x0)} entries for an n={self.n} job")
        if self.ttl_s is not None and not self.ttl_s > 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")

    def to_dict(self) -> dict:
        d = {"objective": self.objective, "n": self.n,
             "config": dataclasses.asdict(self.config), "tag": self.tag}
        if self.seed is not None:
            d["seed"] = int(self.seed)   # np.integer seeds aren't JSON
        if self.x0 is not None:
            d["x0"] = list(self.x0)
        if self.ttl_s is not None:
            d["ttl_s"] = float(self.ttl_s)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        cfg = d.get("config")
        if isinstance(cfg, dict):
            try:
                cfg = ABOConfig(**cfg)
            except TypeError as e:      # unknown keys -> clear client error
                raise ValueError(f"bad config: {e}") from e
        elif cfg is not None and not isinstance(cfg, ABOConfig):
            raise ValueError(
                "config must be a dict of ABOConfig fields, "
                f"got {type(cfg).__name__}")
        x0 = d.get("x0")
        return cls(objective=d["objective"], n=int(d["n"]),
                   config=cfg or ABOConfig(),
                   seed=d.get("seed"),
                   x0=tuple(float(v) for v in x0) if x0 is not None else None,
                   tag=d.get("tag", ""), ttl_s=d.get("ttl_s"))


@dataclasses.dataclass
class JobState:
    """Engine-side record: spec + lifecycle + (once DONE) the result."""

    job_id: str
    spec: JobSpec
    status: str = QUEUED
    passes_done: int = 0
    history: list[float] = dataclasses.field(default_factory=list)
    fun: float | None = None
    x: np.ndarray | None = None      # final solution (DONE only)
    error: str | None = None         # FAILED detail (quarantine/TTL reason)
    fetched: bool = False            # result() delivered at least once —
    #                                  snapshots stop carrying x (GC)
    done_seq: int | None = None      # engine-wide finish order (DONE or
    #                                  CANCELLED) — retention-window GC
    #                                  evicts delivered records oldest-first
    # lifecycle wall-clock marks (time.time()), set by the engine as the
    # job transitions: submit -> placed on a lane -> done -> first fetch.
    # They feed the queued/run/fetch latency histograms and survive
    # snapshots, so a resumed service's latency accounting spans the kill.
    t_submit: float | None = None
    t_place: float | None = None
    t_done: float | None = None
    t_fetch: float | None = None
    # the dtype of the job's aggregates and history ("float32" or
    # "float64"), set by the engine from the job's family. Not written by
    # to_dict, so the aux job table stays the reference's; a resumed
    # engine sets it again from its own dtype.
    agg_dtype: str = "float32"

    @property
    def n_passes(self) -> int:
        return self.spec.config.n_passes

    def poll_dict(self) -> dict:
        """Cheap status snapshot (no solution vector) for poll responses."""
        d = {"job_id": self.job_id, "status": self.status,
             "passes_done": self.passes_done, "n_passes": self.n_passes,
             "objective": self.spec.objective, "n": self.spec.n,
             "tag": self.spec.tag}
        if self.fun is not None:
            d["fun"] = self.fun
        if self.error is not None:
            d["error"] = self.error
        return d

    def result(self) -> ABOResult:
        if self.status != DONE:
            raise RuntimeError(
                f"job {self.job_id} is {self.status}, not {DONE}")
        self.fetched = True              # later snapshots drop x (see to_dict)
        cfg = self.spec.config
        # x is None only for a result delivered before a kill, or one too
        # large for the snapshot's aux (see to_dict)
        x = None if self.x is None else torch.from_numpy(self.x)
        return ABOResult(x=x, fun=self.fun,
                         fe=cfg.n_passes * cfg.samples_per_pass * self.spec.n,
                         history=torch.tensor(
                             self.history,
                             dtype=getattr(torch, self.agg_dtype)),
                         n=self.spec.n, config=cfg)

    # ---- checkpoint (de)serialization -----------------------------------
    # Bounds on DONE-job solution vectors carried in the aux JSON sidecar:
    # vectors bigger than AUX_X_MAX_N — or already delivered to a client
    # (``fetched``) — are dropped from snapshots. fun/history always
    # survive; the solution itself is only lost across a kill if the job
    # finished and was never fetched while oversized, or was fetched (in
    # which case the client has it). Without fetch-time eviction every
    # snapshot re-serializes every DONE result forever — unbounded aux
    # growth for a long-lived service.
    AUX_X_MAX_N = 65536

    def to_dict(self) -> dict:
        d = {"job_id": self.job_id, "spec": self.spec.to_dict(),
             "status": self.status, "passes_done": self.passes_done,
             "history": [float(v) for v in self.history]}
        if self.fun is not None:
            d["fun"] = self.fun
        if self.error is not None:
            d["error"] = self.error
        if self.done_seq is not None:
            d["done_seq"] = self.done_seq
        for k in ("t_submit", "t_place", "t_done", "t_fetch"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.fetched:
            d["fetched"] = True
        elif self.x is not None and self.x.size <= self.AUX_X_MAX_N:
            d["x"] = np.asarray(self.x, np.float64).tolist()
            d["x_dtype"] = str(np.asarray(self.x).dtype)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobState":
        x = d.get("x")
        if x is not None:
            x = np.asarray(x, np.dtype(d.get("x_dtype", "float32")))
        return cls(job_id=d["job_id"], spec=JobSpec.from_dict(d["spec"]),
                   status=d["status"], passes_done=d.get("passes_done", 0),
                   history=list(d.get("history", [])), fun=d.get("fun"),
                   error=d.get("error"),
                   x=x, fetched=d.get("fetched", False),
                   done_seq=d.get("done_seq"),
                   t_submit=d.get("t_submit"), t_place=d.get("t_place"),
                   t_done=d.get("t_done"), t_fetch=d.get("t_fetch"))


def next_job_id(counter: int) -> str:
    return f"job-{counter:06d}"
