"""Deterministic, seedable fault injection for the solve engine.

The port's own copy of :mod:`repro.engine.faults`: the same sites, the
same ``REPRO_INJECT_FAULTS`` grammar and the same deterministic schedules.
The port's engine arms ``pool_resize``, ``fused_step`` and
``objective_eval``, its checkpoint manager ``snapshot_write`` and
``journal_append``, and ``repro_torch.serve``'s front door the serving
sites ``http_reply``, ``worker_crash`` and ``slow_client``.

The registry names a small catalog of *failpoints* — places where the
engine touches durable state or numerical results — and lets a test (or
a chaos CI run) arm any of them with a deterministic schedule:

=================  ====================================================
site               where it fires
=================  ====================================================
``snapshot_write``   inside :meth:`CheckpointManager.save`, after the
                     leaves land but before the manifest commit (the
                     window a real crash tears a snapshot in)
``journal_append``   inside :meth:`CheckpointManager.journal_append`,
                     mid-record (a kill here leaves a torn tail)
``pool_resize``      in the scheduler, before a pool grow/shrink
``fused_step``       in the scheduler, before a fused-sweep dispatch
``objective_eval``   per *job* at placement — poisons the lane's
                     iterate with NaN so the objective goes non-finite
``http_reply``       in the serving front-end, just before a reply body
                     is written (a ``raise`` here drops the connection —
                     the torn reply a flaky network produces)
``worker_crash``     in the serving front-end's stepper loop, at the
                     step boundary (``kill`` by default — how the router
                     chaos tests murder a worker mid-traffic)
``slow_client``      in the serving front-end, before the request body
                     is read (``delay`` by default — a client that
                     trickles its upload and must not stall anyone else)
=================  ====================================================

Schedules are parsed from a compact spec string (``--inject`` /
``REPRO_INJECT_FAULTS`` / ``SolveEngine(faults=...)``)::

    site[:key=val]*[;site...]

    snapshot_write:nth=2:kind=kill        fire on the 2nd hit, kill -9
    journal_append:nth=1                  fire on the 1st hit, raise
    objective_eval:every=4:seed=7         poison every 4th job
    objective_eval:prob=0.1:seed=3        poison ~10% of jobs, seeded

Keys: ``nth=N`` (fire on the Nth hit only), ``every=K`` (fire on hits
K, 2K, ...), ``prob=P:seed=S`` (deterministic per-key Bernoulli via
sha256 — independent of hit order), ``kind=raise|kill|poison|delay``
(default: ``poison`` for objective_eval, ``kill`` for worker_crash,
``delay`` for slow_client, ``raise`` otherwise), ``delay_s=S``
(sleep length for ``delay`` kinds; default 0.05).

Determinism contract: ``objective_eval`` decisions are keyed by the
*job id*, not by a process-local hit counter — a killed-and-resumed
engine replays its journal, re-derives the same poison set, and lands
on the same FAILED jobs. Durable-state sites (snapshot/journal) use hit
counters: they exist to kill the process at a precise write boundary,
after which the process is gone and the counter with it.

Disabled injection is the null singleton ``NULL_FAULTS`` — same
discipline as ``repro.obs``: every call site does ``faults.check(...)``
unconditionally, and the null path is a dict lookup returning None.
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field

SITES = (
    "snapshot_write",
    "journal_append",
    "pool_resize",
    "fused_step",
    "objective_eval",
    # serving-layer sites (repro_torch.serve): the same registry chaos-tests
    # the wire tier — a worker killed mid-traffic, a torn HTTP reply, a
    # client that trickles its body — with the same determinism contract
    "http_reply",
    "worker_crash",
    "slow_client",
)

KINDS = ("raise", "kill", "poison", "delay")

# site -> default kind when the spec names none ("raise" otherwise)
DEFAULT_KINDS = {
    "objective_eval": "poison",
    "worker_crash": "kill",
    "slow_client": "delay",
}

ENV_VAR = "REPRO_INJECT_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by a tripped ``raise``-kind failpoint."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        self.detail = detail
        super().__init__(f"injected fault at {site}" + (f" ({detail})" if detail else ""))


@dataclass
class Fault:
    """One armed failpoint: a site plus a firing schedule."""

    site: str
    kind: str = "raise"
    nth: int | None = None      # fire on exactly the Nth hit (1-based)
    every: int | None = None    # fire on hits K, 2K, 3K, ...
    prob: float | None = None   # seeded per-key Bernoulli
    seed: int = 0
    delay_s: float = 0.05       # sleep length for kind=delay
    hits: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown failpoint site {self.site!r}; know {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; know {KINDS}")
        if self.kind == "poison" and self.site != "objective_eval":
            raise ValueError("kind=poison only makes sense at objective_eval")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        n_scheds = sum(x is not None for x in (self.nth, self.every, self.prob))
        if n_scheds != 1:
            raise ValueError(
                f"fault at {self.site}: exactly one of nth/every/prob required")

    def should_fire(self, key: str | None = None) -> bool:
        """Advance the schedule one hit; True if this hit trips.

        ``key`` feeds the prob schedule (and, when present, the every
        schedule) so decisions are stable under replay: the scheduler
        passes the job id for ``objective_eval``.
        """
        self.hits += 1
        if self.prob is not None:
            basis = key if key is not None else str(self.hits)
            h = hashlib.sha256(
                f"{self.seed}:{self.site}:{basis}".encode()).digest()
            return int.from_bytes(h[:8], "big") / 2**64 < self.prob
        if self.every is not None:
            if key is not None:
                # job ids are "job-NNNNNN" — schedule off the submit
                # ordinal so replayed submissions re-derive identically
                tail = key.rsplit("-", 1)[-1]
                ordinal = int(tail) + 1 if tail.isdigit() else self.hits
            else:
                ordinal = self.hits
            return ordinal % self.every == 0
        return self.hits == self.nth

    def execute(self, key: str | None = None) -> None:
        """Raise/kill/delay semantics for a fault check() said should
        fire. ``poison`` kinds return — the caller keeps control to mark
        the lane (only objective_eval can be poison, enforced at parse).
        ``delay`` kinds sleep and return — the caller proceeds, just
        late (a slow client, a congested reply path)."""
        if self.kind == "kill":
            os._exit(137)
        if self.kind == "delay":
            time.sleep(self.delay_s)
            return
        if self.kind == "raise":
            raise InjectedFault(self.site, detail=key or "")


class FaultRegistry:
    """Site -> Fault map; the engine's single injection entry point."""

    enabled = True

    def __init__(self, faults: list[Fault] | None = None):
        self._by_site: dict[str, Fault] = {}
        for f in faults or []:
            if f.site in self._by_site:
                raise ValueError(f"duplicate failpoint for site {f.site!r}")
            self._by_site[f.site] = f
        self._metrics = None

    def bind_metrics(self, registry) -> None:
        """Attach an obs MetricsRegistry for engine_faults_injected_total."""
        self._metrics = registry

    def check(self, site: str, key: str | None = None) -> Fault | None:
        """Return the armed Fault if this hit should fire, else None.

        The caller decides what firing means (raise/kill/poison) via
        :meth:`trip` or by inspecting ``fault.kind`` — poison sites
        need to keep control to mark the lane.
        """
        f = self._by_site.get(site)
        if f is None or not f.should_fire(key):
            return None
        if self._metrics is not None:
            self._metrics.counter(
                "engine_faults_injected_total",
                "faults fired by the injection registry", site=site).inc()
        return f

    def trip(self, site: str, key: str | None = None) -> None:
        """check() and immediately execute raise/kill semantics.

        For durable-state failpoints the caller just calls trip() at
        the boundary; a ``kill`` fault exits the process with no
        cleanup (``os._exit``), which is exactly the torn-state a real
        crash produces.
        """
        f = self.check(site, key)
        if f is not None:
            f.execute(key)

    def __bool__(self) -> bool:
        return bool(self._by_site)


class _NullFaults(FaultRegistry):
    """Disabled injection: check() is a single dict .get miss."""

    enabled = False

    def __init__(self):
        super().__init__([])

    def bind_metrics(self, registry) -> None:  # keep the null path free
        pass


NULL_FAULTS = _NullFaults()


def parse_fault_spec(spec: str) -> FaultRegistry:
    """Parse ``site[:key=val]*[;site...]`` into a FaultRegistry."""
    faults: list[Fault] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site, kvs = fields[0].strip(), fields[1:]
        kw: dict = {"site": site}
        for kv in kvs:
            if "=" not in kv:
                raise ValueError(f"bad fault field {kv!r} in {part!r}")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k in ("nth", "every", "seed"):
                kw[k] = int(v)
            elif k in ("prob", "delay_s"):
                kw[k] = float(v)
            elif k == "kind":
                kw[k] = v.strip()
            else:
                raise ValueError(f"unknown fault key {k!r} in {part!r}")
        if "kind" not in kw and site in DEFAULT_KINDS:
            kw["kind"] = DEFAULT_KINDS[site]
        if not any(k in kw for k in ("nth", "every", "prob")):
            kw["nth"] = 1
        faults.append(Fault(**kw))
    return FaultRegistry(faults)


def resolve_faults(arg=None) -> FaultRegistry:
    """Normalize the ``faults=`` engine argument.

    Accepts a FaultRegistry, a spec string, or None (in which case the
    ``REPRO_INJECT_FAULTS`` env var is consulted; unset -> NULL_FAULTS).
    """
    if isinstance(arg, FaultRegistry):
        return arg
    if isinstance(arg, str):
        return parse_fault_spec(arg)
    if arg is not None:
        raise TypeError(f"faults= wants FaultRegistry | str | None, got {type(arg)}")
    env = os.environ.get(ENV_VAR, "")
    return parse_fault_spec(env) if env.strip() else NULL_FAULTS
