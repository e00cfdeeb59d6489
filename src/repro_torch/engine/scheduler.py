"""Slot-based continuous batching of ABO solve lanes over paged pools.

Port of :mod:`repro.engine.scheduler` for one device. The engine owns a
budget of ``lanes`` concurrent solves. Jobs are grouped by *family*
(objective, effective config, dtype — see ``batched.family_key``); each
family gets one :class:`LanePool` whose lane coordinate blocks live in a
shared page pool with host-side page tables. Between steps, lanes whose
job has run all its passes are finalized via a compact gather of just
those lanes and refilled from the queue.

Pool memory is elastic: a pool's lane-slot count starts at observed demand
and rides the count ladder up to the engine budget, and on drain both
dimensions shrink — free pages and empty slots past a ``pool_high_water``
hysteresis of the ladder rung actually needed are released from the
device (``batched.resize_pool_state``). Page/slot ids are stable, so only
all-free *tails* can be released; the low-id-first free-list policy
steers occupancy toward low ids.

Every lane advances whole passes per step, so job progress is tracked
host-side (``JobState.passes_done``) and the step loop never reads device
memory: kernels queue on the card's stream, and the engine syncs only when
a job finishes (its exact final objective). A plan's tables go to the card
once, when the plan is built, and every later step re-sends the same
device tensors; with ``sanitize=True`` every step runs under
``analysis.sanitize.sync_guard`` and only the harvest and snapshot
read-backs are allowed to sync.

Durable state, as in the reference: with ``checkpoint_dir`` the engine cuts
whole-state snapshots (every pool's tensors plus a JSON aux sidecar holding
the job table, the queue and the page tables) every ``ckpt_every`` steps;
with ``journal_every`` as well, client inputs (submit, cancel, fetched,
expire) are appended to a journal the moment they happen and snapshots
become rare bases cut every ``journal_every`` steps. ``SolveEngine.resume``
rebuilds an engine from the newest committed base and replays the journal
after it; the resumed run's results equal the uninterrupted run's bit for
bit. The directory layout and the aux are the reference's, so either
package's ``fsck`` checks the other's directories.

Not ported yet, each raising ``NotImplementedError`` that names the
ROADMAP item bringing it: sharded pools (``devices > 1``), spanning lanes
(``span_pages``) and resuming a snapshot cut on more than one device
(queue 1 item 10).
"""
# repro: hot-path — engine step loop; the harvest read-back is the designed sync point
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.abo import ABOConfig
from repro_torch.device import resolve_device
from repro_torch.engine import batched
from repro_torch.engine.faults import resolve_faults
from repro_torch.engine.jobs import (CANCELLED, DONE, FAILED, J_CANCEL,
                                     J_EXPIRE, J_FETCHED, J_SUBMIT, QUEUED,
                                     RUNNING, JobSpec, JobState, next_job_id)
from repro_torch.objectives import OBJECTIVES
from repro_torch.objectives.base import SeparableObjective
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.roofline import plan_pass_bytes
from repro_torch.obs.trace import Tracer

# shared no-op context: sanitize-mode hooks cost one attribute check and
# this reusable nullcontext when the mode is off — no allocation per step
_NULL = contextlib.nullcontext()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1, "
        f"{item})")


class AdmissionError(RuntimeError):
    """Typed submit() rejection (backpressure, not malformed input — a
    RuntimeError subclass so wire front-ends can keep mapping ValueError
    to 400 while these map to 429/503)."""


class QueueFullError(AdmissionError):
    """submit() rejected: the bounded queue is at max_queue."""


class MemoryBudgetError(AdmissionError):
    """submit() rejected: admitting the job would push projected pool
    device bytes past memory_budget_bytes."""


@dataclasses.dataclass
class _SweepRun:
    """One contiguous band of block rows sharing a width rung: the plan
    tables one band loop of the fused step consumes (device int64)."""

    w: int                   # width rung (lanes gathered per row)
    r_cap: int               # row-count rung (table length)
    n_rows: int              # rows actually executed (<= r_cap)
    lanes: torch.Tensor      # (r_cap, w) lane-slot ids (scratch-padded)
    pages: torch.Tensor      # (r_cap, w) page ids (scratch-padded)
    rows: torch.Tensor       # (r_cap, w) block-row numbers
    live_slots: int          # true (lane, row) pairs in the band
    swept_slots: int         # executed slots incl. width-rung padding


@dataclasses.dataclass
class _SyncGroup:
    """All active lanes gathered at one page-count rung: the end-of-pass
    lane sync inside the fused step."""

    g: int                   # page-count rung (gathered row view, pages)
    v: int                   # lane-batch rung
    lanes: torch.Tensor      # (v,) lane-slot ids (scratch-padded)
    pages: torch.Tensor      # (v, g) page ids (scratch-padded)


@dataclasses.dataclass
class _Plan:
    runs: list[_SweepRun]
    sync: _SyncGroup | None
    live_slots: int          # per-pass true block rows
    swept_slots: int         # per-pass executed block rows
    # the dispatch-ready argument list (band tables, sync tables), built
    # ONCE at plan time: steady-state stepping re-sends the same device
    # tensors every fused step instead of re-uploading host indices
    args: list = dataclasses.field(default_factory=list)
    # analytic bytes one pass of this plan moves (obs.roofline), from plan
    # shapes at build time — never a device read
    pass_bytes: int = 0

    @property
    def row_steps(self) -> int:
        """Row steps one pass of this plan runs (each a gather-commit-
        scatter over its band's width)."""
        return sum(r.n_rows for r in self.runs)

    def signature(self) -> tuple:
        """The shape of this plan: band + sync rungs only."""
        return (tuple((r.w, r.r_cap) for r in self.runs),
                (self.sync.g, self.sync.v))


def _gather_tables(entries: list[tuple[int, list[int]]], scratch_lane: int):
    """Scratch-padded gather tables for a batch of lanes.

    ``entries`` is ``[(slot, page_ids), ...]``. Returns the page-count
    rung ``g`` (the deepest member's), the lane-batch rung ``v``, and the
    (v,) / (v, g) lane/page index arrays — ladder padding targets the
    scratch slot/page, so sync and finalize share one padding
    convention."""
    g = batched.pad_ladder(max(len(pt) for _, pt in entries), 1)
    v = batched.pad_ladder(len(entries), 1)
    lanes_np = np.full((v,), scratch_lane, np.int64)
    pages_np = np.full((v, g), batched.SCRATCH_PAGE, np.int64)
    for i, (slot, pt) in enumerate(entries):
        lanes_np[i] = slot
        pages_np[i, : len(pt)] = pt
    return g, v, lanes_np, pages_np


@dataclasses.dataclass
class LanePool:
    """One family's lanes: shared page pool + host-side page tables.

    ``slots`` (the per-slot array height) is sized to this family's
    observed concurrency, not the engine budget: it starts at zero, grows
    on the count ladder as admissions demand (capped at ``lanes``), and
    shrinks back on drain past the ``high_water`` hysteresis — as does the
    page capacity. ``high_water=None`` disables shrinking."""

    key: tuple
    obj: SeparableObjective
    lanes: int                                   # engine budget = slot cap
    device: torch.device
    slots: int = 0                               # current lane-slot count
    high_water: float | None = 2.0               # shrink hysteresis factor
    state: batched.PoolState | None = None       # materialized on first use
    capacity: int = 1                            # pages incl. scratch page 0
    job_ids: list[str | None] = dataclasses.field(default_factory=list)
    page_table: list[list[int] | None] = dataclasses.field(
        default_factory=list)
    free_pages: list[int] = dataclasses.field(default_factory=list)
    plan: _Plan | None = None                    # rebuilt when lanes change

    def __post_init__(self):
        if not self.job_ids:
            self.job_ids = [None] * self.slots
        if not self.page_table:
            self.page_table = [None] * self.slots

    @property
    def active(self) -> int:
        return sum(j is not None for j in self.job_ids)

    def free_slot(self) -> int | None:
        for i, j in enumerate(self.job_ids):
            if j is None:
                return i
        return None

    def take_slot(self) -> int:
        """A free slot, growing the ladder-sized slot plan when all are
        occupied (the device arrays resize lazily in :meth:`materialize`).
        Callers gate admission on the engine-wide lane budget, so growth
        never exceeds ``lanes``."""
        slot = self.free_slot()
        if slot is not None:
            return slot
        new = min(batched.pad_ladder(self.slots + 1, 1), self.lanes)
        assert new > self.slots, "slot budget exhausted"
        self.job_ids += [None] * (new - self.slots)
        self.page_table += [None] * (new - self.slots)
        self.slots = new
        self.plan = None
        return self.free_slot()

    def alloc_pages(self, count: int) -> list[int]:
        """Take ``count`` page ids, growing the capacity plan onto the next
        ladder rung when the free list runs short (the device arrays
        resize lazily in :meth:`materialize`)."""
        if len(self.free_pages) < count:
            new = batched.pad_ladder(
                self.capacity + count - len(self.free_pages), 1)
            self.free_pages.extend(range(self.capacity, new))
            self.capacity = new
        pages = self.free_pages[:count]
        self.free_pages = self.free_pages[count:]
        return pages

    def release_pages(self, pages: list[int]):
        self.free_pages.extend(pages)
        self.free_pages.sort()               # deterministic reassignment

    def materialize(self) -> bool:
        """Reconcile the device state to the host plan (slots, capacity)
        — growing OR shrinking; a no-op when shapes already match.
        Returns True when the device tensors actually changed."""
        if self.state is None:
            self.state = batched.zeros_pool_state(
                self.obj, self.key, self.slots, self.capacity, self.device)
            return True
        new = batched.resize_pool_state(self.state, self.slots,
                                        self.capacity)
        changed = new is not self.state
        self.state = new
        return changed

    def shrink_to_fit(self) -> bool:
        """Release free capacity past the high-water hysteresis. Called
        after lanes drain: if the current slot count / page capacity
        exceeds ``high_water ×`` the ladder rung covering the highest
        occupied slot / used page, the all-free tail is cut and the device
        tensors resized immediately. Only tails can go (ids are stable).
        Returns True when device tensors were actually resized."""
        if self.high_water is None or self.state is None:
            return False
        top = max((i for i, j in enumerate(self.job_ids) if j is not None),
                  default=-1)
        slot_target = min(batched.pad_ladder(max(top + 1, 1), 1), self.lanes)
        if slot_target < self.slots and self.slots > self.high_water \
                * slot_target:
            del self.job_ids[slot_target:]
            del self.page_table[slot_target:]
            self.slots = slot_target
            self.plan = None
        used_top = batched.SCRATCH_PAGE
        for jid, pt in zip(self.job_ids, self.page_table):
            if jid is not None and pt:
                used_top = max(used_top, max(pt))
        target = batched.pad_ladder(used_top + 1, 1)
        if target < self.capacity and self.capacity > self.high_water \
                * target:
            self.capacity = target
            self.free_pages = [p for p in self.free_pages if p < target]
            self.plan = None
        return self.materialize()

    def device_bytes(self) -> int:
        """Bytes the pool's device tensors hold (0 if unmaterialized)."""
        return 0 if self.state is None else self.state.nbytes()

    # ------------------------------------------------------------- planning
    @staticmethod
    def _bands_np(active, scratch: int):
        """Numpy band tables for the active lanes ``[(slot, pages), ...]``:
        a list of ``{w, nb, lanes, pages, rows, live}`` dicts with
        ``(nb, w)`` arrays, width already on its rung, rows NOT yet padded
        to a row-count rung.

        Construction is array-at-once, as the reference's: lanes sort by
        depth (descending, slot-ascending ties), so the lanes occupying
        row r are exactly the first ``count(r)`` of that order and every
        band's tables are numpy slices of one (lane, row) page matrix — no
        host loop over block rows."""
        if not active:
            return []
        n_act = len(active)
        depths = np.fromiter((len(pt) for _, pt in active), np.int64, n_act)
        order = np.lexsort((np.arange(n_act), -depths))
        slots_arr = np.fromiter((s for s, _ in active), np.int64,
                                n_act)[order]
        max_rows = int(depths.max())
        pages_mat = np.full((n_act, max_rows), batched.SCRATCH_PAGE,
                            np.int64)
        for i, oi in enumerate(order):
            pt = active[oi][1]
            pages_mat[i, : len(pt)] = pt
        rows_mat = np.broadcast_to(np.arange(max_rows, dtype=np.int64),
                                   (n_act, max_rows))

        # lanes occupying row r (non-increasing), its width rung, and the
        # maximal contiguous runs of equal rung = the bands
        rows_idx = np.arange(max_rows)
        counts = n_act - np.searchsorted(np.sort(depths), rows_idx,
                                         side="right")
        rung_lut = np.array([0] + [batched.pad_ladder(c, 1)
                                   for c in range(1, n_act + 1)], np.int64)
        rungs = rung_lut[counts]
        starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(rungs)) + 1, [max_rows]])

        bands = []
        for r0, r1 in zip(starts[:-1], starts[1:]):
            r0, r1 = int(r0), int(r1)
            w_rung = int(rungs[r0])
            nb = r1 - r0
            cmax = int(counts[r0])           # counts peak at the band head
            colmask = np.arange(cmax)[None, :] < counts[r0:r1, None]
            lanes_np = np.full((nb, w_rung), scratch, np.int64)
            pages_np = np.full((nb, w_rung), batched.SCRATCH_PAGE, np.int64)
            rows_np = np.zeros((nb, w_rung), np.int64)
            lanes_np[:, :cmax] = np.where(
                colmask, slots_arr[None, :cmax], scratch)
            pages_np[:, :cmax] = np.where(
                colmask, pages_mat[:cmax, r0:r1].T, batched.SCRATCH_PAGE)
            rows_np[:, :cmax] = np.where(colmask, rows_mat[:cmax, r0:r1].T, 0)
            bands.append({"w": w_rung, "nb": nb, "lanes": lanes_np,
                          "pages": pages_np, "rows": rows_np,
                          "live": int(counts[r0:r1].sum())})
        return bands

    def build_plan(self) -> _Plan:
        """Row-compacted sweep plan for the current lane occupancy.

        The number of lanes occupying row r is non-increasing in r, so rows
        sharing a width rung are contiguous; the bands run in ascending-row
        order (descending width), preserving the Gauss-Seidel block order
        within every lane. Ladder padding (width and row-count rungs)
        points at the scratch lane/page. The tables go to the device here,
        once; every step of this plan re-sends them."""
        active = [(slot, pt) for slot, (jid, pt)
                  in enumerate(zip(self.job_ids, self.page_table))
                  if jid is not None]
        if not active:
            return _Plan([], None, 0, 0)
        scratch = self.slots
        dev = self.device
        runs = []
        live = swept = 0
        for b in self._bands_np(active, scratch):
            nb, w_rung = b["nb"], b["w"]
            r_cap = batched.pad_ladder(nb, 1)

            def pad(a, fill):
                out = np.full((r_cap, w_rung), fill, np.int64)
                out[:nb] = a
                return batched.upload(out, dev)

            live += b["live"]
            swept += nb * w_rung
            runs.append(_SweepRun(
                w=w_rung, r_cap=r_cap, n_rows=nb,
                lanes=pad(b["lanes"], scratch),
                pages=pad(b["pages"], batched.SCRATCH_PAGE),
                rows=pad(b["rows"], 0),
                live_slots=b["live"], swept_slots=nb * w_rung))

        # one gather shape for every active lane: the deepest lane's
        # page-count rung (short lanes read scratch zeros past their
        # pages — masked out)
        g, v, lanes_np, pages_np = _gather_tables(active, scratch)
        sync = _SyncGroup(g=g, v=v, lanes=batched.upload(lanes_np, dev),
                          pages=batched.upload(pages_np, dev))
        plan = _Plan(runs, sync, live, swept)
        for r in plan.runs:
            plan.args += [r.lanes, r.pages, r.rows, r.n_rows]
        plan.args += [sync.lanes, sync.pages]
        plan.pass_bytes = plan_pass_bytes(
            plan, batched.key_config(self.key).block_size,
            batched.key_dtype(self.key).itemsize)
        return plan


class SolveEngine:
    """Serve many concurrent ABO jobs through shared paged sweeps.

    Usage::

        eng = SolveEngine(lanes=8)            # the card; device="cpu" here
        jid = eng.submit(JobSpec("griewank", 1000, seed=0))
        eng.run()                  # or step() from your own loop
        res = eng.result(jid)      # an ABOResult, same as abo_minimize's
    """

    def __init__(self, *, lanes: int = 8, dtype: Any = torch.float32,
                 objectives: dict[str, SeparableObjective] | None = None,
                 checkpoint_dir: str | None = None, ckpt_every: int = 1,
                 keep: int = 3, max_fuse: int | None = None,
                 retain_done: int | None = None,
                 pool_high_water: float | None = 2.0,
                 journal_every: int | None = None,
                 devices: int | None = None,
                 sanitize: bool = False,
                 faults=None,
                 max_queue: int | None = None,
                 memory_budget_bytes: int | None = None,
                 span_pages: int | None = None,
                 device=None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if memory_budget_bytes is not None and memory_budget_bytes < 1:
            raise ValueError("memory_budget_bytes must be >= 1, got "
                             f"{memory_budget_bytes}")
        if devices is not None and devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if retain_done is not None and retain_done < 0:
            raise ValueError(
                f"retain_done must be >= 0 or None, got {retain_done}")
        if pool_high_water is not None and pool_high_water < 1.0:
            raise ValueError(
                "pool_high_water must be >= 1 or None (never shrink), got "
                f"{pool_high_water}: shrinking below the rung actually "
                "needed would thrash resize every admission")
        if journal_every is not None:
            if journal_every < 1:
                raise ValueError(
                    f"journal_every must be >= 1, got {journal_every}")
            if checkpoint_dir is None:
                raise ValueError(
                    "journal_every needs a checkpoint_dir: the journal is "
                    "an incremental layer over base snapshots, not a "
                    "replacement for them")
        if devices is not None and devices > 1:
            raise _not_ported("sharded pools (devices > 1)",
                              "item 10, multi-device")
        if span_pages is not None:
            raise _not_ported("spanning lanes (span_pages)",
                              "item 10, multi-device")
        self.n_dev = 1
        self.device = resolve_device(device)
        self.lanes = lanes
        # cap on passes fused into one step (None = whole generations); 1
        # is strict pass-per-step stepping, the finest refill granularity
        self.max_fuse = max_fuse
        # keep at most this many delivered/cancelled job records; None
        # keeps everything (see _gc_jobs)
        self.retain_done = retain_done
        # elastic-pool shrink hysteresis (None = retain capacity forever)
        self.pool_high_water = pool_high_water
        # base-snapshot cadence in journal mode (None = whole-state
        # snapshots every ckpt_every steps)
        self.journal_every = journal_every
        # suppresses re-journaling while replaying journal records
        self._replaying = False
        # runtime sanitizer mode (analysis.sanitize): step() runs under
        # sync_guard (any host sync outside the harvest read-back raises)
        # and each fused step asserts it updated the pool in place
        self.sanitize = bool(sanitize)
        # fault injection (engine.faults): off by default, the null
        # registry — every failpoint costs one dict .get miss
        self.faults = resolve_faults(faults)
        # admission control: bounded queue + projected-memory shedding
        self.max_queue = max_queue
        self.memory_budget_bytes = memory_budget_bytes
        self.dtype = dtype
        self.objectives = dict(objectives or OBJECTIVES)
        self.jobs: dict[str, JobState] = {}
        self.queue: deque[str] = deque()
        self.pools: dict[tuple, LanePool] = {}
        # every family this engine ever opened a pool for
        self.family_keys_seen: set[tuple] = set()
        self.step_count = 0
        # cumulative row-sweep slot accounting (see pad_stats)
        self.swept_slots = 0
        self.swept_slots_live = 0
        # cumulative row steps (gather-commit-scatter rounds), host-counted
        self.row_steps = 0
        self._next = 0
        self._done_seq = 0
        # telemetry (obs/): registry + tracer are always present; the
        # tracer is disabled (null spans) until trace()/--trace enables it
        self.metrics = MetricsRegistry()
        self.tracer = Tracer()
        m = self.metrics
        self._c_steps = m.counter(
            "engine_steps_total", "engine step() calls")
        self._c_passes = m.counter(
            "engine_passes_total", "fused ABO passes dispatched, summed "
            "over pools (r per dispatch)")
        self._c_submitted = m.counter(
            "engine_jobs_submitted_total", "jobs accepted by submit()")
        self._c_done = m.counter(
            "engine_jobs_done_total", "jobs finished")
        self._c_cancelled = m.counter(
            "engine_jobs_cancelled_total", "jobs cancelled")
        self._c_failed = m.counter(
            "engine_jobs_failed_total", "jobs terminally FAILED "
            "(quarantined non-finite results, TTL expiry)")
        self._c_rej_queue = m.counter(
            "engine_admission_rejected_total", "submissions rejected by "
            "admission control", reason="queue_full")
        self._c_rej_mem = m.counter(
            "engine_admission_rejected_total", "submissions rejected by "
            "admission control", reason="memory_budget")
        self._c_plan_builds = m.counter(
            "engine_plan_builds_total", "sweep-plan rebuilds (occupancy "
            "changes)")
        self._c_resizes = m.counter(
            "engine_pool_resizes_total", "device pool resizes "
            "(grow or shrink)")
        self._c_pages_alloc = m.counter(
            "engine_pages_allocated_total", "pool pages bound to lanes")
        self._c_pages_freed = m.counter(
            "engine_pages_released_total", "pool pages returned to the "
            "free lists")
        self._c_est_bytes = m.counter(
            "engine_est_bytes_moved_total", "analytic device-memory bytes "
            "moved by dispatched sweeps (obs.roofline model)")
        self._h_queued = m.histogram(
            "engine_job_queued_seconds", "submit -> placed on a lane")
        self._h_run = m.histogram(
            "engine_job_run_seconds", "placed -> done")
        self._h_total = m.histogram(
            "engine_job_total_seconds", "submit -> done")
        self._h_fetch = m.histogram(
            "engine_job_fetch_seconds", "done -> first result fetch")
        self.faults.bind_metrics(self.metrics)
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=keep,
                                       metrics=self.metrics,
                                       faults=self.faults)
                     if checkpoint_dir else None)
        self.ckpt_every = max(ckpt_every, 1)

    # ------------------------------------------------------------- client API
    def _journal(self, kind: str, job_id: str, **fields):
        """Append a client-input record to the checkpoint journal (no-op
        outside journal mode, and while replaying — a replayed event is
        already durable in the segments being replayed)."""
        if self.ckpt is not None and self.journal_every is not None \
                and not self._replaying:
            self.ckpt.journal_append([{"t": kind, "job_id": job_id,
                                       **fields}])

    def _agg_dtype_name(self, spec: JobSpec) -> str:
        """The dtype name of a job's aggregates: its family's."""
        key = batched.family_key(spec.objective, spec.n, spec.config,
                                 self.dtype)
        return batched.dtype_name(batched.key_agg_dtype(key))

    def _new_job(self, job_id: str, spec: JobSpec, **kw) -> JobState:
        return JobState(job_id=job_id, spec=spec,
                        agg_dtype=self._agg_dtype_name(spec), **kw)

    def _projected_job_bytes(self, spec: JobSpec) -> int:
        """Device bytes one lane of this spec adds to its family pool: its
        pages plus one slot row, from shapes only — admission allocates
        nothing."""
        key = batched.family_key(spec.objective, spec.n, spec.config,
                                 self.dtype)
        cfg = batched.key_config(key)
        pages = batched.pages_for(spec.n, cfg.block_size)
        obj = self.objectives[spec.objective]
        agg = batched.key_agg_dtype(key).itemsize
        slot_row = (obj.n_aggs + cfg.n_passes) * agg + 2 * 4
        return (pages * cfg.block_size * batched.key_dtype(key).itemsize
                + slot_row)

    def _admit(self, spec: JobSpec):
        """Backpressure gate: raises a typed AdmissionError instead of
        letting an overloaded engine queue without bound."""
        if self.max_queue is not None:
            depth = sum(j in self.jobs and self.jobs[j].status == QUEUED
                        for j in self.queue)
            if depth >= self.max_queue:
                self._c_rej_queue.inc()
                raise QueueFullError(
                    f"queue full: {depth} queued jobs >= max_queue="
                    f"{self.max_queue}")
        if self.memory_budget_bytes is not None:
            # project the whole admitted-but-unplaced backlog, not just
            # the live pools: admission is the only gate
            projected = self.memory_stats()["pool_device_bytes"]
            for j in self.queue:
                rec = self.jobs.get(j)
                if rec is not None and rec.status == QUEUED:
                    projected += self._projected_job_bytes(rec.spec)
            projected += self._projected_job_bytes(spec)
            if projected > self.memory_budget_bytes:
                self._c_rej_mem.inc()
                raise MemoryBudgetError(
                    f"memory budget: projected pool bytes {projected} > "
                    f"memory_budget_bytes={self.memory_budget_bytes}")

    def submit(self, spec: JobSpec) -> str:
        if spec.objective not in self.objectives:
            raise KeyError(
                f"unknown objective {spec.objective!r}; registered: "
                f"{sorted(self.objectives)}")
        if spec.config.use_kernel:
            raise ValueError(
                "use_kernel=True is not supported by the engine: lane "
                "pools sweep through the paged tensor path only (the CUDA "
                "sweep kernel carries its aggregates through one whole "
                "solution vector, which paged pool lanes do not have); run "
                "kernel configs through abo_minimize directly")
        self._admit(spec)
        job_id = next_job_id(self._next)
        self._next += 1
        self.jobs[job_id] = self._new_job(job_id, spec, t_submit=time.time())
        self.queue.append(job_id)
        self._c_submitted.inc()
        self._journal(J_SUBMIT, job_id, spec=spec.to_dict())
        return job_id

    def poll(self, job_id: str) -> dict:
        return self.jobs[job_id].poll_dict()

    def result(self, job_id: str):
        rec = self.jobs[job_id]
        first = rec.status == DONE and not rec.fetched
        out = rec.result()               # raises unless DONE; marks fetched
        if first:
            self._mark_fetch_time(rec)
            self._journal(J_FETCHED, job_id)
            self._gc_jobs()              # delivery can trigger eviction NOW
        return out

    def mark_fetched(self, job_id: str):
        """Record that a DONE result was delivered out-of-band (a wire
        front-end confirming its reply went out): snapshots stop carrying
        x, the journal remembers across kills, and the retention GC may
        evict the record immediately."""
        rec = self.jobs.get(job_id)
        if rec is not None and rec.status == DONE and not rec.fetched:
            rec.fetched = True
            self._mark_fetch_time(rec)
            self._journal(J_FETCHED, job_id)
            self._gc_jobs()

    def _mark_fetch_time(self, rec: JobState):
        if rec.t_fetch is None:
            rec.t_fetch = time.time()
            if rec.t_done is not None:
                self._h_fetch.observe(rec.t_fetch - rec.t_done)

    def cancel(self, job_id: str) -> bool:
        rec = self.jobs[job_id]
        if rec.status == QUEUED:
            rec.status = CANCELLED
            rec.done_seq = self._next_done_seq()
            self._c_cancelled.inc()
            try:                         # purge now, not at the next refill
                self.queue.remove(job_id)
            except ValueError:
                pass
            self._journal(J_CANCEL, job_id)
            self._gc_jobs()              # retention may evict it right away
            return True
        if rec.status == RUNNING:
            pool, slot = self._locate(job_id)
            if pool is not None:
                self._release_lane(pool, slot)
                pool.shrink_to_fit()
            rec.status = CANCELLED       # stale device state is benign: the
            rec.done_seq = self._next_done_seq()   # slot leaves every plan
            self._c_cancelled.inc()
            self._journal(J_CANCEL, job_id)
            self._gc_jobs()
            return True
        return False                     # already DONE/CANCELLED/FAILED

    # --------------------------------------------------------------- stepping
    @property
    def active_lanes(self) -> int:
        return sum(p.active for p in self.pools.values())

    def pending(self) -> bool:
        return self.active_lanes > 0 or any(
            j in self.jobs and self.jobs[j].status == QUEUED
            for j in self.queue)

    def step(self) -> int:
        """Refill idle lanes, advance every active pool by one fused chunk
        of passes, harvest finished lanes. Returns the number of jobs
        completed (DONE or FAILED).

        Per active pool the chunk is ``r = min`` remaining passes over its
        lanes — a full generation when lanes are phase-aligned, one pass
        when a fresh job rides alongside nearly-finished ones. No lane
        overshoots its job's pass budget, so per-job math is untouched.

        In sanitize mode the whole step runs under
        ``analysis.sanitize.sync_guard``: any host sync outside the
        harvest read-back raises ``HostSyncError`` (or, on the card,
        CUDA's sync-debug error), and each fused step asserts it updated
        the pool in place."""
        if self.sanitize:
            with _sanitize.sync_guard():
                return self._step_impl()
        return self._step_impl()

    def _allowed(self, reason: str):
        """Context manager marking a designed sync point (no-op unless
        sanitize mode is on)."""
        return _sanitize.allowed_sync(reason) if self.sanitize else _NULL

    def _step_impl(self) -> int:
        tr = self.tracer
        with tr.span("step", step=self.step_count) as step_sp:
            with tr.span("refill"):
                self._refill()
            finished = 0
            for pool in self.pools.values():
                if pool.active == 0:
                    # idle families still release capacity: a pool that
                    # drained while OTHER families had queued work skipped
                    # the harvest-time shrink
                    with tr.span("resize", family=pool.key[0]) as sp:
                        resized = pool.shrink_to_fit()
                        sp.set(resized=resized)
                    if resized:
                        self._c_resizes.inc()
                    continue
                ops = batched.get_pool_ops(pool.obj, pool.key, self.device)
                cfg = batched.key_config(pool.key)
                remaining = [cfg.n_passes - self.jobs[j].passes_done
                             for j in pool.job_ids if j is not None]
                r = max(min(remaining), 1)
                if self.max_fuse is not None:
                    r = min(r, self.max_fuse)
                if pool.plan is None:
                    with tr.span("plan_build", family=pool.key[0],
                                 active=pool.active):
                        pool.plan = pool.build_plan()
                    self._c_plan_builds.inc()
                plan = pool.plan
                # failpoint: a fault armed here raises/kills BEFORE the
                # step, so pool state is never half-stepped
                self.faults.trip("fused_step")
                # the fused_sweep span measures the host's enqueue of the
                # step's kernels, not device completion: waiting would be
                # a sync
                with tr.span("fused_sweep", family=pool.key[0], passes=r,
                             swept_rows=plan.swept_slots,
                             est_bytes=r * plan.pass_bytes):
                    before = (_sanitize.storage_ptrs(pool.state.tensors())
                              if self.sanitize else None)
                    pool.state = ops.fused_step(pool.state, r, *plan.args)
                    if self.sanitize:
                        _sanitize.assert_donated(
                            before, pool.state.tensors(),
                            f"fused_step state ({pool.key[0]})")
                self.swept_slots += r * plan.swept_slots
                self.swept_slots_live += r * plan.live_slots
                self.row_steps += r * plan.row_steps
                self._c_passes.inc(r)
                self._c_est_bytes.inc(r * plan.pass_bytes)
                for job_id in pool.job_ids:
                    if job_id is not None:
                        self.jobs[job_id].passes_done += r
                with tr.span("harvest", family=pool.key[0]) as sp:
                    got = self._harvest(pool, ops)
                    sp.set(finished=got)
                finished += got
            self.step_count += 1
            self._c_steps.inc()
            self._gc_jobs()
            if self.ckpt is not None:
                # journal mode: snapshots are rare BASES; the journal holds
                # every client input since the last one, so a kill between
                # bases re-derives everything (re-running post-base passes)
                every = (self.journal_every if self.journal_every is not None
                         else self.ckpt_every)
                if self.step_count % every == 0:
                    with tr.span("snapshot", step=self.step_count):
                        self._snapshot()
            step_sp.set(finished=finished)
        return finished

    def run(self, max_steps: int | None = None, stop=None) -> int:
        """Drain the queue. Returns total jobs completed (DONE + FAILED
        finishers). ``stop`` is an optional zero-arg callable polled
        between steps."""
        done = 0
        while self.pending():
            if stop is not None and stop():
                break
            done += self.step()
            if max_steps is not None and self.step_count >= max_steps:
                break
        return done

    def submit_many(self, specs: Iterable[JobSpec]) -> list[str]:
        return [self.submit(s) for s in specs]

    # -------------------------------------------------------------- internals
    def _locate(self, job_id: str) -> tuple[LanePool | None, int]:
        for pool in self.pools.values():
            if job_id in pool.job_ids:
                return pool, pool.job_ids.index(job_id)
        return None, -1

    def _release_lane(self, pool: LanePool, slot: int):
        pool.job_ids[slot] = None
        if pool.page_table[slot]:
            self._c_pages_freed.inc(len(pool.page_table[slot]))
            pool.release_pages(pool.page_table[slot])
        pool.page_table[slot] = None
        pool.plan = None

    def _next_done_seq(self) -> int:
        seq = self._done_seq
        self._done_seq += 1
        return seq

    def _refill(self):
        # Stage lane bindings + page allocations first (growing each pool's
        # capacity plan at most once), then write every pool's new lanes
        staged: dict[tuple, list[tuple[int, JobState]]] = {}
        while self.queue and self.active_lanes < self.lanes:
            job_id = self.queue.popleft()
            rec = self.jobs.get(job_id)
            if rec is None or rec.status != QUEUED:  # cancelled / GC'd
                continue
            if rec.spec.ttl_s is not None and rec.t_submit is not None \
                    and time.time() - rec.t_submit > rec.spec.ttl_s:
                self._expire(rec)        # deadline passed while queued
                continue
            spec = rec.spec
            key = batched.family_key(spec.objective, spec.n, spec.config,
                                     self.dtype)
            pool = self.pools.get(key)
            if pool is None:
                pool = LanePool(key=key, obj=self.objectives[spec.objective],
                                lanes=self.lanes, device=self.device,
                                high_water=self.pool_high_water)
                self.pools[key] = pool
                self.family_keys_seen.add(key)
            slot = pool.take_slot()
            cfg = batched.key_config(key)
            pool.job_ids[slot] = rec.job_id
            pool.page_table[slot] = pool.alloc_pages(
                batched.pages_for(spec.n, cfg.block_size))
            self._c_pages_alloc.inc(len(pool.page_table[slot]))
            pool.plan = None
            rec.passes_done = 0
            rec.status = RUNNING
            rec.t_place = time.time()
            if rec.t_submit is not None:
                self._h_queued.observe(rec.t_place - rec.t_submit)
            staged.setdefault(key, []).append((slot, rec))
        for key, placed in staged.items():
            pool = self.pools[key]
            # failpoint: fires before materialize, a crash inside a resize
            self.faults.trip("pool_resize")
            with self.tracer.span("resize", family=key[0]) as sp:
                resized = pool.materialize()
                sp.set(resized=resized)
            if resized:
                self._c_resizes.inc()
            ops = batched.get_pool_ops(pool.obj, key, self.device)
            self._place(pool, ops, placed)
            if self.faults:
                # objective_eval poison: decided per JOB (keyed off the job
                # id, not a process-local hit counter)
                poisoned = []
                for slot, rec in placed:
                    f = self.faults.check("objective_eval", key=rec.job_id)
                    if f is not None:
                        f.execute(rec.job_id)   # returns for kind=poison
                        poisoned.append((slot, rec))
                for slot, rec in poisoned:
                    self._place_row(pool, ops, slot, rec.spec.n,
                                    np.full((rec.spec.n,), np.nan))

    def _expire(self, rec: JobState):
        """TTL expiry: terminal FAILED. Wall-clock decided, so the verdict
        is journaled (J_EXPIRE): replay re-applies it instead of re-reading
        a clock that has moved."""
        rec.status = FAILED
        rec.error = f"ttl expired: queued longer than {rec.spec.ttl_s}s"
        rec.done_seq = self._next_done_seq()
        rec.t_done = time.time()
        self._c_failed.inc()
        self._journal(J_EXPIRE, rec.job_id, error=rec.error)

    def _place_row(self, pool: LanePool, ops: batched.PoolOps, slot: int,
                   n: int, x_true):
        """Write an explicit row — a job's x0, or the NaN of an injected
        ``objective_eval`` poison — through ``place_x``. Only the lane's
        true n coordinates take it; the rest stay zero, so padding writes
        keep the shared scratch page exactly zero."""
        pages = pool.page_table[slot]
        bsz = batched.key_config(pool.key).block_size
        xrow = np.zeros((len(pages) * bsz,),
                        batched.dtype_name(pool.state.pool.dtype))
        xrow[:n] = x_true
        pool.state = ops.place_x(pool.state, slot, pages, xrow, n)

    def _place(self, pool: LanePool, ops: batched.PoolOps,
               placed: list[tuple[int, JobState]]):
        members = [(s, pool.page_table[s], r.spec.seed, r.spec.n)
                   for s, r in placed if r.spec.x0 is None]
        if members:                      # one call for the refill batch
            pool.state = ops.place(pool.state, members)
        for slot, rec in placed:         # explicit-x0 jobs: rare, per lane
            if rec.spec.x0 is not None:
                self._place_row(pool, ops, slot, rec.spec.n, rec.spec.x0)

    # repro: allow[RPR001] harvest is THE designed sync point: finished
    # lanes' fun/x/history are read back exactly once, off the hot loop
    def _harvest(self, pool: LanePool, ops: batched.PoolOps) -> int:
        cfg = batched.key_config(pool.key)
        fins = [(slot, self.jobs[jid])
                for slot, jid in enumerate(pool.job_ids)
                if jid is not None
                and self.jobs[jid].passes_done >= cfg.n_passes]
        if not fins:
            return 0
        # compact gather: ONE call + one device sync for the FINISHING
        # lanes only — running and idle lanes aren't touched
        _, _, lanes_np, pages_np = _gather_tables(
            [(s, pool.page_table[s]) for s, _ in fins], pool.slots)
        f_all, x_all, hist_all = ops.finalize(
            pool.state, batched.upload(lanes_np, self.device),
            batched.upload(pages_np, self.device))
        with self._allowed("harvest read-back"):
            f_np, x_np, h_np = (f_all.cpu().numpy(), x_all.cpu().numpy(),
                                hist_all.cpu().numpy())
        now = time.time()
        n_done = 0
        for i, (slot, rec) in enumerate(fins):
            fun = float(f_np[i])
            x = x_np[i, : rec.spec.n]
            # quarantine: a non-finite fun/x is terminal FAILED, decided
            # on the buffers the harvest already read back — no extra sync
            if not (np.isfinite(fun) and np.isfinite(x).all()):
                rec.status = FAILED
                rec.error = ("non-finite result quarantined at harvest "
                             f"(fun={fun!r})")
                rec.fun = None
                rec.x = None
                rec.history = []
                self._c_failed.inc()
            else:
                rec.fun = fun
                rec.x = x.copy()
                rec.history = [float(vv) for vv in h_np[i]]
                rec.status = DONE
                n_done += 1
            rec.done_seq = self._next_done_seq()
            rec.t_done = now
            if rec.t_place is not None:
                self._h_run.observe(now - rec.t_place)
            if rec.t_submit is not None:
                self._h_total.observe(now - rec.t_submit)
            self._release_lane(pool, slot)       # refilled next step
        self._c_done.inc(n_done)
        if not self.queue:               # a true drain, not inter-generation
            if pool.shrink_to_fit():     # turnover mid-burst
                self._c_resizes.inc()
        return len(fins)

    def _gc_jobs(self):
        """Whole-record job-table GC: keep only the ``retain_done`` most
        recently finished records among those the client is done with
        (fetched DONE results, cancellations, failures). Live work is
        never evicted; evicted ids simply answer "unknown job"."""
        if self.retain_done is None:
            return
        evictable = [rec for rec in self.jobs.values()
                     if rec.status in (CANCELLED, FAILED)
                     or (rec.status == DONE and rec.fetched)]
        excess = len(evictable) - self.retain_done
        if excess <= 0:
            return
        evictable.sort(key=lambda r: (r.done_seq is not None,
                                      r.done_seq if r.done_seq is not None
                                      else 0))
        for rec in evictable[:excess]:
            del self.jobs[rec.job_id]

    def pad_stats(self) -> dict:
        """Packing economics of the paged layout: coordinate-level fill of
        the active lanes' pages, and the cumulative padded fraction of
        swept row slots (``swept_waste``)."""
        valid = paged = 0
        for pool in self.pools.values():
            bsz = batched.key_config(pool.key).block_size
            for jid, pt in zip(pool.job_ids, pool.page_table):
                if jid is not None:
                    valid += self.jobs[jid].spec.n
                    paged += len(pt) * bsz
        swept, live = self.swept_slots, self.swept_slots_live
        return {"active_valid_n": valid, "active_paged_n": paged,
                "fill_ratio": valid / paged if paged else None,
                "pad_waste": 1.0 - valid / paged if paged else None,
                "swept_rows": swept, "swept_rows_live": live,
                "swept_waste": 1.0 - live / swept if swept else None}

    def memory_stats(self) -> dict:
        """Elastic-pool footprint right now: materialized pages / lane
        slots across families and the device bytes they hold."""
        pages = slots = nbytes = 0
        for pool in self.pools.values():
            if pool.state is None:
                continue
            pages += pool.state.pool.shape[0]
            slots += pool.state.aggs.shape[0] - 1
            nbytes += pool.device_bytes()
        return {"pool_pages": pages, "pool_slots": slots,
                "pool_device_bytes": nbytes,
                "pool_high_water": self.pool_high_water,
                "devices": self.n_dev}

    # ------------------------------------------------------------- telemetry
    def trace(self, path: str | None = None):
        """Enable pass-level span tracing (``path`` becomes the default
        Chrome-trace export target for :meth:`trace_export`)."""
        self.tracer.enable(path)

    def trace_export(self, path: str | None = None) -> str:
        """Write recorded spans as Chrome trace-event JSON; returns the
        path written."""
        return self.tracer.export(path)

    def _refresh_gauges(self):
        """Sample O(pools) gauges into the registry — at stats/scrape
        boundaries only, never on the step path; host metadata only."""
        g = self.metrics.gauge
        queued = sum(j in self.jobs and self.jobs[j].status == QUEUED
                     for j in self.queue)
        g("engine_active_lanes", "lanes bound to running jobs").set(
            self.active_lanes)
        g("engine_lane_budget", "engine-wide concurrent-lane cap").set(
            self.lanes)
        g("engine_queue_depth", "truly-QUEUED jobs awaiting a lane").set(
            queued)
        g("engine_families", "live lane pools").set(len(self.pools))
        g("engine_families_created",
          "distinct pool families ever opened").set(
            len(self.family_keys_seen))
        g("engine_executables", "distinct pool shapes built").set(
            batched.compiled_executable_count(self.family_keys_seen))
        ps = self.pad_stats()
        g("engine_fill_ratio", "true n / paged n over active lanes").set(
            ps["fill_ratio"] or 0.0)
        g("engine_swept_waste_ratio",
          "padded fraction of cumulative swept rows").set(
            ps["swept_waste"] or 0.0)
        ms = self.memory_stats()
        g("engine_pool_pages", "materialized pool pages").set(
            ms["pool_pages"])
        g("engine_pool_slots", "materialized lane slots").set(
            ms["pool_slots"])
        g("engine_pool_device_bytes",
          "device bytes held by pool tensors").set(ms["pool_device_bytes"])
        # one device: no striped lanes, and the per-device census is the
        # whole pool (the reference's keys, so either engine's stats read
        # the same)
        g("engine_span_lanes", "lanes striped across the device mesh").set(0)
        g("engine_device_bytes", "resident pool bytes per device",
          device=0).set(ms["pool_device_bytes"])
        g("engine_device_pages", "local pool pages per device",
          device=0).set(ms["pool_pages"])
        if self.ckpt is not None and self.journal_every is not None:
            js = self.ckpt.journal_stats()
            g("ckpt_journal_segments", "live journal segment files").set(
                js["segments"])
            g("ckpt_journal_lag_records",
              "journal records not yet covered by a base snapshot").set(
                js["records"])
            g("ckpt_journal_bytes", "journal bytes on disk").set(
                js["bytes"])

    def stats(self) -> dict:
        """The canonical flat telemetry snapshot: every registry counter,
        gauge (freshly sampled), and histogram summary, keyed by metric
        name (labeled metrics render as ``name{k="v"}``)."""
        self._refresh_gauges()
        return self.metrics.snapshot()

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the registry (gauges freshly
        sampled)."""
        self._refresh_gauges()
        return self.metrics.render_prometheus()

    # ------------------------------------------------------------ checkpoint
    def snapshot(self):
        """Cut a checkpoint now (e.g. right after enqueueing a batch, so a
        kill before the first step's snapshot can't lose the queue)."""
        if self.ckpt is None:
            raise RuntimeError("engine has no checkpoint_dir")
        self._snapshot()

    def _snapshot(self):
        # the checkpoint writer reads every pool tensor back to the host:
        # with harvest, the only other designed sync point in a step
        with self._allowed("snapshot write-out"):
            return self._snapshot_impl()

    def _snapshot_impl(self):
        tree = {}
        pool_meta = []
        for i, pool in enumerate(self.pools.values()):
            pool.materialize()
            tree[f"p{i:03d}"] = pool.state
            pool_meta.append({
                "objective": pool.key[0],
                "config": dataclasses.asdict(pool.key[1]),
                "dtype": pool.key[2],
                "capacity": pool.capacity,
                "slots": pool.slots,
                "job_ids": pool.job_ids,
                "page_table": pool.page_table,
                # one device: every live lane lies whole on device 0 (the
                # reference's lane→device map at n_dev = 1)
                "n_dev": self.n_dev,
                "lane_dev": [None if pt is None else 0
                             for pt in pool.page_table],
            })
        # journal records at or below this seq are reflected in this
        # snapshot's job table; resume replays only what came after
        journal_seq = (self.ckpt.journal_last_seq()
                       if self.journal_every is not None else None)
        aux = {
            "version": 3,
            "lanes": self.lanes,
            "devices": self.n_dev,
            "max_fuse": self.max_fuse,
            "retain_done": self.retain_done,
            "pool_high_water": self.pool_high_water,
            "journal_every": self.journal_every,
            "max_queue": self.max_queue,
            "memory_budget_bytes": self.memory_budget_bytes,
            "span_pages": None,
            "journal_seq": journal_seq,
            "dtype": batched.dtype_name(self.dtype),
            "step_count": self.step_count,
            "swept_slots": self.swept_slots,
            "swept_slots_live": self.swept_slots_live,
            "next": self._next,
            "done_seq": self._done_seq,
            "queue": list(self.queue),
            "jobs": {jid: rec.to_dict() for jid, rec in self.jobs.items()},
            "pools": pool_meta,
            # pools can drain away before a snapshot; persist the whole
            # family history so families_created survives resume
            "family_keys_seen": [
                {"objective": k[0], "config": dataclasses.asdict(k[1]),
                 "dtype": k[2]}
                for k in sorted(self.family_keys_seen,
                                key=lambda k: (k[0], k[2]))],
        }
        self.ckpt.save(self.step_count, tree, aux=aux)
        if journal_seq is not None:
            # this base covers everything up to journal_seq: compaction
            self.ckpt.journal_truncate(journal_seq)

    @classmethod
    def resume(cls, checkpoint_dir: str, *,
               objectives: dict[str, SeparableObjective] | None = None,
               keep: int = 3, ckpt_every: int = 1,
               devices: int | None = None,
               sanitize: bool = False,
               faults=None,
               device=None,
               **fresh_kw) -> "SolveEngine":
        """Rebuild an engine (jobs, queue, and mid-solve pools with their
        page tables) from the newest committed checkpoint in
        ``checkpoint_dir`` onto ``device`` (the card by default), then
        replay the journal records newer than that base (journal mode):
        replayed submissions re-queue and re-run deterministically, so
        results equal the uninterrupted run's bit for bit. With no
        checkpoint present, returns a fresh engine built with ``fresh_kw``
        (lanes, retain_done, journal_every, ...), still replaying a
        journal if one exists (a kill can land before the first base).
        When a checkpoint IS found its recorded values win and
        ``fresh_kw`` is ignored. ``sanitize`` and ``faults`` are
        observation, not semantics: they are never persisted, and a
        resumed life sets them anew."""
        probe = CheckpointManager(checkpoint_dir, keep=keep)
        step = probe.latest_step()
        if step is None:
            fresh_kw.setdefault("sanitize", sanitize)
            fresh_kw.setdefault("faults", faults)
            eng = cls(checkpoint_dir=checkpoint_dir, keep=keep,
                      ckpt_every=ckpt_every, objectives=objectives,
                      devices=devices, device=device, **fresh_kw)
            # only in journal mode: a non-journal resume must not replay
            # stale segments left behind by an earlier journaled life
            if eng.journal_every is not None:
                eng._replay_journal(0)
            return eng
        aux = probe.aux(step)
        if aux is None:
            raise RuntimeError(
                f"checkpoint step {step} in {checkpoint_dir} has no engine "
                "aux metadata — not a SolveEngine checkpoint")
        if aux.get("version") not in (2, 3):
            raise RuntimeError(
                f"checkpoint step {step} in {checkpoint_dir} has engine aux "
                f"version {aux.get('version')}; this engine reads versions "
                "2-3 (the block-paged lane layout, v3 adding spanning "
                "lane_dev page maps) — re-run the jobs or resume with the "
                "engine version that wrote it")
        for p in aux["pools"]:
            if p.get("n_dev", 1) > 1 or any(
                    isinstance(d, list) for d in p.get("lane_dev") or []):
                raise _not_ported("resuming a snapshot cut on more than "
                                  "one device", "item 10, multi-device")
        eng = cls(lanes=aux["lanes"], dtype=getattr(torch, aux["dtype"]),
                  objectives=objectives, checkpoint_dir=checkpoint_dir,
                  ckpt_every=ckpt_every, keep=keep,
                  max_fuse=aux.get("max_fuse"),
                  retain_done=aux.get("retain_done"),
                  pool_high_water=aux.get("pool_high_water", 2.0),
                  journal_every=aux.get("journal_every"),
                  max_queue=aux.get("max_queue"),
                  memory_budget_bytes=aux.get("memory_budget_bytes"),
                  span_pages=aux.get("span_pages"),
                  devices=devices, sanitize=sanitize, faults=faults,
                  device=device)
        eng.step_count = aux["step_count"]
        eng.swept_slots = aux.get("swept_slots", 0)
        eng.swept_slots_live = aux.get("swept_slots_live", 0)
        eng._next = aux["next"]
        eng._done_seq = aux.get("done_seq", 0)
        eng.jobs = {}
        for jid, d in aux["jobs"].items():
            rec = JobState.from_dict(d)
            rec.agg_dtype = eng._agg_dtype_name(rec.spec)
            eng.jobs[jid] = rec
        eng.queue = deque(aux["queue"])
        like = {}
        metas = []
        for i, p in enumerate(aux["pools"]):
            obj = eng.objectives[p["objective"]]
            key = (p["objective"], ABOConfig(**p["config"]), p["dtype"])
            # pre-elastic v2 snapshots sized every pool to the engine budget
            slots = p.get("slots", aux["lanes"])
            # shapes and dtypes only: meta tensors allocate nothing
            like[f"p{i:03d}"] = batched.zeros_pool_state(
                obj, key, slots, p["capacity"], "meta")
            metas.append((key, obj, p, slots))
        tree = probe.restore_host(step, like) if like else {}
        for i, (key, obj, p, slots) in enumerate(metas):
            eng._mount_pool(key, obj, p, slots, tree[f"p{i:03d}"])
        for d in aux.get("family_keys_seen", []):
            eng.family_keys_seen.add(
                (d["objective"], ABOConfig(**d["config"]), d["dtype"]))
        if eng.journal_every is not None:
            eng._replay_journal(aux.get("journal_seq") or 0)
        return eng

    # repro: allow[RPR001] checkpoint-restore cold path: operates on host
    # numpy state loaded from disk, never on live device tensors
    def _mount_pool(self, key, obj, p: dict, slots: int, host_state):
        """Attach one restored pool: its tensors on this engine's device,
        its page tables as written, and the free list rebuilt from them
        (the live engine's list is always the sorted free ids, so later
        allocations take the same pages as the uninterrupted run's)."""
        page_table = [list(pt) if pt is not None else None
                      for pt in p["page_table"]]
        capacity = p["capacity"]
        state = batched.PoolState(*(
            torch.from_numpy(a).to(self.device)
            for a in (host_state.pool, host_state.aggs, host_state.hist,
                      host_state.pass_idx, host_state.n_valid)))
        used = {pg for pt in page_table if pt for pg in pt}
        pool = LanePool(
            key=key, obj=obj, lanes=self.lanes, device=self.device,
            slots=slots, high_water=self.pool_high_water, state=state,
            capacity=capacity, job_ids=list(p["job_ids"]),
            page_table=page_table,
            free_pages=sorted(set(range(1, capacity)) - used))
        self.pools[key] = pool
        self.family_keys_seen.add(key)

    def _replay_journal(self, after_seq: int):
        """Re-apply client inputs journaled after the restored base: new
        submissions re-queue (their post-base passes re-run
        deterministically, so fun/x match the uninterrupted run bit for
        bit), cancels cancel, delivery marks stick. Replay never
        re-journals — the records being replayed are already durable."""
        if self.ckpt is None:
            return
        self._replaying = True
        try:
            for rec in self.ckpt.journal_entries(after_seq=after_seq):
                kind, jid = rec.get("t"), rec.get("job_id")
                if kind == J_SUBMIT:
                    if jid in self.jobs:
                        continue         # already in the base (idempotence)
                    self.jobs[jid] = self._new_job(
                        jid, JobSpec.from_dict(rec["spec"]))
                    self.queue.append(jid)
                    self._next = max(self._next,
                                     int(jid.rsplit("-", 1)[1]) + 1)
                elif kind == J_CANCEL:
                    if jid in self.jobs and self.jobs[jid].status in (
                            QUEUED, RUNNING):
                        self.cancel(jid)
                elif kind == J_EXPIRE:
                    # the pre-kill life saw the deadline pass; re-apply
                    # the verdict rather than re-reading a moved clock
                    r = self.jobs.get(jid)
                    if r is not None and r.status == QUEUED:
                        r.status = FAILED
                        r.error = rec.get("error", "ttl expired")
                        r.done_seq = self._next_done_seq()
                        self._c_failed.inc()
                        try:
                            self.queue.remove(jid)
                        except ValueError:
                            pass
                elif kind == J_FETCHED:
                    r = self.jobs.get(jid)
                    if r is not None:
                        # the pre-kill life delivered this result; if the
                        # job must re-run first, the mark survives so the
                        # re-derived record is GC-evictable again
                        r.fetched = True
        finally:
            self._replaying = False
        self._gc_jobs()
