"""Block-paged lane pool + row-compacted sweep, in PyTorch, on one device.

Port of :mod:`repro.engine.batched` for a single device. Every solve
*family* — (objective, effective config, dtype) — owns one
:class:`PoolState`: a shared ``(P, block_size)`` page pool holding every
lane's coordinate blocks, plus per-lane-slot scalar state (aggregates,
history, pass index, true n). Which pages belong to which lane lives
host-side in the scheduler's page tables. A lane with true n occupies
``ceil(n / block)`` pages, so the engine's work is proportional to
``Σ_i ceil(n_i / block)``, not ``K × n_pad``.

A pass is an outer loop over block *rows*. At each row the step gathers
the lanes occupying it, runs the block commit for all of them at once and
scatters the committed blocks back; rows run in ascending order per lane,
which keeps each lane's Gauss-Seidel block order. Row widths, gathered
row views and pool capacities ride the :func:`pad_ladder` count ladder,
exactly as in the reference, so the plan tables are the reference's.

Where the port differs in form from the reference:
  * PyTorch runs eagerly, so a fused step is a Python loop over passes,
    bands and rows, and each row step is a few dozen small kernels for
    all of its gathered lanes (the reference compiles the whole step into
    one program).
  * The pool is updated IN PLACE (``index_copy_``), the PyTorch analogue
    of the reference's donated buffers; ``analysis.sanitize`` checks it.
  * Nothing compiles. :class:`PoolOps` notes each distinct shape it is
    called at — the pool's (pages, slots) and the call's plan or gather
    signature, what the reference would compile an executable for —
    and ``compiled_executable_count`` counts them, the budget a
    steady-state drain must not grow.
  * Bit-identity with the port's ``abo_minimize`` rests on the same
    mechanisms as the reference's, restated for PyTorch: the block commit
    (:meth:`PoolOps._lane_commit`) is ``core.abo._probe_commit`` with a
    leading lane axis — the same elementwise ops in the same order, and an
    elementwise kernel computes each element alone; ``argmin`` takes the
    first minimum; every sum is an explicit halving tree or an in-order
    fold (``objectives.base.tree_sum``, ``fold_partials``). So a lane's
    bits do not depend on how many lanes share its rows, its slot, its
    pages, or the length of the row view its re-sync gathers.
  * Sharded pools, ``shard_map`` and striped spanning lanes are not
    ported (ROADMAP, queue 1 item 10). A ``span_coords`` config is
    supported as math: its lanes restart each shard's first row from the
    pass-entry aggregates, as the solver does.
"""
# repro: hot-path — the pool sweep; no host sync by construction
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.core.abo import (ABOConfig, _linspace_offsets,
                                  effective_config, seeded_start)
from repro_torch.objectives.base import SeparableObjective, tree_sum

# (family key, device) -> PoolOps
_POOL_OPS: dict[tuple, "PoolOps"] = {}

# Padding-waste ceiling for ladder quantization: the {1, 1.5} x pow2
# ladder's intrinsic worst case is 1/3, so at the default every count rides
# a canonical rung; 0 disables quantization (exact sizes).
DEFAULT_MAX_PAD_WASTE = 0.35

# Page id 0 and the last lane-slot row (one past the pool's current slot
# count) are reserved scratch targets for ladder padding entries in
# gathers/scatters: scratch page content is all-zeros by construction and
# the scratch lane has n_valid = 0, so padded work is inert and padded
# reads are exact zeros.
SCRATCH_PAGE = 0

def pad_ladder(n: int, block: int,
               max_pad_waste: float = DEFAULT_MAX_PAD_WASTE) -> int:
    """Canonical padded size for a count of ``n`` in units of ``block``.

    Rungs are {1, 1.5} x powers of two in units of ``block``
    (block x {1, 2, 3, 4, 6, 8, 12, ...}) — a geometric ladder, so the
    whole [1, 1e9] range needs only ~2 log2(range) distinct sizes and
    padding waste ``(n_pad - n) / n_pad`` never exceeds 1/3. If the
    smallest rung >= n still wastes more than ``max_pad_waste``, the count
    keeps its exact ``ceil(n/block)*block`` size. In the paged layout this
    quantizes counts: row widths, page-count rungs, lane-batch widths and
    pool capacities all ride it with ``block=1``.
    """
    exact = -(-n // block) * block
    if max_pad_waste <= 0.0:
        return exact
    mult = exact // block
    rung = 1
    while rung < mult:
        if rung & (rung - 1) == 0 and rung >= 2:   # 2^j -> 3*2^(j-1)
            rung = rung * 3 // 2
        elif rung == 1:
            rung = 2
        else:                                      # 3*2^(j-1) -> 2^(j+1)
            rung = rung // 3 * 4
    n_pad = rung * block
    if (n_pad - n) / n_pad <= max_pad_waste:
        return n_pad
    return exact


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the name the reference's keys
    and snapshots carry."""
    return str(dtype).removeprefix("torch.")


def family_key(obj_name: str, n: int, cfg: ABOConfig,
               dtype=torch.float32) -> tuple:
    """Shape-sharing key for an n-dimensional job: everything that shapes
    the pool EXCEPT any padded size, so jobs of every n whose effective
    config matches share one pool (n only enters through the block-size
    resolution of tiny problems)."""
    return (obj_name, effective_config(cfg, n), dtype_name(dtype))


def key_config(key: tuple) -> ABOConfig:
    return key[1]


def key_dtype(key: tuple) -> torch.dtype:
    return getattr(torch, key[2])


def key_agg_dtype(key: tuple) -> torch.dtype:
    """The family's aggregate (and history) dtype: the solution's, as the
    port's ``abo_minimize`` carries them by default — float64 solves are
    the reference's under x64, float32 ones the reference's without it."""
    return key_dtype(key)


def pages_for(n: int, block: int) -> int:
    """Pages a lane with true n occupies — its real footprint."""
    return -(-n // block)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a synchronising copy: on the
    card it goes through pinned memory, ``non_blocking``, so the step
    that sends plan tables or placement data does not wait for the
    device. On the CPU it is a copy the caller owns."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


@dataclasses.dataclass
class PoolState:
    """One family's device state: the shared page pool + per-slot scalars.

    ``pool[0]`` is the reserved all-zero scratch page and slot ``lanes``
    (the last row of the per-slot arrays) the scratch lane — ladder padding
    entries in gathers/scatters target them.
    """

    pool: torch.Tensor       # (P, block) coordinate pages
    aggs: torch.Tensor       # (lanes+1, n_aggs) running aggregates per slot
    hist: torch.Tensor       # (lanes+1, n_passes) objective after each pass
    pass_idx: torch.Tensor   # (lanes+1,) int32, next pass per slot
    n_valid: torch.Tensor    # (lanes+1,) int32, true n per slot (0 = idle)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.pool, self.aggs, self.hist, self.pass_idx, self.n_valid)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def zeros_pool_state(obj: SeparableObjective, key: tuple, lanes: int,
                     pages: int, device) -> PoolState:
    """An all-idle pool. Idle and scratch slots hold n_valid=0, so they
    are never swept and any ladder-padding work routed at them is
    frozen."""
    cfg = key_config(key)
    dev = torch.device(device)
    agg_dt = key_agg_dtype(key)
    return PoolState(
        pool=torch.zeros((pages, cfg.block_size), dtype=key_dtype(key),
                         device=dev),
        aggs=torch.zeros((lanes + 1, obj.n_aggs), dtype=agg_dt, device=dev),
        hist=torch.zeros((lanes + 1, cfg.n_passes), dtype=agg_dt,
                         device=dev),
        pass_idx=torch.zeros((lanes + 1,), dtype=torch.int32, device=dev),
        n_valid=torch.zeros((lanes + 1,), dtype=torch.int32, device=dev),
    )


def resize_pool_state(state: PoolState, lanes: int, pages: int) -> PoolState:
    """Re-shape a pool's device state to ``lanes`` slots and ``pages``
    capacity, growing or shrinking either dimension.

    Surviving pages keep their ids and content (new pages are zero;
    callers only shrink past all-free tails). Surviving lane slots keep
    their scalars; the scratch slot — always the LAST row — is rebuilt as
    zeros at its new index, which also clears the junk ladder-padded
    syncs leave in it. A dimension that keeps its size keeps its tensors;
    a shrunk pool is copied out, so the old storage is freed."""
    p0 = state.pool.shape[0]
    s0 = state.aggs.shape[0] - 1
    if pages == p0 and lanes == s0:
        return state
    keep = min(s0, lanes)

    def slots(a):
        if lanes == s0:
            return a
        out = a.new_zeros((lanes + 1,) + tuple(a.shape[1:]))
        out[:keep] = a[:keep]
        return out

    pool = state.pool
    if pages > p0:
        pool = pool.new_zeros((pages, pool.shape[1]))
        pool[:p0] = state.pool
    elif pages < p0:
        pool = pool[:pages].clone()
    return PoolState(pool=pool, aggs=slots(state.aggs),
                     hist=slots(state.hist),
                     pass_idx=slots(state.pass_idx),
                     n_valid=slots(state.n_valid))


class PoolOps:
    """Per-family operations over a :class:`PoolState`, on one device.

    * ``fused_step`` — a whole sweep-plan step: every width band's row
      loop plus the end-of-pass lane sync, ``n_fused`` passes.
    * ``place`` / ``place_x`` — initialize freshly admitted lanes
      (seeded / golden-section / explicit x0 starts) into their pages.
    * ``finalize`` — exact final re-eval + row-view gather for ONLY the
      finishing lanes.

    Each notes the shape it is called at in ``shapes`` (see
    :func:`compiled_executable_count`). The first three update the state
    they are given in place and return it.
    """

    def __init__(self, obj: SeparableObjective, key: tuple, device):
        self.obj = obj
        self.key = key
        self.device = torch.device(device)
        self.cfg: ABOConfig = key_config(key)
        self.dtype = key_dtype(key)
        # (pages, slots, call signature) of every call so far
        self.shapes: set[tuple] = set()
        cfg, dt, dev = self.cfg, self.dtype, self.device
        # the solver's per-block constants, made once on the device (no
        # host value crosses per row): the grid offsets, the pass schedule
        # tables of core.abo.pass_schedule in the family's aggregate dtype,
        # and the uniform bounds
        # as 0-d tensors, so the grid's arithmetic is the solver's op for op
        self._offs = _linspace_offsets(cfg.samples_per_pass - 1, dt, dev)
        ps = np.arange(cfg.n_passes, dtype=np.float64)
        hw = 0.5 * cfg.resolved_shrink() ** ps
        lam = (ps / (cfg.n_passes - 1)
               if cfg.coupling_schedule == "linear" and cfg.n_passes > 1
               else np.ones_like(ps))
        agg_np = np.dtype(dtype_name(key_agg_dtype(key)))
        self._hw_tab = upload(hw.astype(agg_np), dev)
        self._lam_tab = upload(lam.astype(agg_np), dev)
        self._lo = torch.full((), obj.lower, dtype=dt, device=dev)
        self._hi = torch.full((), obj.upper, dtype=dt, device=dev)
        self._span = self._hi - self._lo
        self._mid = 0.5 * (self._lo + self._hi)
        self._half = 0.5 * self._span
        self._local = torch.arange(cfg.block_size, device=dev)
        self._rows_per_shard = (cfg.span_coords // cfg.block_size
                                if cfg.span_coords is not None else None)

    def _note(self, st: PoolState, *signature):
        self.shapes.add((st.pool.shape[0], st.aggs.shape[0]) + signature)

    # ------------------------------------------------------------ the sweep
    def _lane_commit(self, xb, ag, idx, valid, w, first, lam):
        """``core.abo._probe_commit`` for W gathered lanes at once.

        ``xb`` (W, B) blocks, ``ag`` (W, n_aggs) aggregates, ``idx`` /
        ``valid`` (W, B), and each lane's schedule (W,): the grid window
        ``w``, whether it is the first pass, and ``lam``. The ops are the
        solver's, in its order, with a leading lane axis: the (W, B, m)
        candidate grid with the incumbent last, the O(1) probes, the
        first-minimum argmin, the tree-summed commit and the guard."""
        obj = self.obj
        center = torch.where(first[:, None, None], self._mid, xb[:, :, None])
        grid = torch.clamp(center + w[:, None, None] * self._offs, self._lo,
                           self._hi)
        cands = torch.cat([grid, xb[:, :, None]], dim=2)
        # padding coordinates are frozen: their only candidate is themselves
        cands = torch.where(valid[:, :, None], cands, xb[:, :, None])
        delta = obj.term_delta(idx, xb, cands, agg_dtype=ag.dtype)
        f_cand = obj.combine_at(ag[:, None, None, :] + delta,
                                lam[:, None, None])
        sel = torch.argmin(f_cand, dim=2)                      # first min
        x_sel = torch.gather(cands, 2, sel[:, :, None])[:, :, 0]
        d_sel = torch.gather(
            delta, 2, sel[:, :, None, None].expand(-1, -1, 1,
                                                   delta.shape[3]))[:, :, 0]
        ag_new = ag + tree_sum(d_sel, dim=1).to(ag.dtype)
        if self.cfg.guard_commits:
            accept = obj.combine_at(ag_new, lam) <= obj.combine_at(ag, lam)
            x_sel = torch.where(accept[:, None], x_sel, xb)
            ag_new = torch.where(accept[:, None], ag_new, ag)
        return x_sel, ag_new

    def _schedule(self, st: PoolState):
        """Per-slot (grid window, lam, first pass?, n_valid) for the pass
        every slot is in — the window is ``_candidate_grid``'s, the whole
        half-span on the first pass, else the pass's half-width times the
        span. pass_idx changes only at the lane sync, so one lookup serves
        every row of the pass."""
        p = st.pass_idx.long().clamp(0, self.cfg.n_passes - 1)
        first = st.pass_idx == 0
        hw = self._hw_tab.index_select(0, p).to(self.dtype)
        return (torch.where(first, self._half, hw * self._span),
                self._lam_tab.index_select(0, p), first, st.n_valid)

    def _band(self, st: PoolState, sched, lanes, pages, rows, n_rows,
              aggs0):
        """One width band: its lanes' schedule gathered once for all of
        its rows, then the rows in order. Each row gathers its lanes'
        blocks and aggregates, commits every lane's block and scatters both
        back. Ladder-padding entries point at the scratch lane/page and
        write back what they read (all their coordinates are frozen)."""
        bsz = self.cfg.block_size
        flat = lanes.reshape(-1)
        w, lam, first, nv = (t.index_select(0, flat).view(lanes.shape)
                             for t in sched)
        starts = rows * bsz
        reset = (rows % self._rows_per_shard == 0) if aggs0 is not None \
            else None
        for j, (ln, pg, start) in enumerate(zip(
                lanes.unbind(0)[:n_rows], pages.unbind(0)[:n_rows],
                starts.unbind(0)[:n_rows])):
            xb = st.pool.index_select(0, pg)
            ag = st.aggs.index_select(0, ln)
            if reset is not None:
                # span_coords: a shard's first row restarts from the
                # pass-entry aggregates (Jacobi across shards)
                ag = torch.where(reset[j][:, None],
                                 aggs0.index_select(0, ln), ag)
            idx = start[:, None] + self._local
            x_sel, ag_new = self._lane_commit(
                xb, ag, idx, idx < nv[j][:, None], w[j], first[j], lam[j])
            st.pool.index_copy_(0, pg, x_sel)
            st.aggs.index_copy_(0, ln, ag_new)

    def _gather_rows(self, st: PoolState, pages: torch.Tensor):
        """(v, g) page ids -> (v, g*block) contiguous row views. Pages past
        a lane's true count are scratch (exact zeros), and the tile-fixed
        reduction is length-invariant, so a whole-row reduction matches the
        solver's padded vector at ANY rung width."""
        v, g = pages.shape
        return st.pool.index_select(0, pages.reshape(-1)).view(
            v, g * self.cfg.block_size)

    def _sync(self, st: PoolState, lanes, pages):
        """End-of-pass bookkeeping of abo_pass_step for the gathered
        lanes: exact aggregate re-sync over the row view, history entry,
        pass_idx advance. The history column is clamped: padding entries
        keep advancing the scratch slot's pass_idx."""
        n_passes = self.cfg.n_passes
        ag = self.obj.row_aggregates(self._gather_rows(st, pages),
                                     st.n_valid.index_select(0, lanes),
                                     agg_dtype=st.aggs.dtype)
        p = st.pass_idx.index_select(0, lanes)
        st.aggs.index_copy_(0, lanes, ag)
        st.hist.view(-1).index_copy_(
            0, lanes * n_passes + p.clamp(max=n_passes - 1),
            self.obj.combine(ag).to(st.hist.dtype))
        st.pass_idx.index_copy_(0, lanes, p + 1)

    def fused_step(self, st: PoolState, n_fused: int, *arrs) -> PoolState:
        """``n_fused`` complete passes of a sweep plan whose tables are
        ``arrs`` = ``(lanes_0, pages_0, rows_0, n_rows_0, ..., sync_lanes,
        sync_pages)``: every band in ascending-row order, then the
        per-lane re-sync. The plan's signature — each band's (w, r_cap)
        and the sync's (g, v) — is read off the tables' shapes."""
        bands = [arrs[i:i + 4] for i in range(0, len(arrs) - 2, 4)]
        sync_lanes, sync_pages = arrs[-2:]
        self._note(st, "step", tuple((b[0].shape[1], b[0].shape[0])
                                     for b in bands),
                   (sync_pages.shape[1], sync_pages.shape[0]))
        for _ in range(n_fused):
            sched = self._schedule(st)
            aggs0 = st.aggs.clone() if self._rows_per_shard else None
            for band in bands:
                self._band(st, sched, *band, aggs0)
            self._sync(st, sync_lanes, sync_pages)
        return st

    # ------------------------------------------------------------ placement
    def place(self, st: PoolState, members) -> PoolState:
        """One refill batch, ``members`` a list of ``(slot, page ids, seed
        or None, n)``, noted at the reference's (page rung, batch rung)
        shape: start vectors and
        exact init aggregates, written into the lanes' own pages (never
        the scratch page). Each lane's pages get the solver's whole padded
        start vector: ``seeded_start`` over them is per coordinate, so bit
        for bit the solver's, padding included. The reference zeroes the
        padding instead; the port keeps it as the solver has it, because a
        frozen padding coordinate still enters its block's probes, and at
        x = 0 Schwefel 2.22's log|x| makes them NaN."""
        self._note(st, "place",
                   pad_ladder(max(len(m[1]) for m in members), 1),
                   pad_ladder(len(members), 1))
        obj, bsz, dt = self.obj, self.cfg.block_size, self.dtype
        golden = obj.lower + 0.6180339887 * (obj.upper - obj.lower)
        for slot, pages, seed, n in members:
            width = len(pages) * bsz
            if seed is None:
                xr = torch.full((width,), golden, dtype=dt,
                                device=self.device)
            else:
                xr = seeded_start(seed, width, dt, obj.lower, obj.upper,
                                  device=self.device)
            self._write_lane(st, slot, pages, xr, n)
        return st

    def place_x(self, st: PoolState, slot: int, pages, xrow: np.ndarray,
                n: int) -> PoolState:
        """Explicit-x0 placement for one lane (rare); ``xrow`` is host data
        with zeros past n."""
        self._note(st, "place_x", pad_ladder(len(pages), 1))
        self._write_lane(st, slot, pages, upload(xrow, self.device), n)
        return st

    def _write_lane(self, st: PoolState, slot: int, pages, xr, n: int):
        bsz = self.cfg.block_size
        st.pool.index_copy_(0, upload(np.array(pages, np.int64), self.device),
                            xr.to(st.pool.dtype).view(-1, bsz))
        st.aggs[slot] = self.obj.aggregates(xr, n, agg_dtype=st.aggs.dtype)
        # fill_ on the slot's view: assigning a Python number to a 0-d
        # element would copy it from the host and wait for the card
        st.hist[slot].fill_(0)
        st.pass_idx[slot].fill_(0)
        st.n_valid[slot].fill_(n)

    # ------------------------------------------------------------- finalize
    def finalize(self, st: PoolState, lanes, pages):
        """``lanes (v,), pages (v, g) -> (f (v,), x (v, g*block), hist (v,
        n_passes))``: exact O(n) re-eval + solution gather for ONLY the
        finishing lanes. Reads the state, changes nothing."""
        self._note(st, "final", pages.shape[1], pages.shape[0])
        xrow = self._gather_rows(st, pages)
        ag = self.obj.row_aggregates(xrow, st.n_valid.index_select(0, lanes),
                                     agg_dtype=st.aggs.dtype)
        return (self.obj.combine(ag), xrow,
                st.hist.index_select(0, lanes))


def get_pool_ops(obj: SeparableObjective, key: tuple, device) -> PoolOps:
    """The family's PoolOps on ``device``, made once: its constant tables
    go to the device once, whatever the pool's size."""
    ck = (key, str(torch.device(device)))
    ops = _POOL_OPS.get(ck)
    if ops is None:
        ops = _POOL_OPS[ck] = PoolOps(obj, key, device)
    return ops


def compiled_executable_count(families: set | None = None) -> int:
    """Distinct shapes the pool operations were called at (each counts
    once — the port's stand-in for the reference's compiled executables).
    With ``families`` (a set of family keys, e.g. an engine's
    ``family_keys_seen``), counts only the shapes those families own;
    without it, the process-wide total."""
    return sum(len(ops.shapes) for (key, _), ops in _POOL_OPS.items()
               if families is None or key in families)
