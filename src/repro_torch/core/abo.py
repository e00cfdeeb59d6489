"""Amo-Boateng Optimization (ABO) — the paper's core algorithm, in PyTorch.

Port of :mod:`repro.core.abo`:
  * every pass samples each parameter space **linearly** (a deterministic
    candidate grid per coordinate),
  * probes are O(1) via the separable-aggregate algebra,
  * memory = the solution vector + O(block·m) scratch + n_aggs scalars,
  * compute = O(m·N) with m = passes × samples_per_pass (paper Eq. 5).

Coordinates are swept in blocks of ``block_size`` with guarded Jacobi
commits; blocks run in order (Gauss-Seidel) with the aggregates carried.

Where the port differs in form from the reference:
  * PyTorch runs eagerly, so the pass is a Python loop over blocks and the
    solve a Python loop over passes; no jit, scan or fori_loop.
  * The solution vector is updated in place: ``abo_pass_step`` writes the
    pass into ``state.x`` (the reference's jitted solve donates it).
  * The candidate grid's offsets are ``jnp.linspace`` as the reference's
    compiled solver evaluates it (see :func:`_linspace_offsets`), so the
    grid is the reference's bit for bit. Transcendentals still round
    differently in torch and XLA, so whole solves are held to the
    reference's result quality, not to its bits.
  * ``use_kernel=True`` runs each pass as the hand-written CUDA sweep.
"""
# repro: hot-path — the per-pass sweep; every host sync below is a designed one
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.objectives.base import SeparableObjective


@dataclasses.dataclass(frozen=True)
class ABOConfig:
    """Sampling-rate schedule. Defaults reproduce the paper's m ≈ 250·N FE."""

    samples_per_pass: int = 50   # candidates per coordinate per pass (incl. incumbent)
    n_passes: int = 5            # total probes/coordinate m = 5 × 50 = 250
    block_size: int = 4096      # coordinates swept per Jacobi tile
    shrink: float | None = None  # window factor per pass; None -> 2·safety/(m-2)
    safety: float = 2.0          # window covers ± safety × previous grid spacing
    guard_commits: bool = True   # reject a block commit that worsens f (monotone)
    use_kernel: bool = False     # run each pass as the hand-written CUDA sweep
    # Spanning decomposition: blocks run Gauss-Seidel WITHIN a shard of
    # ``span_coords`` coordinates and Jacobi ACROSS shards (the carried
    # aggregates reset to the pass-entry snapshot at each shard's first
    # block). A math knob: it changes the trajectory deterministically.
    span_coords: int | None = None
    # "linear": anneal the coupling weight λ from 0 to 1 over passes;
    # "none": the paper-pure exact objective in every pass.
    coupling_schedule: str = "linear"

    def __post_init__(self):
        if self.samples_per_pass < 3:
            raise ValueError(
                f"samples_per_pass must be >= 3, got {self.samples_per_pass}: "
                "m=2 degenerates the candidate grid's linspace to a single "
                "point (the incumbent plus one fixed probe), so the window "
                "never refines")
        if self.n_passes < 1:
            raise ValueError(
                f"n_passes must be >= 1, got {self.n_passes}: ABO needs at "
                "least the full-interval pass 0")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}: each Jacobi "
                "tile must hold at least one coordinate")
        if self.span_coords is not None:
            if self.span_coords < 1:
                raise ValueError(
                    f"span_coords must be >= 1, got {self.span_coords}")
            if self.span_coords % self.block_size != 0:
                raise ValueError(
                    f"span_coords ({self.span_coords}) must be a multiple of "
                    f"block_size ({self.block_size}): a shard boundary inside "
                    "a Jacobi tile would split one block commit across two "
                    "aggregate snapshots")

    def resolved_shrink(self) -> float:
        if self.shrink is not None:
            return self.shrink
        return 2.0 * self.safety / max(self.samples_per_pass - 2, 1)


@dataclasses.dataclass
class ABOResult:
    x: torch.Tensor          # (n,) solution (unpadded)
    fun: float               # objective at x
    fe: int                  # probe-FE count (paper's FE semantics)
    history: torch.Tensor    # (n_passes,) objective after each pass
    n: int
    config: ABOConfig


def _candidate_grid(xb, lo, hi, half_width, m, is_first_pass):
    """(B, m) linear sampling grid; incumbent is always candidate column m-1.

    Pass 0 sweeps the full feasible interval; later passes a shrinking
    window centred on the incumbent. ``lo``/``hi`` are scalars or (B,)
    tensors; ``half_width`` is a fraction of the full range in [0, 0.5];
    ``is_first_pass`` is a bool or a 0-d bool tensor.
    """
    dt, dev = xb.dtype, xb.device
    lo = torch.as_tensor(lo, dtype=dt, device=dev).expand(xb.shape)[:, None]
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(xb.shape)[:, None]
    span = hi - lo
    first = torch.as_tensor(is_first_pass, device=dev)
    center = torch.where(first, 0.5 * (lo + hi), xb[:, None])
    w = torch.where(first, 0.5 * span,
                    torch.as_tensor(half_width, dtype=dt, device=dev) * span)
    offs = _linspace_offsets(m - 1, dt, dev)                        # (m-1,)
    grid = torch.clamp(center + w * offs[None, :], lo, hi)
    return torch.cat([grid, xb[:, None]], dim=1)                    # (B, m)


def _linspace_offsets(num, dt, dev):
    """``jnp.linspace(-1, 1, num)`` as the reference's compiled solver
    evaluates it, bit for bit: t = i · fl(1/(num-1)) (XLA turns the division
    by a constant into a multiply by its reciprocal), then -(1 - t) + t, and
    1 as the last point. For an odd ``num`` the midpoint is exactly 0, as
    the exact-zero optima of sphere and Schwefel 2.22 need;
    ``torch.linspace`` rounds otherwise and misses it."""
    div = num - 1
    t = torch.arange(div, dtype=dt, device=dev) * (1.0 / div)
    return torch.cat([-(1.0 - t) + t, torch.ones(1, dtype=dt, device=dev)])


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 with an EXPLICIT balanced association tree (halve,
    add, repeat; an odd leftover rides along unmodified), so any two
    programs summing the same values get the same bits."""
    while x.shape[0] > 1:
        k = x.shape[0] // 2
        head = x[:k] + x[k: 2 * k]
        x = head if x.shape[0] == 2 * k else torch.cat([head, x[2 * k:]])
    return x[0]


def _probe_commit(obj, cfg, xb, aggs, idx, valid, half_width, is_first_pass,
                  lam, lo, hi):
    """Probe-and-commit one Jacobi block: the (B, m) candidate tile, the
    argmin selection, and the guarded aggregate commit (the reference's
    block step, ``abo.py:146-176``)."""
    m = cfg.samples_per_pass
    agg_dt = aggs.dtype
    cands = _candidate_grid(xb, lo, hi, half_width, m, is_first_pass)
    # Padding coordinates are frozen: their only candidate is themselves.
    cands = torch.where(valid[:, None], cands, xb[:, None])

    delta = obj.term_delta(idx, xb, cands, agg_dtype=agg_dt)  # (B, m, A)
    f_cand = obj.combine_at(aggs + delta, lam)                # (B, m)
    sel = torch.argmin(f_cand, dim=1)                         # first min
    x_sel = torch.gather(cands, 1, sel[:, None])[:, 0]
    d_sel = torch.gather(
        delta, 1, sel[:, None, None].expand(-1, 1, delta.shape[2]))[:, 0, :]
    aggs_new = aggs + tree_sum(d_sel).to(agg_dt)

    if cfg.guard_commits:
        accept = obj.combine_at(aggs_new, lam) <= obj.combine_at(aggs, lam)
        x_sel = torch.where(accept, x_sel, xb)
        aggs_new = torch.where(accept, aggs_new, aggs)
    return x_sel, aggs_new


def pass_schedule(cfg: ABOConfig, pass_idx, agg_dtype, device=None):
    """(half_width, lam) for a pass index, as host-precomputed tables.

    The tables are evaluated in float64 on the host and then cast, exactly
    as the reference builds them; ``pass_idx`` (an int or an integer
    tensor) indexes them with clipping, on the device, with no host sync.
    """
    if isinstance(pass_idx, torch.Tensor):
        device = pass_idx.device
    p = torch.as_tensor(pass_idx, device=device).long().clamp(0, cfg.n_passes - 1)
    ps = np.arange(cfg.n_passes, dtype=np.float64)
    hw_tab = torch.as_tensor(0.5 * cfg.resolved_shrink() ** ps, dtype=agg_dtype,
                             device=p.device)
    half_width = torch.take(hw_tab, p)
    if cfg.coupling_schedule == "linear" and cfg.n_passes > 1:
        lam_tab = torch.as_tensor(ps / (cfg.n_passes - 1), dtype=agg_dtype,
                                  device=p.device)
        lam = torch.take(lam_tab, p)
    else:
        lam = torch.ones(p.shape, dtype=agg_dtype, device=p.device)
    return half_width, lam


def _sweep_pass(obj, x, aggs, n_valid, half_width, pass_idx, lam, cfg,
                bounds=None):
    """One full pass over the padded solution, IN PLACE on ``x``: blocks in
    order, each one probe-and-commit against the carried aggregates."""
    n_pad = x.shape[0]
    bsz = cfg.block_size
    first = torch.as_tensor(pass_idx, device=x.device) == 0
    rows_per_shard = (cfg.span_coords // bsz
                      if cfg.span_coords is not None else None)
    aggs0 = aggs
    local = torch.arange(bsz, device=x.device)
    for blk in range(n_pad // bsz):
        if rows_per_shard is not None and blk % rows_per_shard == 0:
            aggs = aggs0     # shard first block: reset to pass entry
        start = blk * bsz
        xb = x[start:start + bsz]
        idx = start + local
        valid = idx < n_valid
        if bounds is not None:       # per-coordinate spaces (paper's s=3)
            lo = bounds[0][start:start + bsz]
            hi = bounds[1][start:start + bsz]
        else:
            lo, hi = obj.lower, obj.upper
        x_sel, aggs = _probe_commit(obj, cfg, xb, aggs, idx, valid,
                                    half_width, first, lam, lo, hi)
        x[start:start + bsz] = x_sel
    return x, aggs


@dataclasses.dataclass
class ABOState:
    """Complete in-flight solver state at a pass boundary.

    The (padded) solution, the running aggregates, the per-pass objective
    history, the next pass index, and the true coordinate count. The
    solver has no weights: this plus :class:`ABOConfig` is a whole solve.
    """

    x: torch.Tensor          # (n_pad,) padded solution vector
    aggs: torch.Tensor       # (n_aggs,) running aggregates
    hist: torch.Tensor       # (n_passes,) objective after each pass
    pass_idx: torch.Tensor   # () int32, next pass to run
    n_valid: torch.Tensor    # () int32, true n (padding coords are frozen)


def abo_state_from_numpy(x, aggs, hist, pass_idx, n_valid, *,
                         device=None) -> ABOState:
    """The port's :class:`ABOState` from the fields of a reference
    ``ABOState`` given as numpy arrays, so both packages can continue one
    solve from the same state. Every field is copied; x and the aggregates
    keep their dtypes, the two counters become int32."""
    dev = resolve_device(device)
    return ABOState(
        x=torch.from_numpy(np.array(x)).to(dev),
        aggs=torch.from_numpy(np.array(aggs)).to(dev),
        hist=torch.from_numpy(np.array(hist)).to(dev),
        pass_idx=torch.from_numpy(np.array(pass_idx, np.int32)).to(dev),
        n_valid=torch.from_numpy(np.array(n_valid, np.int32)).to(dev),
    )


def effective_config(cfg: ABOConfig, n: int) -> ABOConfig:
    """The block size actually used for an n-dimensional solve: exact
    Gauss-Seidel (block=1) for n <= 128, the configured Jacobi tiles
    otherwise; a span covering the whole problem is normalized away."""
    bsz = 1 if n <= 128 else cfg.block_size
    if bsz != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=bsz)
    if cfg.span_coords is not None and cfg.span_coords >= n:
        cfg = dataclasses.replace(cfg, span_coords=None)
    return cfg


def abo_make_state(obj: SeparableObjective, x: torch.Tensor, n_valid,
                   cfg: ABOConfig, *, agg_dtype=torch.float32) -> ABOState:
    """Pass-0 state from a (padded) start vector."""
    aggs = obj.aggregates(x, n_valid, agg_dtype=agg_dtype)
    return ABOState(
        x=x,
        aggs=aggs,
        hist=torch.zeros((cfg.n_passes,), dtype=agg_dtype, device=x.device),
        pass_idx=torch.zeros((), dtype=torch.int32, device=x.device),
        n_valid=torch.as_tensor(n_valid, dtype=torch.int32, device=x.device),
    )


# ---- seeded starts: threefry2x32, bit for bit with jax.random -------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 ``a*b + c`` rounded ONCE, as XLA:CPU's contracted FMA does.

    ``a*b`` is exact in float64 (two 24-bit significands). The sum is
    taken in float64 with its exact error (TwoSum) and rounded to odd, and
    round-to-odd with 29 spare bits makes the final cast to float32 a
    correct single rounding."""
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _seed_key(seed) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is cut to its
    low 32 bits, so the key is ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _M32


def _uniform_at(key, idx: torch.Tensor, dtype, lo, hi) -> torch.Tensor:
    """``uniform(fold_in(key, i), (), dtype, lo, hi)`` for each i in idx."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"seeded starts are bit-exact for float32 only, got {dtype}")
    idx = idx.to(torch.int64) & _M32
    zero = torch.zeros_like(idx)
    k0, k1 = _threefry2x32(key[0], key[1], zero, idx)        # fold_in
    b0, b1 = _threefry2x32(k0, k1, zero, zero)               # random_bits
    bits = (b0 ^ b1) >> 9 | 0x3F800000                       # [1, 2) mantissa
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # repro: allow[RPR001] lo/hi are host numbers, rounded to float32 here
    lo32 = float(np.float32(lo))
    # repro: allow[RPR001] lo/hi are host numbers, rounded to float32 here
    span = float(np.float32(np.float32(hi) - np.float32(lo)))
    return torch.clamp(_fma_f32(f, span, lo32), min=lo32)


def seeded_start(seed, n_pad, dtype, lo, hi, chunk=1 << 20, *, device=None):
    """Pad-invariant random feasible start over ``(n_pad,)``.

    Coordinate ``i`` is drawn from its own counter-derived key
    (``fold_in(PRNGKey(seed), i)``), so its value depends only on
    ``(seed, i)``, never on the padded length — and it is bit for bit the
    reference's draw for float32. Drawn in ``chunk``-sized segments so live
    scratch stays O(chunk) beyond the output. float64 is not ported yet and
    raises ``NotImplementedError``.
    """
    dev = resolve_device(device)
    key = _seed_key(seed)
    out = torch.empty((n_pad,), dtype=dtype, device=dev)
    for c0 in range(0, n_pad, chunk):
        idx = torch.arange(c0, min(c0 + chunk, n_pad), device=dev)
        out[c0:c0 + chunk] = _uniform_at(key, idx, dtype, lo, hi)
    return out


def seeded_at(seed, idx: torch.Tensor, dtype, lo, hi) -> torch.Tensor:
    """:func:`seeded_start`'s per-coordinate draw at arbitrary global
    indices ``idx`` (a (k,) integer tensor; its device is used)."""
    return _uniform_at(_seed_key(seed), idx, dtype, lo, hi)


def _init_x(obj, n, n_pad, x0, dtype, seed, bounds, device):
    """The start vector + padded bounds."""
    bnds = None
    if bounds is not None:
        # the paper's s=3 case: two extra O(N) vectors, nothing else
        lo = torch.full((n_pad,), obj.lower, dtype=dtype, device=device)
        hi = torch.full((n_pad,), obj.upper, dtype=dtype, device=device)
        lo[:n] = torch.as_tensor(bounds[0], dtype=dtype, device=device)
        hi[:n] = torch.as_tensor(bounds[1], dtype=dtype, device=device)
        bnds = (lo, hi)
    if x0 is not None:
        x = torch.zeros((n_pad,), dtype=dtype, device=device)
        x[:n] = torch.as_tensor(x0, dtype=dtype, device=device)
    elif seed is not None:
        # pad-invariant per-coordinate draw
        x = seeded_start(seed, n_pad, dtype, obj.lower, obj.upper,
                         device=device)
        if bnds is not None:
            x = bnds[0] + (bnds[1] - bnds[0]) * (x - obj.lower) \
                / (obj.upper - obj.lower)
    else:
        # Deterministic off-centre start (golden-section point) — midpoint
        # would coincide with the optimum of symmetric benchmark domains.
        if bnds is not None:
            x = bnds[0] + 0.6180339887 * (bnds[1] - bnds[0])
        else:
            x = torch.full((n_pad,), obj.lower
                           + 0.6180339887 * (obj.upper - obj.lower),
                           dtype=dtype, device=device)
    return x, bnds


def abo_init(obj: SeparableObjective, n: int, *, config: ABOConfig | None = None,
             x0=None, dtype=torch.float32, seed: int | None = None,
             bounds=None, device=None):
    """Build the pass-0 state for a solve: ``(state, cfg, padded_bounds)``,
    where ``cfg`` is the effective config every ``abo_pass_step`` takes."""
    dev = resolve_device(device)
    cfg = effective_config(config or ABOConfig(), n)
    n_pad = -(-n // cfg.block_size) * cfg.block_size
    x, bnds = _init_x(obj, n, n_pad, x0, dtype, seed, bounds, dev)
    return abo_make_state(obj, x, n, cfg), cfg, bnds


def abo_pass_step(obj: SeparableObjective, state: ABOState, *,
                  config: ABOConfig, bounds=None) -> ABOState:
    """Advance a solve by exactly one pass, then resync the aggregates.

    ``state.x`` is updated IN PLACE and the returned state shares it; the
    other fields of ``state`` are left as they were.
    """
    cfg = config
    p = state.pass_idx
    half_width, lam = pass_schedule(cfg, p, state.aggs.dtype)
    x, aggs = _sweep_pass(obj, state.x, state.aggs, state.n_valid, half_width,
                          p, lam, cfg, bounds)
    # re-sync aggregates exactly once per pass: kills accumulated-delta
    # drift (one O(N) streaming scan per pass — amortized over m·N probes)
    aggs = obj.aggregates(x, state.n_valid, agg_dtype=state.aggs.dtype)
    slot = torch.arange(cfg.n_passes, device=x.device) == p
    hist = torch.where(slot, obj.combine(aggs), state.hist)
    return ABOState(x=x, aggs=aggs, hist=hist, pass_idx=p + 1,
                    n_valid=state.n_valid)


def abo_minimize(obj: SeparableObjective, n: int, *,
                 config: ABOConfig | None = None, x0=None,
                 dtype=torch.float32, seed: int | None = None, bounds=None,
                 device=None) -> ABOResult:
    """Minimize a separable objective with ABO on ``device`` (the card by
    default).

    Live memory is one padded solution vector of ``n`` ``dtype`` elements
    plus an O(block_size × samples_per_pass) probe tile. The start is the
    golden-section point unless ``x0`` or ``seed`` is given.
    ``config.use_kernel`` runs each pass as the CUDA sweep (Griewank,
    uniform bounds, no span decomposition; ``seed`` is ignored there, as in
    the reference).
    """
    dev = resolve_device(device)
    cfg = effective_config(config or ABOConfig(), n)
    if cfg.use_kernel:
        if obj.name != "griewank" or bounds is not None:
            raise NotImplementedError(
                "use_kernel supports the uniform-bounds Griewank benchmark; "
                "use the plain tensor path for other objectives")
        if cfg.span_coords is not None:
            raise NotImplementedError(
                "use_kernel does not implement the spanning decomposition "
                "(span_coords): the kernel carries aggregates across the "
                "whole pass with no shard-boundary reset; use the plain "
                "tensor path for spanning solves")
        from repro_torch.kernels.coord_sweep.ops import abo_minimize_kernel
        return abo_minimize_kernel(n, config=cfg, x0=x0, dtype=dtype,
                                   device=dev)

    n_pad = -(-n // cfg.block_size) * cfg.block_size
    x, bnds = _init_x(obj, n, n_pad, x0, dtype, seed, bounds, dev)
    state = abo_make_state(obj, x, n, cfg)
    for _ in range(cfg.n_passes):
        state = abo_pass_step(obj, state, config=cfg, bounds=bnds)
    # One exact O(N) re-evaluation so the reported optimum carries no
    # accumulated-delta rounding.
    fun = obj.combine(obj.aggregates(state.x, state.n_valid))
    fe = cfg.n_passes * cfg.samples_per_pass * n
    # repro: allow[RPR001] solve is complete; returning fun to the caller is
    # the designed end-of-run sync
    return ABOResult(x=state.x[:n], fun=float(fun), fe=fe, history=state.hist,
                     n=n, config=cfg)


def abo_minimize_blackbox(fun, n: int, lower: float, upper: float, *,
                          config: ABOConfig | None = None, x0=None,
                          dtype=torch.float32, device=None) -> ABOResult:
    """Black-box (non-separable) mode: each probe is one O(N) call of
    ``fun`` on a (n,) tensor, coordinates one at a time (Gauss-Seidel)."""
    dev = resolve_device(device)
    cfg = config or ABOConfig(block_size=1)
    m = cfg.samples_per_pass
    x = (torch.full((n,), 0.5 * (lower + upper), dtype=dtype, device=dev)
         if x0 is None else torch.as_tensor(x0, dtype=dtype, device=dev).clone())
    shrink = cfg.resolved_shrink()
    f_cur = fun(x)
    hist = torch.zeros((cfg.n_passes,), dtype=f_cur.dtype, device=dev)
    for p in range(cfg.n_passes):
        hw = 0.5 * shrink ** p           # fractional window
        for i in range(n):
            xi = x[i:i + 1].clone()
            cands = _candidate_grid(xi, lower, upper, hw, m, p == 0)[0]
            trial = x.clone()
            f_c = []
            for c in cands:
                trial[i] = c
                f_c.append(fun(trial))
            f_c = torch.stack(f_c)
            j = torch.argmin(f_c)
            better = f_c[j] <= f_cur
            x[i] = torch.where(better, cands[j], xi[0])
            f_cur = torch.minimum(f_c[j], f_cur)
        hist[p] = f_cur
    # repro: allow[RPR001] solve is complete; end-of-run sync (blackbox path)
    return ABOResult(x=x, fun=float(f_cur), fe=cfg.n_passes * m * n,
                     history=hist, n=n, config=cfg)
