"""Separable-objective algebra: the incremental O(1)-probe interface ABO exploits.

Port of :mod:`repro.objectives.base`. An objective is *separable* when

    f(x) = combine( Σ_i terms(i, x_i) )

with ``terms(i, ·) -> R^{n_aggs}``. Probing a coordinate change x_i -> c then
costs O(1):

    f' = combine( aggs - terms(i, x_i) + terms(i, c) )

Products (Griewank's Π cos) are folded into the sum algebra via
log-magnitude + sign-parity aggregates.

The aggregate dtype is an explicit argument (default float32). The JAX
package picks it from its x64 flag; with x64 off, as its tests and engine
run, that is float32 too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Fixed reduction tile: every aggregate sum is a left fold, in index order,
# of (REDUCE_TILE, n_aggs) partial sums over tiles anchored at multiples of
# REDUCE_TILE, the last tile zero-padded to full width. The result then
# depends only on the masked content, not on the physical vector length.
REDUCE_TILE = 4096
# Tiles reduced per streamed chunk (1M coordinates): the only intermediate
# is (STREAM_TILES, REDUCE_TILE, n_aggs), never (n, n_aggs).
STREAM_TILES = 256


def tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` with an EXPLICIT balanced association tree (halve,
    add, repeat; an odd leftover rides along unmodified), so any two
    programs summing the same values get the same bits, whatever else
    the tensor holds: every add is elementwise, so the order depends on
    neither the other dimensions nor the device."""
    while x.shape[dim] > 1:
        k = x.shape[dim] // 2
        head = x.narrow(dim, 0, k) + x.narrow(dim, k, k)
        x = (head if x.shape[dim] == 2 * k
             else torch.cat([head, x.narrow(dim, 2 * k, 1)], dim))
    return x.select(dim, 0)


def fold_partials(partials: torch.Tensor) -> torch.Tensor:
    """Left-fold tile partials over the first axis in index order:
    ((0 + p_0) + p_1) + ... — the accumulation order of the reference's
    tile scan, add for add. Trailing axes ride along, so (T, L, n_aggs)
    partials of L lanes fold with one add per tile for all of them."""
    acc = torch.zeros_like(partials[0])
    for t in range(partials.shape[0]):
        acc = acc + partials[t]
    return acc


@dataclasses.dataclass(frozen=True)
class SeparableObjective:
    """A sum-decomposable objective with O(1) incremental probes.

    Attributes:
      name: identifier used by benchmarks/configs.
      n_aggs: number of scalar running aggregates.
      terms: ``terms(idx, x) -> (..., n_aggs)``; ``idx`` is the 0-based global
        coordinate index (an integer tensor), broadcastable against ``x``.
      combine: ``combine(aggs) -> f`` mapping (..., n_aggs) -> (...).
      lower/upper: uniform feasible bounds (paper's best case, s=1).
      combine_relaxed: optional homotopy ``combine_relaxed(aggs, lam)``,
        equal to ``combine`` at lam=1 and separable at lam=0.
    """

    name: str
    n_aggs: int
    terms: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    combine: Callable[[torch.Tensor], torch.Tensor]
    lower: float
    upper: float
    combine_relaxed: Callable[[torch.Tensor, object], torch.Tensor] | None = None

    REDUCE_TILE = REDUCE_TILE

    # ---- full evaluations ------------------------------------------------
    def _tile_sums(self, xt, first_tile, n_valid, agg_dtype):
        """Masked per-tile sums of a (..., rows, REDUCE_TILE) slab whose
        first row is tile ``first_tile``: (..., rows, n_aggs). ``n_valid``
        is a number, a 0-d tensor, or one count per leading index.

        Each tile is summed by :func:`tree_sum`, not ``.sum``: a reduction
        kernel picks its order from the slab's shape (on CUDA from the row
        count as well as the row length), and a tile must give the same
        bits alone, in a chunk of 256, or in a batch of gathered lanes."""
        rows, tile = xt.shape[-2:]
        idx = (first_tile * tile
               + torch.arange(rows * tile, device=xt.device)).view(rows, tile)
        t = self.terms(idx, xt).to(agg_dtype)
        if isinstance(n_valid, torch.Tensor) and n_valid.ndim:
            n_valid = n_valid[..., None, None]
        # where, not the reference's multiply by the mask: a masked -inf
        # term (Schwefel 2.22's log|0| in the zero tail) would make it NaN
        mask = (idx < n_valid)[..., None]
        return tree_sum(torch.where(mask, t, 0.0), dim=-2)

    def aggregates(self, x: torch.Tensor, n_valid=None, *, chunk_size=None,
                   agg_dtype=torch.float32) -> torch.Tensor:
        """Masked Σ_i terms(i, x_i) as fixed-origin tiles folded in order.

        Streams STREAM_TILES tiles at a time, so memory beyond the input is
        O(STREAM_TILES · REDUCE_TILE) and never an (n, n_aggs) intermediate
        (the paper's zero-RAM claim). Only the ragged tail tile is copied
        into a zero-padded REDUCE_TILE buffer. ``chunk_size`` is accepted
        for compatibility and ignored, as in the reference. ``n_valid`` may
        be an int or a 0-d integer tensor."""
        del chunk_size
        n_valid = x.shape[0] if n_valid is None else n_valid
        return self.row_aggregates(x[None], n_valid, agg_dtype=agg_dtype)[0]

    def row_aggregates(self, rows: torch.Tensor, n_valid, *,
                       agg_dtype=torch.float32) -> torch.Tensor:
        """:meth:`aggregates` of each row of an (L, width) batch at once:
        (L, n_aggs). ``n_valid`` is one count for every row (an int or a
        0-d tensor) or one per row (an (L,) tensor). Row i is bit for bit
        ``aggregates(rows[i], n_valid[i])``: the tile sums are
        shape-independent and the tiles fold in index order with one add
        per tile for every row, so the width may be any padding of a row's
        own length — tiles past it are masked zeros, and adding +0.0 to an
        accumulator that starts at +0.0 changes no bit."""
        tile = REDUCE_TILE
        n_rows, n = rows.shape
        n_full, tail = divmod(n, tile)
        parts = []
        for c0 in range(0, n_full, STREAM_TILES):
            k = min(STREAM_TILES, n_full - c0)
            xt = rows[:, c0 * tile:(c0 + k) * tile].reshape(n_rows, k, tile)
            parts.append(self._tile_sums(xt, c0, n_valid, agg_dtype))
        if tail:
            xt = torch.zeros((n_rows, 1, tile), dtype=rows.dtype,
                             device=rows.device)
            xt[:, 0, :tail] = rows[:, n_full * tile:]
            parts.append(self._tile_sums(xt, n_full, n_valid, agg_dtype))
        if not parts:
            return torch.zeros((n_rows, self.n_aggs), dtype=agg_dtype,
                               device=rows.device)
        return fold_partials(torch.cat(parts, dim=1).transpose(0, 1))

    def tile_partial(self, xc, tile_idx, n_valid, *, agg_dtype=torch.float32):
        """Masked partial sum of ONE fixed-origin reduction tile.

        ``xc`` is the (REDUCE_TILE,) slice anchored at global coordinate
        ``tile_idx * REDUCE_TILE``; content beyond the physical vector must
        be zeros. Same ops as the tile reduce inside :meth:`aggregates`."""
        return self._tile_sums(xc.view(1, -1), tile_idx, n_valid, agg_dtype)[0]

    def fold_tile_partials(self, partials, n_tiles, *, agg_dtype=torch.float32):
        """Left-fold tile partials in index order; rows at/beyond
        ``n_tiles`` are ignored. Where-guarded, not a masked add: adding a
        +0.0 row would flip a -0.0 accumulator bit."""
        acc = torch.zeros((self.n_aggs,), dtype=agg_dtype,
                          device=partials.device)
        for t in range(partials.shape[0]):
            acc = torch.where(torch.as_tensor(t < n_tiles, device=acc.device),
                              acc + partials[t].to(agg_dtype), acc)
        return acc

    def value(self, x: torch.Tensor, n_valid=None, **kw) -> torch.Tensor:
        return self.combine(self.aggregates(x, n_valid, **kw))

    def combine_at(self, aggs: torch.Tensor, lam) -> torch.Tensor:
        """combine under coupling weight lam (falls back to exact combine)."""
        if self.combine_relaxed is None:
            return self.combine(aggs)
        return self.combine_relaxed(aggs, lam)

    # ---- the O(1) probe --------------------------------------------------
    def probe(self, aggs, idx, old, new) -> torch.Tensor:
        """Objective after x[idx]: old -> new, other coordinates frozen.

        ``idx``/``old`` of shape (B,), ``new`` of shape (B, m) probes every
        candidate of every coordinate in the block at once."""
        return self.combine(aggs + self.term_delta(idx, old, new,
                                                   agg_dtype=aggs.dtype))

    def term_delta(self, idx, old, new, *, agg_dtype=torch.float32):
        """terms(idx, new) - terms(idx, old), broadcast to new's shape.

        ``terms(old)`` is evaluated once per coordinate and broadcast as a
        result, never recomputed per candidate."""
        extra = (1,) * (new.ndim - idx.ndim)
        idx_b = idx.reshape(idx.shape + extra).expand(new.shape)
        t_new = self.terms(idx_b, new).to(agg_dtype)
        t_old = self.terms(idx, old).to(agg_dtype)            # (..., n_aggs)
        t_old = t_old.reshape(old.shape + (1,) * (new.ndim - old.ndim)
                              + (self.n_aggs,))
        return t_new - t_old
