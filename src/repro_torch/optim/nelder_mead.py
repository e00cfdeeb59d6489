"""Nelder-Mead downhill simplex — the paper's comparison baseline.

Port of :mod:`repro.optim.nelder_mead`. The textbook algorithm (Nelder &
Mead 1965, the family the paper took from TAO/PETSc): an (N+1)-vertex
simplex, so **O(N²) memory**, the property that makes it fail past
~1e4-1e5 variables on a laptop (paper Tables 1-2) and that ABO's O(N)
footprint is contrasted against.

Standard coefficients: reflect α=1, expand γ=2, outside-contract ρ=0.5,
shrink σ=0.5. Each iteration is the reference's ordered
reflect/expand/contract/shrink casework, vectorized over N, with the shrink
always evaluated and selected by ``where``.

The reference loops in one ``lax.while_loop``, which tests its condition on
the device. Here the iterations run in chunks of ``CHUNK`` between host
reads of the condition: each iteration computes the condition first and is
gated by it, so an iteration after the stop changes nothing (not the
simplex, its values, ``fe`` or the count). The result is the ``while``
loop's, iteration for iteration, whatever the chunk, with one host sync a
chunk instead of one an iteration. On the card, a small simplex's chunk
runs as one CUDA graph (``GRAPH_MAX_BYTES``), with the same kernels and
so the same bits.

``fun`` takes one ``(n,)`` tensor and returns a scalar; the simplex is
evaluated with ``torch.func.vmap(fun)``. The solve runs on ``x0``'s device
(a CPU tensor runs on the CPU); an ``x0`` that is not a tensor goes to the
card.
"""
# repro: hot-path — the simplex loop; its one host read a chunk is designed
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device

CHUNK = 64      # iterations between host reads of the loop's condition
# On the card a chunk is captured once as a CUDA graph and replayed where
# the simplex is at most this size: there an iteration's ~100 small
# launches, not its bytes, set the pace (2.1 ms an iteration at n = 200
# eagerly on an H100). Above it the iteration is bound by the simplex's
# bytes and runs eagerly.
GRAPH_MAX_BYTES = 16 << 20


@dataclasses.dataclass
class NMResult:
    x: torch.Tensor
    fun: float
    fe: int            # true O(N)-cost function evaluations
    iterations: int
    converged: bool


def simplex_bytes(n: int, dtype=torch.float32) -> int:
    """Theoretical NM working-set: the paper's O(N² + 6N + 1) analysis."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return itemsize * ((n + 1) * n + 6 * n + 1)


def _go(simplex, fvals, fe, max_fe, ftol, xtol) -> torch.Tensor:
    """The reference's ``while`` condition, a 0-d bool on the device.

    The x spread, max |simplex - simplex[0]|, is read from each column's
    extremes in one pass over the simplex: rounding is monotonic, so the
    largest rounded difference is the extreme's, and the value is the
    reference's."""
    f_spread = fvals.max() - fvals.min()
    lo, hi = torch.aminmax(simplex, dim=0)
    x_spread = torch.maximum(hi - simplex[0], simplex[0] - lo).max()
    return (fe < max_fe) & ((f_spread > ftol) | (x_spread > xtol))


def _iteration(fun, batched, state, max_fe, ftol, xtol):
    """One iteration of the reference's body, gated by its condition:
    where the condition is false, every part of the state is kept."""
    simplex, fvals, fe, it = state
    n = simplex.shape[1]
    go = _go(simplex, fvals, fe, max_fe, ftol, xtol)
    order = torch.argsort(fvals, stable=True)
    order = torch.where(go, order, torch.arange(n + 1, device=order.device))
    simplex = simplex[order]          # a fresh tensor: updated in place below
    fvals = fvals[order]
    best, worst, second = fvals[0], fvals[-1], fvals[-2]
    centroid = simplex[:-1].mean(dim=0)

    xr = centroid + (centroid - simplex[-1])                  # reflect
    fr = fun(xr)
    xe = centroid + 2.0 * (centroid - simplex[-1])            # expand
    xc = centroid + 0.5 * (simplex[-1] - centroid)            # contract
    do_expand = fr < best
    do_contract = fr >= second
    x_probe = torch.where(do_expand, xe, xc)
    f_probe = fun(x_probe)

    # Casework for replacing the worst vertex.
    accept_reflect = ~do_expand & ~do_contract
    take_expand = do_expand & (f_probe < fr)
    take_contract = do_contract & (f_probe < worst)
    take_probe = take_expand | take_contract
    take_r = accept_reflect | do_expand
    new_x = torch.where(take_probe, x_probe,
                        torch.where(take_r, xr, simplex[-1]))
    new_f = torch.where(take_probe, f_probe, torch.where(take_r, fr, worst))

    # Shrink everything toward the best vertex when contraction failed:
    # always evaluated (from the sorted simplex, before the replacement).
    # simplex[0] + 0.5·d in one pass: 0.5·d is exact (d not subnormal), so
    # a fused multiply-add rounds as the reference's two operations do.
    do_shrink = do_contract & (f_probe >= worst)
    shrunk = torch.add(simplex[:1], simplex - simplex[:1], alpha=0.5)
    f_shrunk = batched(shrunk)

    replace = go & ~do_shrink
    simplex[-1] = torch.where(replace, new_x, simplex[-1])
    fvals[-1] = torch.where(replace, new_f, fvals[-1])
    shrink = go & do_shrink
    rest = simplex[1:]                  # selected in place: no copy of it
    torch.where(shrink, shrunk[1:], rest, out=rest)
    fvals[1:] = torch.where(shrink, f_shrunk[1:], fvals[1:])
    step = 2 + torch.where(do_shrink, n, 0)     # fr + (fe|fc) [+ the shrink]
    fe = fe + torch.where(go, step, 0).to(fe.dtype)
    return simplex, fvals, fe, it + go.to(it.dtype)


def _graphed(fun, batched, state, chunk, max_fe, ftol, xtol):
    """``chunk`` gated iterations captured as one CUDA graph over static
    copies of the state. Returns (run, static): ``run(static)`` replays
    the graph, which writes the chunk's result back into ``static``."""
    static = tuple(t.clone() for t in state)
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream(static[0].device))
    with torch.cuda.stream(side):       # warm up outside the capture
        _iteration(fun, batched, static, max_fe, ftol, xtol)
    torch.cuda.current_stream(static[0].device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = static
        for _ in range(chunk):
            out = _iteration(fun, batched, out, max_fe, ftol, xtol)
        for dst, src in zip(static, out):
            dst.copy_(src)

    def run(st):
        graph.replay()
        return st
    return run, static


def nelder_mead(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0,
    *,
    max_fe: int = 2_000_000,
    ftol: float = 1e-10,
    xtol: float = 1e-10,
    memory_budget_bytes: int | None = None,
    stats: dict | None = None,
) -> NMResult:
    """Minimize ``fun`` from ``x0``.

    ``memory_budget_bytes`` reproduces the paper's crash rows without taking
    the host down: if the simplex alone would exceed the budget, raise
    ``MemoryError`` before anything is allocated. ``fe`` counts in int64
    for a float64 ``x0`` (the reference under x64), else int32. ``CHUNK``
    iterations run between host reads of the loop's condition; ``stats``,
    if given, receives ``host_reads`` (those reads, and the result's).
    """
    x0 = torch.as_tensor(x0, device=(x0.device if isinstance(x0, torch.Tensor)
                                     else resolve_device(None)))
    chunk = CHUNK
    n = int(x0.shape[0])
    if memory_budget_bytes is not None:
        need = simplex_bytes(n, x0.dtype)
        if need > memory_budget_bytes:
            raise MemoryError(
                f"Nelder-Mead simplex needs {need/1e9:.2f} GB for n={n} "
                f"(O(N²)); budget is {memory_budget_bytes/1e9:.2f} GB — "
                "this is the paper's NM crash regime.")
    dt, dev = x0.dtype, x0.device
    idt = torch.int64 if dt == torch.float64 else torch.int32
    batched = torch.func.vmap(fun)

    # Standard right-angled initial simplex: x0 plus h·e_i vertices.
    h = torch.where(x0 == 0, 0.00025, 0.05 * x0.abs()).to(dt)
    simplex = x0.expand(n + 1, n) + 0.0          # x0 + the zero off-diagonal
    simplex[1:].diagonal().add_(h)
    state = (simplex, batched(simplex), torch.tensor(n + 1, dtype=idt,
                                                     device=dev),
             torch.zeros((), dtype=idt, device=dev))
    ftol_t = torch.tensor(ftol, dtype=dt, device=dev)
    xtol_t = torch.tensor(xtol, dtype=dt, device=dev)
    def run(st):
        for _ in range(chunk):
            st = _iteration(fun, batched, st, max_fe, ftol_t, xtol_t)
        return st
    if dev.type == "cuda" and simplex_bytes(n, dt) <= GRAPH_MAX_BYTES:
        run, state = _graphed(fun, batched, state, chunk, max_fe, ftol_t,
                              xtol_t)
    reads = 1                                   # the result's, below
    while True:
        state = run(state)
        reads += 1
        # repro: allow[RPR001] the one designed read a chunk: has the loop stopped?
        if not bool(_go(*state[:3], max_fe, ftol_t, xtol_t)):
            break
    if stats is not None:
        stats["host_reads"] = reads
    simplex, fvals, fe, it = state
    i_best = torch.argmin(fvals)
    # repro: allow[RPR001] solve is complete; the result goes to the caller
    fe_i, it_i, f_best = int(fe), int(it), float(fvals[i_best])
    return NMResult(x=simplex[i_best], fun=f_best, fe=fe_i,
                    iterations=it_i, converged=not fe_i >= max_fe)
