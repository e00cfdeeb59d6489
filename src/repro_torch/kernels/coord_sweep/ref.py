"""Plain PyTorch version of the coord_sweep kernel: one whole ABO pass.

A transcription of the JAX package's ``sweep_pass_ref`` (and of the
``_griewank_planes``/``_combine`` helpers of its kernel module): Gauss-Seidel
across blocks, Jacobi within a block, guarded commits, incumbent candidate
column, frozen padding. The CPU tests run it against the JAX oracle, and the
card's CUDA kernel is held against it. ``kernel_route`` is the loop of the
kernel-path solve, shared by ``ops.abo_minimize_kernel`` and its plain
version ``abo_minimize_kernel_ref``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.abo import ABOConfig, ABOResult
from repro_torch.device import resolve_device
from repro_torch.objectives.griewank import GRIEWANK

# aggregate lanes: [S, L, K] padded to one 128-lane vector for kernel i/o
AGG_LANES = 128


def _griewank_planes(idx, x):
    """Unstacked Griewank term planes (s, l, k) for any-shaped idx/x."""
    dt = x.dtype
    i1 = (idx + 1).to(dt)
    u = x * torch.rsqrt(i1)
    c = torch.cos(u)
    s2 = torch.square(torch.sin(u))
    log_abs = torch.where(
        s2 < 0.5,
        0.5 * torch.log1p(-torch.clamp(s2, max=0.999999)),
        torch.log(torch.clamp(torch.abs(c), min=1e-38)),
    )
    return x * x * (1.0 / 4000.0), log_abs, (c < 0).to(dt)


def _combine(s, log_abs, k, lam):
    positive = torch.remainder(k, 2.0) < 0.5
    return torch.where(positive, s - lam * torch.expm1(log_abs),
                       s + lam * (torch.exp(log_abs) + 1.0))


def sweep_pass_ref(x2d: torch.Tensor, aggs: torch.Tensor, *, m: int,
                   n_valid: int, lower: float, upper: float,
                   half_width: float, lam: float, is_first: bool):
    """One pass over ``x2d`` (n_blocks, B); ``aggs`` is (1, AGG_LANES).

    Like the kernel, it updates ``x2d`` IN PLACE and returns
    ``(x2d, aggs_out)``, aggs_out a new (1, AGG_LANES) tensor.
    """
    n_blocks, block = x2d.shape
    dt, dev = x2d.dtype, x2d.device
    s0, l0, k0 = aggs[0, 0], aggs[0, 1], aggs[0, 2]
    jlane = torch.arange(m, device=dev)[None, :].expand(block, m)
    rows = torch.arange(block, device=dev)[:, None].expand(block, m)
    offs = jlane.to(dt) * (2.0 / (m - 2)) - 1.0

    for blk in range(n_blocks):
        xb = x2d[blk].clone()
        bidx = blk * block + rows
        if is_first:
            center = torch.full((block,), 0.5 * (lower + upper), dtype=dt,
                                device=dev)
            hw = 0.5 * (upper - lower)
        else:
            center = xb
            hw = half_width
        cands = torch.clamp(center[:, None] + hw * offs, lower, upper)
        cands = torch.where(jlane == m - 1, xb[:, None], cands)
        valid = bidx < n_valid
        cands = torch.where(valid, cands, xb[:, None])

        s_new, l_new, k_new = _griewank_planes(bidx, cands)
        s_old, l_old, k_old = _griewank_planes(bidx[:, 0], xb)
        ds = s_new - s_old[:, None]
        dl = l_new - l_old[:, None]
        dk = k_new - k_old[:, None]
        f = _combine(s0 + ds, l0 + dl, k0 + dk, lam)

        sel = torch.argmin(f, dim=1)
        onehot = (jlane == sel[:, None]).to(dt)
        x_sel = torch.sum(cands * onehot, dim=1)
        s1 = s0 + torch.sum(ds * onehot)
        l1 = l0 + torch.sum(dl * onehot)
        k1 = k0 + torch.sum(dk * onehot)
        accept = _combine(s1, l1, k1, lam) <= _combine(s0, l0, k0, lam)

        x2d[blk] = torch.where(accept, x_sel, xb)
        s0 = torch.where(accept, s1, s0)
        l0 = torch.where(accept, l1, l0)
        k0 = torch.where(accept, k1, k0)

    aggs_out = torch.zeros_like(aggs)
    aggs_out[0, 0], aggs_out[0, 1], aggs_out[0, 2] = s0, l0, k0
    return x2d, aggs_out


def kernel_route(n: int, cfg: ABOConfig, x0, dtype, dev, *, sweep,
                 aggregates) -> ABOResult:
    """Griewank ABO as the JAX package's kernel path runs it, with ``sweep``
    (the arguments of ``ops.sweep_pass``) for each pass and ``aggregates``
    (``(x, n_valid=)`` -> (1, AGG_LANES)) for the initial aggregates and the
    exact final value.

    It starts from the golden-section point (or ``x0``), runs one pass per
    step of the λ schedule with no per-pass resync, and reads its history
    from the carried float32 aggregates.
    """
    bsz, m = cfg.block_size, cfg.samples_per_pass
    n_pad = -(-n // bsz) * bsz
    if x0 is None:
        x = torch.full((n_pad,), GRIEWANK.lower
                       + 0.6180339887 * (GRIEWANK.upper - GRIEWANK.lower),
                       dtype=dtype, device=dev)
    else:
        x = torch.zeros((n_pad,), dtype=dtype, device=dev)
        x[:n] = torch.as_tensor(x0, dtype=dtype, device=dev)
    x2d = x.view(-1, bsz)
    aggs = aggregates(x, n_valid=n)

    shrink = cfg.resolved_shrink()
    w0 = 0.5 * (GRIEWANK.upper - GRIEWANK.lower)
    hist = []
    for p in range(cfg.n_passes):
        lam = (p / (cfg.n_passes - 1)
               if cfg.coupling_schedule == "linear" and cfg.n_passes > 1
               else 1.0)
        x2d, aggs = sweep(x2d, aggs, m=m, n_valid=n,
                          half_width=w0 * shrink ** p, lam=lam,
                          is_first=(p == 0))
        hist.append(GRIEWANK.combine(aggs[0, :3]))

    fun = GRIEWANK.combine(aggregates(x, n_valid=n)[0, :3])
    return ABOResult(x=x[:n], fun=float(fun), fe=cfg.n_passes * m * n,
                     history=torch.stack(hist), n=n, config=cfg)


def abo_minimize_kernel_ref(n: int, *, config: ABOConfig | None = None,
                            x0=None, dtype=torch.float32,
                            device=None) -> ABOResult:
    """``ops.abo_minimize_kernel`` with the plain versions of both kernels,
    on ``device`` (the card by default): the yardstick the kernel route is
    held to on the card."""
    # imported here: griewank/ref.py takes AGG_LANES from this module
    from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
    sweep = functools.partial(sweep_pass_ref, lower=GRIEWANK.lower,
                              upper=GRIEWANK.upper)
    return kernel_route(n, config or ABOConfig(), x0, dtype,
                        resolve_device(device), sweep=sweep,
                        aggregates=griewank_aggregates_ref)
