"""Griewank benchmark (paper Eq. 3) — full, streaming, and separable forms.

    f(x) = Σ x_i²/4000 − Π cos(x_i/√i) + 1,   i = 1..d (1-based),
    domain x_i ∈ [-600, 600], global optimum f(0) = 0.

Port of :mod:`repro.objectives.griewank`. The product term is carried in
log-magnitude + sign-parity space so that the separable algebra applies and
the full evaluation stays stable at d ~ 1e9 (a naive Π underflows).
"""
from __future__ import annotations

import torch

from repro_torch.objectives.base import SeparableObjective

# |cos| is clamped before the log so that removing a term (agg - log|cos|)
# never produces inf - inf.
_LOG_TINY = {torch.float32: 1e-38, torch.float64: 1e-300}


def _terms(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-coordinate aggregate contributions: [x²/4000, log|cos|, 1{cos<0}].

    log|cos(u)| is ½·log1p(−sin²u) where |cos| is large — exact near the
    optimum (u→0), where the naive log(cos) loses the bits the paper's
    ~1e-13 best-objective values live in.
    """
    dt = x.dtype
    i1 = (idx + 1).to(dt)  # Griewank's i is 1-based
    u = x * torch.rsqrt(i1)
    c = torch.cos(u)
    s2 = torch.square(torch.sin(u))
    tiny = _LOG_TINY.get(dt, 1e-38)
    log_abs = torch.where(
        s2 < 0.5,
        0.5 * torch.log1p(-torch.clamp(s2, max=0.999999)),
        torch.log(torch.clamp(torch.abs(c), min=tiny)),
    )
    neg = (c < 0).to(dt)
    return torch.stack([x * x * (1.0 / 4000.0), log_abs, neg], dim=-1)


def _combine(aggs: torch.Tensor) -> torch.Tensor:
    """f = S − (−1)^K · exp(L) + 1 from aggs = [S, L, K]; the positive-sign
    branch uses expm1 for the +1 / −exp(L) cancellation near the optimum.
    ``remainder`` is floor-mod, as ``jnp.mod`` is."""
    s, log_p, k = aggs[..., 0], aggs[..., 1], aggs[..., 2]
    positive = torch.remainder(k, 2.0) < 0.5
    return torch.where(positive,
                       s - torch.expm1(log_p),
                       s + torch.exp(log_p) + 1.0)


def _combine_relaxed(aggs: torch.Tensor, lam) -> torch.Tensor:
    """Homotopy f_λ = S − λ·(−1)^K·exp(L) + λ:  f_0 = S (separable),
    f_1 = f exactly, and f_λ(x*) = 0 for every λ."""
    s, log_p, k = aggs[..., 0], aggs[..., 1], aggs[..., 2]
    positive = torch.remainder(k, 2.0) < 0.5
    return torch.where(positive,
                       s - lam * torch.expm1(log_p),
                       s + lam * (torch.exp(log_p) + 1.0))


GRIEWANK = SeparableObjective(
    name="griewank",
    n_aggs=3,
    terms=_terms,
    combine=_combine,
    lower=-600.0,
    upper=600.0,
    combine_relaxed=_combine_relaxed,
)


def griewank_naive(x: torch.Tensor) -> torch.Tensor:
    """Textbook direct evaluation (unstable for large d; test oracle only)."""
    i1 = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
    return (torch.sum(x * x, dim=-1) / 4000.0
            - torch.prod(torch.cos(x / torch.sqrt(i1)), dim=-1) + 1.0)


def griewank(x: torch.Tensor, n_valid=None, **kw) -> torch.Tensor:
    """Stable full evaluation via the aggregate form (streams in tiles)."""
    return GRIEWANK.value(x, n_valid, **kw)
