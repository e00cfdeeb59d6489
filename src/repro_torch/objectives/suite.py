"""Additional separable benchmark objectives (CEC-style large-scale suite).

Port of :mod:`repro.objectives.suite`: objectives with other curvature and
multimodality than Griewank, for the incremental algebra.
"""
from __future__ import annotations

import math

import torch

from repro_torch.objectives.base import SeparableObjective


def _sphere_terms(idx, x):
    return (x * x)[..., None]


SPHERE = SeparableObjective(
    name="sphere",
    n_aggs=1,
    terms=_sphere_terms,
    combine=lambda a: a[..., 0],
    lower=-100.0,
    upper=100.0,
)


def _rastrigin_terms(idx, x):
    # per-coordinate term x² − 10·cos(2πx); the "+10d" offset is added in
    # combine via a unit-count aggregate so padding/masking stays exact.
    # The Python scalar 2π is rounded to x's dtype, as jnp.asarray does.
    val = x * x - 10.0 * torch.cos((2.0 * math.pi) * x)
    one = torch.ones_like(x)
    return torch.stack([val, one], dim=-1)


RASTRIGIN = SeparableObjective(
    name="rastrigin",
    n_aggs=2,
    terms=_rastrigin_terms,
    combine=lambda a: a[..., 0] + 10.0 * a[..., 1],
    lower=-5.12,
    upper=5.12,
)


def _schwefel222_terms(idx, x):
    # Schwefel 2.22: Σ|x| + Π|x| — same log-product trick as Griewank.
    # The reference writes log(max(|x|, 1e-38)), but its platforms (XLA:CPU,
    # the TPU) flush subnormals to zero, and 1e-38 is a float32 subnormal:
    # there the clamp is max(|x|, 0) and log|x| is -inf at x = 0, so one
    # zero coordinate makes Π|x| exactly 0. Its solves from the golden start
    # (Π|x| overflows float32 at n = 500) escape only through that, so the
    # port flushes the same way on every device.
    a = torch.abs(x)
    tiny = torch.finfo(x.dtype).tiny
    floor = 1e-38 if 1e-38 >= tiny else 0.0
    log_a = torch.log(torch.clamp(torch.where(a < tiny, 0.0, a), min=floor))
    return torch.stack([a, log_a], dim=-1)


SCHWEFEL_222 = SeparableObjective(
    name="schwefel_2_22",
    n_aggs=2,
    terms=_schwefel222_terms,
    combine=lambda a: a[..., 0] + torch.exp(a[..., 1]),
    lower=-10.0,
    upper=10.0,
)


def _shifted_sphere_terms(idx, x):
    # CEC-style shifted optimum from the coordinate index (no O(N) shift
    # table). x*_i = 3·sin(idx+1) is off any symmetric sampling grid.
    shift = 3.0 * torch.sin((idx + 1).to(x.dtype))
    d = x - shift
    return (d * d)[..., None]


SHIFTED_SPHERE = SeparableObjective(
    name="shifted_sphere",
    n_aggs=1,
    terms=_shifted_sphere_terms,
    combine=lambda a: a[..., 0],
    lower=-100.0,
    upper=100.0,
)

REGISTRY = {o.name: o for o in (SPHERE, RASTRIGIN, SCHWEFEL_222, SHIFTED_SPHERE)}
