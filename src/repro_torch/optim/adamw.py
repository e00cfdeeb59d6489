"""AdamW with mixed precision and bf16 gradient compression — the
first-order baseline ABO-ZO is compared against.

Port of :mod:`repro.optim.adamw` on one device. Parameters are a dict of
named tensors (a model's ``named_parameters``), updated in place; the state
is a float32 master copy, m and v per parameter and an int32 step:

  * model params: bf16                            (2 bytes/param)
  * gradients: bf16 (``grad_compression="bf16"``) (2 bytes/param)
  * master + m + v: fp32                          (12 bytes/param)

ABO-ZO needs none of the fp32 state: that difference is the paper's
"zero-RAM" thesis made measurable. ``state_specs`` (ZeRO-1 sharding of the
state over the data-parallel axes) waits for ROADMAP queue 1, item 10
(multi-device).

The update per element is float32 with one rounding per operation, in the
reference's order of operations. The reference's XLA:CPU build contracts
some of its multiply-adds into FMAs, so on the CPU the two can differ by an
ulp in an element (tests/test_torch_train.py holds both).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params: dict) -> dict:
    """fp32 master (cast from the bf16 params) and zero moments, keyed as
    ``params``; the step is an int32 0-d tensor on the host."""
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
    }


def global_norm(grads: dict, leaf_groups=None) -> torch.Tensor:
    """sqrt of one float32 sum of squares over the gradients. Each group of
    ``leaf_groups`` (lists of names, default one name each, in ``grads``'
    order) is one leaf of the reference's tree, its members' sums added in
    order; the leaves' sums are added in the groups' order, as the
    reference's Python ``sum`` adds its leaves."""
    groups = leaf_groups or [[n] for n in grads]
    total = None
    for group in groups:
        leaf = None
        for n in group:
            s = grads[n].float().square().sum()
            leaf = s if leaf is None else leaf + s
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


def _f32(x) -> np.float32:
    return np.float32(x)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, in place. The card's ``sqrtf`` is;
    PyTorch's vectorized CPU sqrt can be an ulp off, so on the CPU it goes
    through float64, whose sqrt rounded to float32 is correctly rounded."""
    if x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()


def apply_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 *, leaf_groups=None):
    """Updates ``params`` and ``state`` in place from ``grads`` (bf16 after
    compression, or any float dtype). Returns ``(params, state, gnorm)``.

    Per element, with ``scale = min(1, grad_clip / (gnorm + 1e-9))`` and the
    bias corrections ``1 - b ** step`` in float32:
    ``g = g·scale; m = b1·m + (1-b1)·g; v = b2·v + (1-b2)·g²;
    master -= lr·(m̂ / (sqrt(v̂) + eps) + wd·master)``; the parameter is
    the master cast to its dtype."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads, leaf_groups)
    scale = torch.clamp(gnorm.new_full((), cfg.grad_clip)
                        / (gnorm + float(_f32(1e-9))), max=1.0)
    # The reference's scalars in float32 (a weak-typed Python float takes
    # the array's float32); the bias corrections are divisors on the
    # device, since PyTorch divides by a host scalar as a product with its
    # reciprocal on the card.
    b1, b2 = float(_f32(cfg.b1)), float(_f32(cfg.b2))
    c1, c2 = float(_f32(1 - cfg.b1)), float(_f32(1 - cfg.b2))
    b1c = _f32(1.0) - np.power(_f32(cfg.b1), _f32(step))
    b2c = _f32(1.0) - np.power(_f32(cfg.b2), _f32(step))
    lr, eps = float(_f32(cfg.lr)), float(_f32(cfg.eps))
    wd = float(_f32(cfg.weight_decay))
    div = {}
    for n, p in params.items():
        master, m, v = state["master"][n], state["m"][n], state["v"][n]
        if master.device not in div:
            div[master.device] = [torch.tensor(float(c), dtype=torch.float32,
                                               device=master.device)
                                  for c in (b1c, b2c)]
        d1, d2 = div[master.device]
        g = grads[n].float() * scale.to(master.device)
        m.mul_(b1).add_(g * c1)
        v.mul_(b2).add_(g.square_().mul_(c2))
        del g
        upd = torch.div(m, d1).div_(_sqrt_(torch.div(v, d2)).add_(eps))
        upd.add_(master * wd).mul_(lr)
        master.sub_(upd)
        del upd
        with torch.no_grad():
            p.copy_(master)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, gnorm
