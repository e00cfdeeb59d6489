"""ABO-ZO: the paper's algorithm as a zero-state neural-network optimizer.

Port of :mod:`repro.train.abo_zo` on one device, for a model that holds its
parameters (:class:`repro_torch.models.model.Model`). Each step probes
``m`` scaled versions of one shared random direction, step sizes a
symmetric linspace over the current trust window; the direction is never
stored, only regenerated from its key; the window shrinks geometrically.

The numbers are the reference's:

  * the direction: ``fold_in(key, step)`` split into one key per leaf of
    the reference's parameter tree (``jax.tree.flatten`` order), and a
    ``rademacher`` sign per leaf element, so a port parameter that is layer
    g of a stacked group leaf draws the signs at that leaf's flat offsets
    (``models.params.leaf_map``); the perturbed value is
    ``(p.f32 + scale·u).to(p.dtype)`` (``kernels.perturb``: the kernel P on
    the card, its plain version on the CPU);
  * ``base_scales = linspace(-1, 1, m)``, exact in float32; a candidate's
    scale is ``base_scales[i]·w`` in float32, and the window update
    ``max(w·shrink, min_window)`` is float32;
  * the incumbent's loss, then the m candidates' in order; a candidate wins
    only if strictly lower; the winner is re-applied from its key.

Memory follows the reference, not MeZO: each candidate is drawn out of
place from the incumbent into one probe buffer of the parameters' size
(perturbing in place and undoing it would not give the same bf16 bits),
and the probe's forward reads the buffer under ``torch.no_grad()``. The
peak is about twice the parameter bytes plus one forward. The winner is
written in place over the incumbent.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.abo import _M32, _threefry2x32
from repro_torch.kernels.perturb.ops import abo_zo_perturb
from repro_torch.models.params import leaf_map


@dataclasses.dataclass(frozen=True)
class ABOZOConfig:
    m_candidates: int = 9          # probes per step (incl. step-size 0)
    window: float = 1e-2           # initial trust half-width (relative step)
    shrink: float = 0.999          # per-step window decay
    min_window: float = 1e-5


# ---- jax.random's key arithmetic (threefry_partitionable), on host ints ----
def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with x64 off: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _M32


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: threefry of the counter (0, data)."""
    return _threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32)


def split_key(key, i: int) -> tuple[int, int]:
    """Key ``i`` of ``jax.random.split(key, n)`` for any ``n > i``: threefry
    of the counter (0, i)."""
    return _threefry2x32(int(key[0]), int(key[1]), 0, int(i))


def base_scales(m: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, m)`` in float32."""
    return np.linspace(-1.0, 1.0, m).astype(np.float32)


def init_state(cfg: ABOZOConfig) -> dict:
    """``{"step": int32, "window": float32}`` 0-d tensors on the host."""
    return {"step": torch.zeros((), dtype=torch.int32),
            "window": torch.tensor(cfg.window, dtype=torch.float32)}


def perturb_(dst: dict, src: dict, leaves: dict, dir_key, scale) -> None:
    """``dst[n] = (src[n].f32 + scale·u).to(dtype)`` for every name of
    ``src``, u the reference's signs: ``leaves[n]`` is n's (reference leaf
    index, flat offset), and leaf i's key is ``split(dir_key)[i]``.
    ``dst`` may be ``src``."""
    scale = np.float32(scale)
    for n, p in src.items():
        leaf, offset = leaves[n]
        abo_zo_perturb(dst[n], p, split_key(dir_key, leaf), offset, scale)


@contextlib.contextmanager
def _swapped(params: dict, probe: dict):
    """Run with each parameter's storage swapped for its probe buffer."""
    saved = {n: p.data for n, p in params.items()}
    try:
        for n, p in params.items():
            p.data = probe[n]
        yield
    finally:
        for n, p in params.items():
            p.data = saved[n]


def make_step(model, loss_fn: Callable, cfg: ABOZOConfig):
    """``loss_fn(batch) -> scalar`` over the model's current parameters.
    Returns ``step(state, batch, key) -> (state, metrics)``, which updates
    the model's parameters in place; ``key`` is the reference's (k0, k1)
    uint32 pair. metrics: ``loss`` (the best loss, a 0-d tensor on the
    model's device), ``incumbent`` (the step's loss before it), ``fe`` (m
    + 1 forward passes) and ``best`` (the winning candidate, -1 for the
    incumbent)."""
    m = cfg.m_candidates
    scales = base_scales(m)
    params = dict(model.named_parameters())
    leaves = leaf_map(model.cfg)
    if set(leaves) != set(params):
        raise ValueError("the model's parameters do not cover the "
                         "reference's leaves")
    probe = {n: torch.empty_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(state, batch, key):
        w = np.float32(state["window"].item())
        dir_key = fold_in(key, int(state["step"].item()))
        f0 = best_f = loss_fn(batch).float()         # the incumbent
        best_i = torch.full((), -1, dtype=torch.int64, device=best_f.device)
        for i in range(m):
            perturb_(probe, params, leaves, dir_key, scales[i] * w)
            with _swapped(params, probe):
                f = loss_fn(batch).float()
            better = f < best_f
            best_f = torch.where(better, f, best_f)
            best_i = torch.where(better, torch.full_like(best_i, i), best_i)
        win = int(best_i.item())
        if win >= 0:                     # re-apply the winner from its key
            perturb_(params, params, leaves, dir_key, scales[win] * w)
        new_state = {
            "step": state["step"] + 1,
            "window": torch.tensor(max(np.float32(w * np.float32(cfg.shrink)),
                                       np.float32(cfg.min_window)),
                                   dtype=torch.float32),
        }
        return new_state, {"loss": best_f, "incumbent": f0, "fe": m + 1,
                           "best": win}

    return step
