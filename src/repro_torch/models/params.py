"""Carry the reference's parameters into the port's model.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter pytree as
numpy arrays — ``jax.tree.map(np.asarray, repro.models.model.Model(cfg)
.init(key))`` — and returns a :class:`~repro_torch.models.model.Model`
holding the same numbers. Weights are ``(d_in, d_out)`` in both packages, so
each leaf is a plain copy. The reference stacks its repeated layer groups
along a leading ``n_groups`` axis (``decoder["groups"]``); they are
unstacked here into the per-layer modules, in layer order. No JAX is
imported: the caller builds the numpy tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def _copy(dst: torch.Tensor, src, name: str) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def _copy_tree(module, tree, prefix: str) -> None:
    """Copy a reference subtree (nested dicts of arrays) into the
    ParameterDict/ModuleDict of the same keys."""
    for key, sub in tree.items():
        if isinstance(sub, dict):
            _copy_tree(module[key], sub, f"{prefix}.{key}")
        else:
            _copy(module[key], sub, f"{prefix}.{key}")


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, tree: dict, *, device=None) -> Model:
    """The port's model for ``cfg`` holding the reference tree's numbers."""
    model = Model(cfg, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy_tree(model.norm_final, tree["norm_final"], "norm_final")
    if model.unembed is not None:
        _copy(model.unembed, tree["unembed"], "unembed")
    if model.pos_embed is not None:
        _copy(model.pos_embed, tree["pos_embed"], "pos_embed")

    dec = tree["decoder"]
    head, n_groups, unit, tail = tfm.stack_layout(cfg)
    layers = list(dec["head"])
    for g in range(n_groups):
        for j in range(unit):
            unit_tree = dec["groups"][j]
            layers.append(_index_tree(unit_tree, g))
    layers += list(dec["tail"])
    if len(layers) != len(model.decoder):
        raise ValueError(f"reference tree has {len(layers)} layers, the "
                         f"config {len(model.decoder)}")
    for i, (lp, lt) in enumerate(zip(model.decoder, layers)):
        _copy_tree(lp, lt, f"decoder.{i}")
    return model


def _index_tree(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
