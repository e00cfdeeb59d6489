"""Carry the reference's parameters (and AdamW state) into the port, and
map each port parameter onto the reference's leaves.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter pytree as
numpy arrays — ``jax.tree.map(np.asarray, repro.models.model.Model(cfg)
.init(key))`` — and returns a :class:`~repro_torch.models.model.Model`
holding the same numbers. Weights are ``(d_in, d_out)`` in both packages, so
each leaf is a plain copy. The reference stacks its repeated layer groups
along a leading ``n_groups`` axis (``decoder["groups"]``); they are
unstacked here into the per-layer modules, in layer order.
``opt_state_from_jax`` does the same for the reference's AdamW state.

``reference_leaves(cfg)`` lists the reference tree's leaves in
``jax.tree.flatten`` order (dict keys sorted, lists in order, a ``None``
subtree empty), each as the port parameters it holds: one, or for a
stacked group leaf one per group in group order. ``leaf_map(cfg)`` turns
that into ``{port name: (leaf index, flat offset in that leaf)}``, which
ABO-ZO's perturbation (``train.abo_zo``) needs to draw the reference's
random signs. No JAX is imported: the caller builds the numpy tree.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model


class _Stacked(tuple):
    """A reference leaf stacked over the groups: its port names in group
    order."""


def _names(module, prefix: str) -> dict:
    """The nested dict of a module's parameter names, keyed as its
    ParameterDict/ModuleDict."""
    out = {}
    for key in module.keys():
        sub = module[key]
        name = f"{prefix}.{key}"
        out[key] = (_names(sub, name) if isinstance(sub, torch.nn.Module)
                    else name)
    return out


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return _Stacked(trees)


def _reference_tree(cfg: ArchConfig, model) -> dict:
    """The reference's parameter tree with port names (or ``_Stacked``
    names) at its leaves."""
    head, n_groups, unit, tail = tfm.stack_layout(cfg)
    layer = [_names(lp, f"decoder.{i}") for i, lp in enumerate(model.decoder)]
    base = cfg.first_dense
    groups = ([_stack([layer[base + g * unit + j] for g in range(n_groups)])
               for j in range(unit)] if n_groups > 0 else None)
    tree = {"decoder": {"head": [layer[i] for i in head], "groups": groups,
                        "tail": [layer[i] for i in tail]},
            "embed": "embed",
            "norm_final": _names(model.norm_final, "norm_final")}
    if model.unembed is not None:
        tree["unembed"] = "unembed"
    if model.pos_embed is not None:
        tree["pos_embed"] = "pos_embed"
    return tree


def _flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, lists in
    order, ``None`` empty. ``_Stacked`` and anything not a dict, list or
    None is a leaf."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)
    walk(tree)
    return out


@functools.cache
def _layout(cfg: ArchConfig):
    model = Model(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    leaves = [(tuple(leaf), True) if isinstance(leaf, _Stacked)
              else ((leaf,), False)
              for leaf in _flatten(_reference_tree(cfg, model))]
    return leaves, shapes


def reference_leaves(cfg: ArchConfig) -> list[list[str]]:
    """The reference tree's leaves in flatten order, each as the list of
    port parameter names it holds (several for a stacked group leaf, in
    group order)."""
    return [list(names) for names, _ in _layout(cfg)[0]]


def leaf_map(cfg: ArchConfig) -> dict[str, tuple[int, int]]:
    """``{port name: (reference leaf index, flat offset in the leaf)}``:
    group g of a stacked leaf starts at g times one layer's numel."""
    leaves, shapes = _layout(cfg)
    out = {}
    for i, (names, _) in enumerate(leaves):
        for g, n in enumerate(names):
            out[n] = (i, g * int(np.prod(shapes[n], dtype=np.int64)))
    return out


def named_from_jax(cfg: ArchConfig, tree) -> dict[str, np.ndarray]:
    """A reference tree of numpy arrays (parameters, or one of AdamW's
    master/m/v trees) as ``{port name: array}``, stacked leaves split
    along their group axis."""
    leaves, shapes = _layout(cfg)
    arrays = _flatten(tree)
    if len(arrays) != len(leaves):
        raise ValueError(f"reference tree has {len(arrays)} leaves, the "
                         f"config {len(leaves)}")
    out = {}
    for (names, stacked), a in zip(leaves, arrays):
        a = np.asarray(a)
        if stacked and a.shape[:1] != (len(names),):
            raise ValueError(f"{names[0]}: reference leaf {a.shape} is not "
                             f"stacked over {len(names)} groups")
        parts = [a[g] for g in range(len(names))] if stacked else [a]
        for n, part in zip(names, parts):
            if tuple(part.shape) != shapes[n]:
                raise ValueError(f"{n}: reference shape {tuple(part.shape)}, "
                                 f"port shape {shapes[n]}")
            out[n] = part
    return out


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, tree: dict, *, device=None) -> Model:
    """The port's model for ``cfg`` holding the reference tree's numbers."""
    model = Model(cfg, device=device)
    named = named_from_jax(cfg, tree)
    for n, p in model.named_parameters():
        p.copy_(_tensor(named[n]).to(p.dtype))
    return model


def opt_state_from_jax(cfg: ArchConfig, state: dict, *, device=None) -> dict:
    """The reference's AdamW state (``repro.optim.adamw.init_state`` or a
    step's output, as numpy) as the port's: ``{"step", "master", "m",
    "v"}`` with per-parameter float32 tensors on ``device``."""
    dev = torch.device(device) if device is not None else None
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32)}
    for part in ("master", "m", "v"):
        out[part] = {n: _tensor(a).to(dev) if dev is not None else _tensor(a)
                     for n, a in named_from_jax(cfg, state[part]).items()}
    return out
