"""Decoder stack: per-layer modules in layer order, applied in a loop.

Port of :mod:`repro.models.transformer` for the decoders. The
reference groups layers into repeating pattern units and scans stacked
copies (``jax.lax.scan``); the port keeps one module per layer in an
``nn.ModuleList`` in layer index order (the reference's head, groups
unit-major and tail, concatenated) and loops over them. Caches are a list
in the same order, one dict per layer. ``stack_layout`` remains for
``models.params``, which unstacks the reference's groups. With ``remat``,
``stack_apply`` checkpoints each pattern unit of the groups (the units the
reference scans), not the head or tail layers, as the reference does.

Mixers ``attn``/``swa`` and ``rglru`` (``models.rglru``: RecurrentGemma's
(rglru, rglru, swa) pattern; its layer cache is ``{"rec": {"h", "conv"}}``
where an attention layer's is ``{"kv": ...}``); dense MLPs and MoE
(``models.moe``: the capacity from the config in ``layer_apply``, lossless
in ``layer_prefill`` and ``layer_decode``, as the reference). Mixer
``rwkv6`` with the ``channel_mix`` MLP (``models.rwkv6``; its layer cache is
``{"rec": {"S", "shift"}, "cmix_shift"}``, the channel mix's last normed
input beside the time mix's state, as the reference's). A layer's aux
loss is 0 unless it is an MoE layer; the leading ``first_dense`` layers
(moonshot's layer 0) keep a dense MLP. Cross-attention raises
``NotImplementedError`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import is_gated, make_norm, mlp_apply, mlp_init

_WAITS = "is not ported yet (ROADMAP queue 1, item 11: LM substrate)"


def _check_kinds(cfg: ArchConfig, kind: str, mlp_kind: str) -> None:
    if kind not in ("attn", "swa", "rglru", "rwkv6"):
        raise NotImplementedError(f"mixer {kind!r} {_WAITS}")
    if mlp_kind not in ("dense", "moe", "channel_mix"):
        raise NotImplementedError(f"{mlp_kind!r} MLP {_WAITS}")
    if cfg.cross_attention:
        raise NotImplementedError(f"cross-attention {_WAITS}")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------
def layer_init(cfg: ArchConfig, layer_idx: int, dtype, device) -> nn.ModuleDict:
    _check_kinds(cfg, cfg.mixer_kind(layer_idx), cfg.mlp_kind(layer_idx))
    norm_init, _ = make_norm(cfg.norm)
    p = {"norm_mixer": norm_init(cfg.d_model, dtype, device),
         "norm_mlp": norm_init(cfg.d_model, dtype, device)}
    if cfg.mixer_kind(layer_idx) == "rglru":
        p["rglru"] = rglru_mod.rglru_init(cfg, dtype, device)
    elif cfg.mixer_kind(layer_idx) == "rwkv6":
        p["rwkv"] = rwkv_mod.rwkv6_init(cfg, dtype, device)
    else:
        p["attn"] = attn.attn_init(cfg, dtype, device)
    if cfg.mlp_kind(layer_idx) == "moe":
        p["moe"] = moe_mod.moe_init(cfg, dtype, device)
    elif cfg.mlp_kind(layer_idx) == "channel_mix":
        p["cmix"] = rwkv_mod.channel_mix_init(cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, dtype, device,
                            is_gated(cfg.activation))
    return nn.ModuleDict(p)


def _ffn(params, cfg: ArchConfig, mlp_kind: str, h, capacity_factor):
    """The layer's MLP, MoE or full-sequence channel mix on the normed h.
    Returns (h, aux loss)."""
    if mlp_kind == "moe":
        return moe_mod.moe_apply(params["moe"], cfg, h,
                                 capacity_factor=capacity_factor)
    if mlp_kind == "channel_mix":
        out = rwkv_mod.channel_mix_full(params["cmix"], h)
    else:
        out = mlp_apply(params["mlp"], h, cfg.activation)
    return out, torch.zeros((), dtype=torch.float32, device=h.device)


def layer_apply(params, cfg: ArchConfig, kind: str, mlp_kind: str, x, *,
                positions, causal=True, cross_kv=None):
    """Full-sequence layer. Returns (x, aux_loss)."""
    _check_kinds(cfg, kind, mlp_kind)
    if cross_kv is not None:
        raise NotImplementedError(f"cross-attention {_WAITS}")
    _, norm = make_norm(cfg.norm)
    h = norm(params["norm_mixer"], x)
    if kind == "rglru":
        h = rglru_mod.rglru_apply(params["rglru"], cfg, h)
    elif kind == "rwkv6":
        h = rwkv_mod.rwkv6_apply(params["rwkv"], cfg, h)
    else:
        window = cfg.window if kind == "swa" else None
        h = attn.attn_apply(params["attn"], cfg, h, positions=positions,
                            window=window, causal=causal)
    x = x + h
    h, aux = _ffn(params, cfg, mlp_kind, norm(params["norm_mlp"], x), "cfg")
    return x + h, aux


# ---------------------------------------------------------------------------
# layer cache (decode)
# ---------------------------------------------------------------------------
def layer_cache_init(cfg: ArchConfig, kind: str, batch, max_len, dtype,
                     with_cross: bool, device=None):
    if with_cross:
        raise NotImplementedError(f"cross-attention {_WAITS}")
    _check_kinds(cfg, kind, "dense")
    if kind == "rglru":
        return {"rec": rglru_mod.rglru_state_init(batch, cfg, dtype,
                                                  device=device)}
    if kind == "rwkv6":
        return {"rec": rwkv_mod.rwkv6_state_init(batch, cfg, dtype,
                                                 device=device),
                "cmix_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                          device=device)}
    ring = min(max_len, cfg.window) if kind == "swa" and cfg.window else max_len
    return {"kv": attn.cache_init(attn.CacheSpec(
        batch, ring, cfg.n_kv_heads, cfg.head_dim, dtype, quant=cfg.kv_quant,
        device=device))}


def layer_decode(params, cfg: ArchConfig, kind: str, mlp_kind: str, x,
                 cache, pos):
    """One-token decode. x: (b, 1, d). Returns (x, cache)."""
    _check_kinds(cfg, kind, mlp_kind)
    _, norm = make_norm(cfg.norm)
    h = norm(params["norm_mixer"], x)
    if kind == "rglru":
        h, rec = rglru_mod.rglru_decode_step(params["rglru"], cfg, h,
                                             cache["rec"])
        cache = {**cache, "rec": rec}
    elif kind == "rwkv6":
        h, rec = rwkv_mod.rwkv6_decode_step(params["rwkv"], cfg, h,
                                            cache["rec"])
        cache = {**cache, "rec": rec}
    else:
        window = cfg.window if kind == "swa" else None
        h, kv = attn.attn_decode_step(params["attn"], cfg, h, cache["kv"],
                                      pos, window=window)
        cache = {**cache, "kv": kv}
    x = x + h
    h = norm(params["norm_mlp"], x)
    if mlp_kind == "channel_mix":
        h, shift = rwkv_mod.channel_mix_decode(params["cmix"], h,
                                               cache["cmix_shift"])
        return x + h, {**cache, "cmix_shift": shift}
    h, _ = _ffn(params, cfg, mlp_kind, h, None)
    return x + h, cache


def layer_prefill(params, cfg: ArchConfig, kind: str, mlp_kind: str, x, *,
                  positions, max_len):
    """Full-sequence layer that also emits the post-sequence decode cache."""
    _check_kinds(cfg, kind, mlp_kind)
    _, norm = make_norm(cfg.norm)
    h = norm(params["norm_mixer"], x)
    if kind == "rglru":
        h, rec = rglru_mod.rglru_prefill(params["rglru"], cfg, h)
        cache = {"rec": rec}
    elif kind == "rwkv6":
        h, rec = rwkv_mod.rwkv6_prefill(params["rwkv"], cfg, h)
        cache = {"rec": rec}
    else:
        window = cfg.window if kind == "swa" else None
        h, kv = attn.attn_prefill(params["attn"], cfg, h, positions=positions,
                                  window=window, max_len=max_len)
        cache = {"kv": kv}
    x = x + h
    h = norm(params["norm_mlp"], x)
    if mlp_kind == "channel_mix":
        cache["cmix_shift"] = h[:, -1].clone()   # the last normed input
    h, _ = _ffn(params, cfg, mlp_kind, h, None)
    return x + h, cache


# ---------------------------------------------------------------------------
# stack: one module per layer, in layer order
# ---------------------------------------------------------------------------
def stack_layout(cfg: ArchConfig):
    """(head_idxs, n_groups, unit_len, tail_idxs) over decoder layers."""
    head = list(range(cfg.first_dense))
    body = cfg.n_layers - cfg.first_dense
    unit = len(cfg.pattern)
    n_groups = body // unit
    tail_start = cfg.first_dense + n_groups * unit
    tail = list(range(tail_start, cfg.n_layers))
    return head, n_groups, unit, tail


def stack_init(cfg: ArchConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList([layer_init(cfg, i, dtype, device)
                          for i in range(cfg.n_layers)])


def _remat_wrap(fn, remat):
    """remat: False | True (full) | "save_collectives".

    True recomputes ``fn`` in the backward pass
    (``torch.utils.checkpoint``, non-reentrant). The reference's
    "save_collectives" keeps only the outputs of its cross-device
    collectives; on one device there is none to keep, so it is full
    remat here."""
    if not remat:
        return fn
    if remat not in (True, "save_collectives"):
        raise ValueError(f"remat must be False, True or 'save_collectives', "
                         f"not {remat!r}")

    def wrapped(*args):
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def stack_apply(layers, cfg: ArchConfig, x, *, positions, causal=True,
                cross_kv=None, remat=False):
    """Full-sequence stack. Returns (x, aux). ``remat`` recomputes each
    pattern unit of the groups in the backward pass (``_remat_wrap``)."""
    head, n_groups, unit, tail = stack_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(x, first, count):
        a_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(first, first + count):
            x, a = layer_apply(layers[i], cfg, cfg.mixer_kind(i),
                               cfg.mlp_kind(i), x, positions=positions,
                               causal=causal, cross_kv=cross_kv)
            a_sum = a_sum + a
        return x, a_sum

    unit_apply = _remat_wrap(lambda x, first: run(x, first, unit), remat)
    x, a = run(x, 0, len(head))
    aux = aux + a
    for g in range(n_groups):
        x, a = unit_apply(x, cfg.first_dense + g * unit)
        aux = aux + a
    x, a = run(x, len(head) + n_groups * unit, len(tail))
    return x, aux + a


def stack_prefill(layers, cfg: ArchConfig, x, *, positions, max_len):
    """Forward the whole stack, returning (x, per-layer caches)."""
    cache: list[dict[str, Any]] = []
    for i, lp in enumerate(layers):
        x, lc = layer_prefill(lp, cfg, cfg.mixer_kind(i), cfg.mlp_kind(i), x,
                              positions=positions, max_len=max_len)
        cache.append(lc)
    return x, cache


def stack_cache_init(cfg: ArchConfig, batch, max_len, dtype,
                     with_cross: bool = False, device=None):
    return [layer_cache_init(cfg, cfg.mixer_kind(i), batch, max_len, dtype,
                             with_cross, device=device)
            for i in range(cfg.n_layers)]


def stack_decode(layers, cfg: ArchConfig, x, cache, pos):
    """One-token decode through the whole stack. Returns (x, cache)."""
    new_cache = []
    for i, (lp, lc) in enumerate(zip(layers, cache)):
        x, lc = layer_decode(lp, cfg, cfg.mixer_kind(i), cfg.mlp_kind(i), x,
                             lc, pos)
        new_cache.append(lc)
    return x, new_cache
