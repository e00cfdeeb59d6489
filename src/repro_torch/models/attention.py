"""Attention block: MHA/GQA/MQA, RoPE and M-RoPE, SWA, the decode KV cache
(in the model's dtype or int8) and cross-attention.

Port of :mod:`repro.models.attention`. Prefill and full-sequence attention
go through K3 (``kernels.flash_attention.ops.flash_attention``: the CUDA
kernel on the card, its plain version on the CPU), the encoder's and the
decoder's cross-attention (``kv_override``, whisper) with ``causal=False``;
one-token decode attends its query against the cache, or against all the
cross keys, with plain matmuls, as the reference does. SWA decode keeps a
ring-buffer cache of ``window`` slots. qwen2-vl's M-RoPE rotates q and k
by (b, 3, t) position ids (``layers.apply_mrope``). An int8 cache
(``CacheSpec.quant="int8"``) holds each slot's key and value as int8
payloads with a float32 absmax scale, and decode folds the scales into the
scores and the probabilities, as the reference's does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init

NEG_INF = -1e30


def attn_init(cfg, dtype, device):
    d, hd = cfg.d_model, cfg.head_dim
    return nn.ParameterDict({
        "wq": dense_init(d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(cfg.n_heads * hd, d, dtype, device),
    })


def _split_heads(x, n_heads, head_dim):
    """(b, t, h·d) -> a (b, h, t, d) view."""
    b, t, _ = x.shape
    return x.view(b, t, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    """(b, h, t, d) -> (b, t, h·d); free for K3's output layout."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _rope(cfg, q, k, positions):
    if positions is None:
        return q, k
    if cfg.mrope and positions.dim() == 3:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    if positions.dim() == 3:           # mrope-shaped ids for a non-mrope arch
        positions = positions[:, 0]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _qkv(params, cfg, x, positions):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], hq, hd)
    k = _split_heads(x @ params["wk"], hkv, hd)
    v = _split_heads(x @ params["wv"], hkv, hd)
    if cfg.use_rope:
        q, k = _rope(cfg, q, k, positions)
    return q, k, v


def attn_apply(params, cfg, x, *, positions, window=None, causal=True,
               kv_override=None):
    """Full-sequence attention (training / prefill / encoder).

    kv_override: (k, v) for cross-attention — already projected encoder
    K/V (``cross_kv``), RoPE-free (whisper style).
    """
    if kv_override is None:
        q, k, v = _qkv(params, cfg, x, positions)
    else:
        q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
        k, v = kv_override
    out = flash_attention(q, k, v, causal=causal, window=window)
    return _merge_heads(out) @ params["wo"]


def cross_kv(params, cfg, enc_out):
    """Project the encoder output once; reused for every decode step.
    Returns (k, v), each a (b, hkv, Te, hd) view."""
    k = _split_heads(enc_out @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(enc_out @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v


def attn_prefill(params, cfg, x, *, positions, window=None, max_len=None):
    """Full-sequence attention that ALSO returns a filled ring cache.

    The ring holds the last min(T, ring) keys/values at slots pos % ring —
    exactly the state decode_step would have produced token by token, so
    decode continues seamlessly from pos = T.
    """
    b, t, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True, window=window)
    out = _merge_heads(out) @ params["wo"]

    ring = max_len if max_len else t
    if window:
        ring = min(ring, window)
    length = min(t, ring)
    slots = torch.arange(t - length, t, device=x.device) % ring
    shape = (b, cfg.n_kv_heads, ring, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=k.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=v.dtype, device=x.device)}
    cache["k"][:, :, slots] = k[:, :, t - length:]
    cache["v"][:, :, slots] = v[:, :, t - length:]
    return out, cache


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    batch: int
    max_len: int          # ring size: min(window, seq) for SWA
    n_kv_heads: int
    head_dim: int
    dtype: object
    quant: str | None = None    # "int8": per-slot absmax KV quantization
    device: object = None


def cache_init(spec: CacheSpec):
    """Zeroed k and v of (batch, n_kv_heads, max_len, head_dim) in
    ``spec.dtype``; with ``quant="int8"``, int8 k and v and float32
    ``k_scale`` and ``v_scale`` of (batch, n_kv_heads, max_len, 1): about
    half a bf16 cache's bytes. Another ``quant`` raises."""
    shape = (spec.batch, spec.n_kv_heads, spec.max_len, spec.head_dim)
    dev = spec.device
    if spec.quant == "int8":
        sshape = shape[:3] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev)}
    if spec.quant is not None:
        raise ValueError(f"unknown KV cache quantization {spec.quant!r}")
    return {"k": torch.zeros(shape, dtype=spec.dtype, device=dev),
            "v": torch.zeros(shape, dtype=spec.dtype, device=dev)}


def _quantize_slot(x):
    """(b, h, 1, d) -> (the int8 payload, the float32 absmax scale (b, h,
    1, 1)): round(x / (absmax / 127)), half to even, clamped to ±127; an
    all-zero slot keeps scale 0 (its payload 0)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a divisor on the device: CUDA divides by a Python scalar as a product
    # with its reciprocal, which is not the reference's rounding
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / safe), -127, 127)
    return q.to(torch.int8), scale


def attn_decode_step(params, cfg, x, cache, pos: int, *, window=None,
                     kv_override=None):
    """One-token decode. x: (b, 1, d); pos: the current position.

    Returns (out, cache). The new key and value go to slot ``pos %
    max_len`` of a ring buffer that is exact for SWA (only the last
    ``window`` keys can attend) and is a plain cache when max_len >= seq.
    Unlike the reference, which rewrites the whole cache through a mask
    (``where``) to keep its sharding stable, the port writes the one slot
    in place: ``cache`` is updated and returned, and no cache-sized copy is
    made per token. With ``kv_override`` (cross-attention) the query
    attends every one of the given keys, and ``cache`` is returned as it
    came (``None`` in the reference's call).

    An int8 cache (``"k_scale" in cache``) is read as the reference reads
    it: the scores are (q·k) · k_scale · hd^-0.5 in float32, and p ·
    v_scale goes into the float32 product with v. No dequantized cache is
    kept between steps: the float32 copy of this layer's int8 k (then v)
    made for its product is freed after it.
    """
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], hq, hd)               # (b, hq, 1, hd)
    if kv_override is None:
        q, k, v, valid = _ring_write(params, cfg, x, q, cache, int(pos),
                                     window)
    else:
        (k, v), valid = kv_override, None
    quantized = kv_override is None and "k_scale" in cache

    # GQA as (b, hkv, group, d) query groups: the cache is never repeated
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, hq // n_kv, hd)
    if quantized:
        s = torch.matmul(qg.float(), k.float().transpose(-1, -2))
        s = s * cache["k_scale"][:, :, None, :, 0] * (hd ** -0.5)
    else:
        s = torch.matmul(qg, k.transpose(-1, -2)).float() * (hd ** -0.5)
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if quantized:
        pv = p * cache["v_scale"][:, :, None, :, 0]           # fold v scales
        out = torch.matmul(pv, v.float())
    else:
        out = torch.matmul(p.to(v.dtype), v)                  # (b, hkv, g, hd)
    out = out.reshape(b, 1, hq * hd).to(x.dtype)
    return out @ params["wo"], cache


def _ring_write(params, cfg, x, q, cache, pos, window):
    """Write the token's key and value to its ring slot (an int8 cache's
    payloads and scales, ``_quantize_slot``). Returns (q roped, the cache's
    k and v, the mask of slots the query may attend)."""
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k_new = _split_heads(x @ params["wk"], hkv, hd)          # (b, hkv, 1, hd)
    v_new = _split_heads(x @ params["wv"], hkv, hd)
    if cfg.use_rope:
        pos_ids = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        if cfg.mrope:                  # a generated token: equal (t, h, w)
            pos_ids = pos_ids[:, None].expand(b, 3, 1)
        q, k_new = _rope(cfg, q, k_new, pos_ids)
    max_len = cache["k"].shape[2]
    slot = pos % max_len
    if "k_scale" in cache:
        for name, new in (("k", k_new), ("v", v_new)):
            payload, scale = _quantize_slot(new)
            cache[name][:, :, slot] = payload[:, :, 0]
            cache[f"{name}_scale"][:, :, slot] = scale[:, :, 0]
    else:
        cache["k"][:, :, slot] = k_new[:, :, 0]
        cache["v"][:, :, slot] = v_new[:, :, 0]

    # positions actually stored in each ring slot (for masking)
    slots = torch.arange(max_len, device=x.device)
    slot_pos = torch.where(slots <= slot, slots + (pos - slot),
                           slots + (pos - slot) - max_len)   # may be negative
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= (pos - slot_pos) < window
    return q, cache["k"], cache["v"], valid
