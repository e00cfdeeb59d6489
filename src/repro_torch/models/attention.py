"""Attention block: MHA/GQA/MQA, RoPE, SWA, the decode KV cache and
cross-attention.

Port of :mod:`repro.models.attention`. Prefill and full-sequence attention
go through K3 (``kernels.flash_attention.ops.flash_attention``: the CUDA
kernel on the card, its plain version on the CPU), the encoder's and the
decoder's cross-attention (``kv_override``, whisper) with ``causal=False``;
one-token decode attends its query against the cache, or against all the
cross keys, with plain matmuls, as the reference does. SWA decode keeps a
ring-buffer cache of ``window`` slots.

Not ported yet (ROADMAP queue 1, item 11): M-RoPE (qwen2-vl, step 4) and
the int8 KV cache (``kv_quant="int8"``, step 6).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30
_WAITS = "is not ported yet (ROADMAP queue 1, item 11 step {})"


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
    if cfg.mrope:
        raise NotImplementedError(f"M-RoPE {_WAITS.format(4)}")
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
    quant: str | None = None    # "int8" is not ported yet
    device: object = None


def cache_init(spec: CacheSpec):
    if spec.quant is not None:
        raise NotImplementedError(
            f"the {spec.quant} KV cache {_WAITS.format(6)}")
    shape = (spec.batch, spec.n_kv_heads, spec.max_len, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=spec.dtype, device=spec.device),
            "v": torch.zeros(shape, dtype=spec.dtype, device=spec.device)}


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
    """
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], hq, hd)               # (b, hq, 1, hd)
    if kv_override is None:
        q, k, v, valid = _ring_write(params, cfg, x, q, cache, int(pos),
                                     window)
    else:
        (k, v), valid = kv_override, None

    # GQA as (b, hkv, group, d) query groups: the cache is never repeated
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, hq // n_kv, hd)
    s = torch.matmul(qg, k.transpose(-1, -2)).float() * (hd ** -0.5)
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), v)                      # (b, hkv, g, hd)
    out = out.reshape(b, 1, hq * hd).to(x.dtype)
    return out @ params["wo"], cache


def _ring_write(params, cfg, x, q, cache, pos, window):
    """Write the token's key and value to its ring slot. Returns (q roped,
    the cache's k and v, the mask of slots the query may attend)."""
    if "k_scale" in cache:
        raise NotImplementedError(f"the int8 KV cache {_WAITS.format(6)}")
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k_new = _split_heads(x @ params["wk"], hkv, hd)          # (b, hkv, 1, hd)
    v_new = _split_heads(x @ params["wv"], hkv, hd)
    if cfg.use_rope:
        pos_ids = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new = _rope(cfg, q, k_new, pos_ids)
    max_len = cache["k"].shape[2]
    slot = pos % max_len
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
