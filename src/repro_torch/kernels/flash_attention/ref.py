"""Plain PyTorch attention: dense attention + chunked (flash-semantics)
attention.

Port of :mod:`repro.kernels.flash_attention.ref`, with the same finite
``NEG_INF`` and the same casts: the dense version takes Q·Kᵀ in the input
dtype and casts the scores to float32; the chunked one upcasts q, k and v to
float32. Both are the plain versions the K3 wrapper runs on a CPU tensor
(``ops.flash_attention_plain``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _stable_softmax(s):
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    return p / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _mask(sq, sk, k_pos0, block, seq_len, causal, window, device):
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = k_pos0 + torch.arange(block, device=device)[None, :]
    mask = torch.ones((sq, block), dtype=torch.bool, device=device)
    if seq_len is not None:
        mask &= k_pos < seq_len
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def attention_ref(q, k, v, *, seq_len=None, causal=True, window=None,
                  sm_scale=None):
    """q: (..., sq, d); k, v: (..., sk, d), any equal leading dims."""
    d = q.shape[-1]
    sq, sk = q.shape[-2], k.shape[-2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    mask = _mask(sq, sk, 0, sk, seq_len, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = _stable_softmax(s)
    return torch.matmul(p.to(v.dtype), v)


def attention_ref_chunked(q, k, v, *, seq_len=None, causal=True, window=None,
                          sm_scale=None, block_k=1024):
    """Online-softmax attention over KV blocks of ``block_k`` in order, in
    float32; never materialises the (sq, sk) score matrix."""
    d = q.shape[-1]
    sq, sk = q.shape[-2], k.shape[-2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    n_blocks = -(-sk // block_k)
    pad = n_blocks * block_k - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    lead = q.shape[:-2]
    qf = q.float()
    m = torch.full(lead + (sq,), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros(lead + (sq,), dtype=torch.float32, device=q.device)
    acc = torch.zeros(lead + (sq, d), dtype=torch.float32, device=q.device)
    limit = sk if seq_len is None else seq_len
    for blk in range(n_blocks):
        k_c = k[..., blk * block_k:(blk + 1) * block_k, :].float()
        v_c = v[..., blk * block_k:(blk + 1) * block_k, :].float()
        s = torch.matmul(qf, k_c.transpose(-1, -2)) * sm_scale
        mask = _mask(sq, block_k, blk * block_k, block_k, limit, causal,
                     window, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_c)
        m = m_cur
    lsum = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    return (acc / lsum[..., None]).to(q.dtype)
