"""Public attention op: the GQA/SWA-aware wrapper of K3
(``csrc/flash_attention.cu``).

Port of :mod:`repro.kernels.flash_attention.ops`. On a CUDA tensor
``flash_attention`` launches the CUDA kernel; on a CPU tensor it runs the
plain version (``flash_attention_plain``), which chooses as the reference's
``impl="ref"`` does: dense ``attention_ref`` for ``sk <= 2048``, else the
chunked online softmax. There is no device probe and no fallback between
the two. ``flash_attention.launches`` counts the calls that launched the
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (b, h, s, d) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape)
            or hq % hkv != 0):
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit: want (b, hq, sq, d) "
                         "and (b, hkv, sk, d) with hkv dividing hq")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return b, hq, hkv, sk, d


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The plain version: kv heads repeated to the query heads
    (``jnp.repeat`` order), then dense attention for ``sk <= 2048`` and the
    chunked online softmax above."""
    _, hq, hkv, sk, _ = _check(q, k, v, window)
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if sk > 2048:
        return attention_ref_chunked(q, k, v, seq_len=sk, causal=causal,
                                     window=window)
    return attention_ref(q, k, v, seq_len=sk, causal=causal, window=window)


def flash_attention(q, k, v, *, causal=True, window=None):
    """Attention of q (b, hq, sq, d) over k, v (b, hkv, sk, d); hkv divides
    hq and query head h reads kv head h // (hq // hkv).

    The reference's ``block_q``/``block_k`` (its TPU tile sizes) are not
    taken: the kernel's tiles are fixed by its design, and the plain
    version's blocks are those of ``impl="ref"``.

    On a CUDA tensor (float32 or bfloat16, d a multiple of 8 up to 128, any
    strides with the last dimension contiguous) the kernel runs and returns
    a (b, hq, sq, d) view of a (b, sq, hq, d) buffer, so the caller's merge
    of the heads is free. Rows with no valid key come out as zeros there.
    """
    b, hq, hkv, sk, d = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to "
                         f"128, not {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs the last dimension contiguous")
    if b * hq > 65535:
        raise ValueError(f"batch x heads = {b * hq} exceeds the grid's 65535")
    sq = q.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if sq == 0 or b * hq == 0:
        return out
    vec16 = all(t.data_ptr() % 16 == 0
                and all(s % 8 == 0 for s in t.stride()[:3])
                for t in (q, k, v))
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], int(bool(causal)), int(window or 0),
                  d ** -0.5, int(vec16), stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
