"""Public attention op: the GQA/SWA-aware wrapper of K3, which has two
CUDA kernels.

Port of :mod:`repro.kernels.flash_attention.ops`. On a CPU tensor
``flash_attention`` runs the plain version (``flash_attention_plain``),
which chooses as the reference's ``impl="ref"`` does: dense
``attention_ref`` for ``sk <= 2048``, else the chunked online softmax. On a
CUDA tensor it launches the kernel that ``choose_kernel`` names for the
inputs' dtype, head_dim and alignment:

* ``flash_attention_sm90`` (``csrc/flash_attention_sm90.cu``: TMA, a ring
  of shared-memory stages, wgmma) for bf16 with head_dim 120 or 128 and
  16-byte-aligned pointers and strides: the dense models' prefill;
* ``flash_attention_sm90_d256`` (``csrc/flash_attention_sm90_d256.cu``:
  laid out for head_dim 256, 64-key blocks, K and V shared by a cluster of
  two CTAs, a persistent grid that ``d256_plan`` sizes) for bf16 with
  head_dim 256 and the same alignment: recurrentgemma-2b's local
  attention;
* ``flash_attention_mma`` (``csrc/flash_attention.cu``: mma.sync in bf16,
  CUDA cores in float32) for everything else it takes (head_dim a
  multiple of 8 up to 128).

Nothing else has a kernel: float32 (or unaligned bf16) at head_dim above
128 raises. There is no device probe, and no fallback from one kernel to
another or to the plain version. Each kernel wrapper counts its own
launches (``flash_attention_sm90.launches``,
``flash_attention_sm90_d256.launches``, ``flash_attention_mma.launches``);
``flash_attention.launches`` counts the op's launches of any.

The gradient. Where grad mode is on and q, k or v requires grad, the op
on a CUDA tensor is a ``torch.autograd.Function``: its forward is the
kernel ``choose_kernel`` names, which also writes each query row's
log-sum-exp (``lse``, float32, natural log of the sum of exp(s·sm_scale)),
and its backward is ``flash_attention_bwd`` (dQ, dK and dV from q, k, v,
O, dO and the lse; no atomics), which launches the port-only kernel that
``choose_bwd_kernel`` names:

* ``flash_attention_bwd_sm90`` (``csrc/flash_attention_bwd_sm90.cu``: TMA,
  rings of shared-memory stages, wgmma) where the forward took
  ``flash_attention_sm90`` and O and dO pass the same alignment test;
* ``flash_attention_bwd_mma`` (``csrc/flash_attention_bwd.cu``: mma.sync
  in bf16, CUDA cores in float32) for everything else.

The reference has no backward kernel: its gradient through attention is
autodiff of ``attention_ref``, so the plain version of the backward is
autograd through ``flash_attention_plain``, and on a CPU tensor the op is
the plain version, autograd and all. Where neither backward kernel takes
the inputs (a dtype other than float32 and bfloat16, head_dim not a
multiple of 8 up to 128), the op raises rather than fall back.
``flash_attention_bwd.launches`` counts calls of its wrapper, and each
kernel wrapper its own: one call, one layer's backward, runs three CUDA
kernels (the ``rowsum(dO·O)`` pre-pass, dK and dV, dQ).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


SM90_HEAD_DIMS = (120, 128)
SM90_D256 = 256


@functools.cache
def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_sm90():
    lib = _build.load("flash_attention_sm90")
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_sm90_d256():
    lib = _build.load("flash_attention_sm90_d256")
    fn = lib.flash_attention_sm90_d256_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _d256_slots(device_index: int) -> dict[int, int]:
    """How many clusters of 1 and of 2 CTAs of the head_dim 256 kernel the
    card holds at once (the CUDA occupancy query, once a device)."""
    lib = _build.load("flash_attention_sm90_d256")
    fn = lib.flash_attention_sm90_d256_slots
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    slots = {}
    with torch.cuda.device(device_index):
        for cluster in (1, 2):
            n = fn(cluster)
            if n <= 0:
                _build.check(lib, -n, "flash_attention_sm90_d256_slots")
                raise RuntimeError("flash_attention_sm90_d256 fits no "
                                   f"cluster of {cluster} on the card")
            slots[cluster] = n
    return slots


D256_BLOCK_Q = 128      # query rows a tile of the head_dim 256 kernel


def d256_tiles(b, hq, hkv, sq) -> tuple[int, int, int]:
    """The work of ``flash_attention_sm90_d256``: (CTAs a cluster, shared
    tiles, solo tiles), as its ``geometry`` counts them.

    A tile is 128 query rows of one (batch, query head). Where a kv head
    serves two or more query heads, the kernel runs clusters of 2: the two
    CTAs take the same query block of two heads of one group, a shared
    tile, and share each K and V tile (one load, multicast to both); a
    group's last head when the group is odd has no partner and is a solo
    tile, one CTA's. Where hq = hkv every tile is solo, and the cluster
    is 1."""
    group = hq // hkv
    cluster = 2 if group >= 2 else 1
    n_qb = -(-sq // D256_BLOCK_Q)
    pairs = group // 2 if cluster == 2 else 0
    return (cluster, n_qb * b * hkv * pairs,
            n_qb * b * hkv * (group - 2 * pairs))


def d256_plan(b, hq, hkv, sq, slots) -> tuple[int, int]:
    """The launch of ``flash_attention_sm90_d256``: (CTAs a cluster, CTAs
    in the grid). A pure function of the shape and of ``slots``, the
    clusters of each size the card holds at once. The grid is persistent:
    as many clusters as the card holds at once, or as there are tiles
    (``d256_tiles``) to give them (a cluster a shared tile, a CTA a solo
    tile), whichever is fewer."""
    cluster, n_shared, n_solo = d256_tiles(b, hq, hkv, sq)
    clusters = min(max(n_shared, -(-n_solo // cluster), 1), slots[cluster])
    return cluster, cluster * clusters


@functools.cache
def _launcher_bwd():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_bwd_sm90():
    lib = _build.load("flash_attention_bwd_sm90")
    fn = lib.flash_attention_bwd_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _tma_strides(t):
    """The (batch, head, sequence) element strides of a (b, h, s, d) view,
    with any stride of an extent-1 dimension (which addresses nothing)
    replaced by the packed one, so that the tensor map takes it."""
    packed = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
              t.shape[3])
    return tuple(p if n == 1 else st
                 for st, n, p in zip(t.stride()[:3], t.shape[:3], packed))


def _tma_aligned(t) -> bool:
    """The base pointer 16-byte aligned and every stride a multiple of 8
    elements (16 bytes): the tensor map's rule."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in _tma_strides(t))


def choose_kernel(q, k, v) -> str:
    """Which CUDA kernel takes (q, k, v): for bf16 with non-empty
    sequences, every base pointer 16-byte aligned and every stride a
    multiple of 8 elements (16 bytes, the tensor map's rule),
    ``"flash_attention_sm90"`` at head_dim 120 or 128 and
    ``"flash_attention_sm90_d256"`` at 256; else ``"flash_attention_mma"``
    (which refuses head_dim above 128). Reads only dtypes, shapes, strides
    and pointers: no device query."""
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in SM90_HEAD_DIMS + (SM90_D256,)
            and q.shape[2] > 0 and k.shape[2] > 0
            and all(_tma_aligned(t) for t in (q, k, v))):
        return ("flash_attention_sm90_d256" if q.shape[-1] == SM90_D256
                else "flash_attention_sm90")
    return "flash_attention_mma"


def choose_bwd_kernel(q, k, v, out, dout) -> str:
    """Which backward kernel takes (q, k, v, O, dO):
    ``"flash_attention_bwd_sm90"`` where ``choose_kernel(q, k, v)`` is
    ``"flash_attention_sm90"`` and ``out`` and ``dout`` are bf16 and pass
    the same alignment test, else ``"flash_attention_bwd_mma"``. Reads only
    dtypes, shapes, strides and pointers: no device query."""
    if (choose_kernel(q, k, v) == "flash_attention_sm90"
            and out.dtype == dout.dtype == torch.bfloat16
            and _tma_aligned(out) and _tma_aligned(dout)):
        return "flash_attention_bwd_sm90"
    return "flash_attention_bwd_mma"


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


def _new_out(q):
    """A (b, h, s, d) view of a (b, s, h, d) buffer, so the caller's merge
    of the heads (or split, for a gradient) is free."""
    b, hq, sq, d = q.shape
    return torch.empty((b, sq, hq, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lse_ptr(lse, q) -> int | None:
    """The pointer of an optional (b, hq, sq) contiguous float32 lse
    output, checked."""
    if lse is None:
        return None
    b, hq, sq, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 ({b}, {hq}, {sq}) "
                         f"tensor on {q.device}")
    return lse.data_ptr()


def flash_attention_mma(q, k, v, *, causal=True, window=None, lse=None):
    """The kernel of ``csrc/flash_attention.cu`` on CUDA tensors (float32
    or bfloat16, d a multiple of 8 up to 128, any strides with the last
    dimension contiguous); returns ``_new_out(q)`` filled. ``lse``, if
    given, receives each row's log-sum-exp; the output's bits are the same
    either way."""
    b, hq, hkv, sk, d = _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_mma runs on cuda, not {q.device}")
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
    out = _new_out(q)
    lse_ptr = _lse_ptr(lse, q)
    if sq == 0 or b * hq == 0:
        return out
    vec16 = _vec16(q, k, v)
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], int(bool(causal)), int(window or 0),
                  d ** -0.5, int(vec16), lse_ptr, _stream(q))
    _build.check(lib, code, "flash_attention")
    flash_attention_mma.launches += 1
    return out


def _vec16(*ts) -> bool:
    """Every base pointer 16-byte aligned and every (b, h, s) stride a
    multiple of 8 elements: the kernels' 16-byte loads."""
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:3]) for t in ts)


def _check_sm90(q, k, v, window, name):
    """The checks of a Hopper kernel's wrapper: CUDA tensors that
    ``choose_kernel`` sends to ``name``. Returns (b, hq, hkv, sk, d)."""
    b, hq, hkv, sk, d = _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda, not {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs the last dimension contiguous")
    if choose_kernel(q, k, v) != name:
        dims = SM90_HEAD_DIMS if name == "flash_attention_sm90" else (
            SM90_D256,)
        raise ValueError(
            f"{name} takes bf16 with head_dim in {dims} and 16-byte-aligned "
            f"pointers and strides; got {q.dtype}, d = {d}, strides "
            f"{q.stride()}, {k.stride()}, {v.stride()}")
    if b * hq > 65535:
        raise ValueError(f"batch x heads = {b * hq} exceeds the grid's 65535")
    return b, hq, hkv, sk, d


def flash_attention_sm90(q, k, v, *, causal=True, window=None, lse=None):
    """The kernel of ``csrc/flash_attention_sm90.cu`` on CUDA tensors that
    ``choose_kernel`` sends to it; raises on any other. ``lse`` as in
    ``flash_attention_mma``."""
    b, hq, hkv, sk, d = _check_sm90(q, k, v, window, "flash_attention_sm90")
    sq = q.shape[2]
    out = _new_out(q)
    lse_ptr = _lse_ptr(lse, q)
    if sq == 0 or b * hq == 0:
        return out
    lib, fn = _launcher_sm90()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, sk, d, *_tma_strides(q), *_tma_strides(k),
                  *_tma_strides(v), *out.stride()[:3], int(bool(causal)),
                  int(window or 0), d ** -0.5 * math.log2(math.e), lse_ptr,
                  _stream(q))
    _build.check(lib, code, "flash_attention_sm90")
    flash_attention_sm90.launches += 1
    return out


def flash_attention_sm90_d256(q, k, v, *, causal=True, window=None,
                              lse=None):
    """The kernel of ``csrc/flash_attention_sm90_d256.cu`` (bf16, head_dim
    256) on CUDA tensors that ``choose_kernel`` sends to it; raises on any
    other. ``lse`` as in ``flash_attention_mma``."""
    b, hq, hkv, sk, d = _check_sm90(q, k, v, window,
                                    "flash_attention_sm90_d256")
    sq = q.shape[2]
    out = _new_out(q)
    lse_ptr = _lse_ptr(lse, q)
    if sq == 0 or b * hq == 0:
        return out
    lib, fn = _launcher_sm90_d256()
    cluster, ctas = d256_plan(b, hq, hkv, sq, _d256_slots(q.device.index))
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, sk, *_tma_strides(q), *_tma_strides(k),
                  *_tma_strides(v), *out.stride()[:3], int(bool(causal)),
                  int(window or 0), d ** -0.5 * math.log2(math.e), lse_ptr,
                  cluster, ctas, _stream(q))
    _build.check(lib, code, "flash_attention_sm90_d256")
    flash_attention_sm90_d256.launches += 1
    return out


_KERNELS = {"flash_attention_sm90": flash_attention_sm90,
            "flash_attention_sm90_d256": flash_attention_sm90_d256,
            "flash_attention_mma": flash_attention_mma}


# ---------------------------------------------------------------- backward
def check_bwd(q) -> None:
    """Raise unless the backward kernel takes q's dtype and head_dim."""
    d = q.shape[-1]
    if q.dtype not in _DTYPES or d % 8 or d > 128:
        raise ValueError(
            f"flash_attention's backward kernel takes float32 or bfloat16 "
            f"with head_dim a multiple of 8 up to 128, not {q.dtype} with "
            f"head_dim {d}: no gradient is taken through K3 here")


def flash_attention_bwd_plain(q, k, v, dout, *, causal=True, window=None):
    """The plain version of the backward: autograd through
    ``flash_attention_plain`` (the reference's gradient through
    ``attention_ref``). Returns (dq, dk, dv)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(qq, kk, vv, causal=causal, window=window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _check_bwd_args(q, k, v, out, dout, lse, window, name):
    """Shapes, dtypes, devices and the lse of a backward kernel's call;
    returns (b, hq, hkv, sk, d)."""
    b, hq, hkv, sk, d = _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda, not {q.device}")
    for n, t in (("out", out), ("dout", dout)):
        if (tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(f"{n} must match q: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    _lse_ptr(lse, q)
    if any(t.stride(-1) != 1 for t in (q, k, v, out, dout)):
        raise ValueError("the kernel needs the last dimension contiguous")
    return b, hq, hkv, sk, d


def flash_attention_bwd_mma(q, k, v, out, dout, lse, *, causal=True,
                            window=None):
    """The kernel of ``csrc/flash_attention_bwd.cu``: a pre-pass for each
    row's ``rowsum(dO·O)``, one CTA per (batch, kv head, kv block) for dK
    and dV over the group's query heads and every q block in order, one
    CTA per (batch, query head, q block) for dQ; mma.sync in bf16, CUDA
    cores in float32. Takes float32 or bfloat16 with d a multiple of 8 up
    to 128 and any strides with the last dimension contiguous; arguments
    and result as ``flash_attention_bwd``."""
    b, hq, hkv, sk, d = _check_bwd_args(q, k, v, out, dout, lse, window,
                                        "flash_attention_bwd_mma")
    check_bwd(q)
    if b * hq > 65535:
        raise ValueError(f"batch x heads = {b * hq} exceeds the grid's 65535")
    sq = q.shape[2]
    dq, dk, dv = _new_out(q), _new_out(k), _new_out(v)
    if sq == 0 or sk == 0 or b * hq == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib, fn = _launcher_bwd()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
                  *dk.stride()[:3], *dv.stride()[:3], int(bool(causal)),
                  int(window or 0), d ** -0.5,
                  int(_vec16(q, k, v, out, dout)), _stream(q))
    _build.check(lib, code, "flash_attention_bwd_mma")
    flash_attention_bwd_mma.launches += 1
    return dq, dk, dv


def flash_attention_bwd_sm90(q, k, v, out, dout, lse, *, causal=True,
                             window=None):
    """The kernel of ``csrc/flash_attention_bwd_sm90.cu`` on CUDA tensors
    that ``choose_bwd_kernel`` sends to it; raises on any other. A pre-pass
    writes each row's ``rowsum(dO·O)`` and lse·log2(e) into float32 scratch
    padded to 128 rows; one CTA per (batch·kv head, 128 keys) for dK and
    dV (TMA ring of Q and dO tiles, wgmma); one per (batch·query head, 128
    query rows) for dQ. Arguments and result as ``flash_attention_bwd``."""
    b, hq, hkv, sk, d = _check_bwd_args(q, k, v, out, dout, lse, window,
                                        "flash_attention_bwd_sm90")
    if choose_bwd_kernel(q, k, v, out, dout) != "flash_attention_bwd_sm90":
        raise ValueError(
            f"flash_attention_bwd_sm90 takes bf16 with head_dim in "
            f"{SM90_HEAD_DIMS}, non-empty sequences and 16-byte-aligned "
            f"pointers and strides of q, k, v, out and dout; got {q.dtype}, "
            f"d = {d}, strides {q.stride()}, {k.stride()}, {v.stride()}, "
            f"{out.stride()}, {dout.stride()}")
    sq = q.shape[2]
    dq, dk, dv = _new_out(q), _new_out(k), _new_out(v)
    if b * hq == 0:
        return dq, dk, dv
    sq_pad = -(-sq // 128) * 128
    scratch = torch.empty(2 * b * hq * sq_pad, dtype=torch.float32,
                          device=q.device)
    lib, fn = _launcher_bwd_sm90()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, hq, hkv, sq, sk, d, sq_pad,
                  *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
                  *_tma_strides(out), *_tma_strides(dout), *dq.stride()[:3],
                  *dk.stride()[:3], *dv.stride()[:3], int(bool(causal)),
                  int(window or 0), d ** -0.5, _stream(q))
    _build.check(lib, code, "flash_attention_bwd_sm90")
    flash_attention_bwd_sm90.launches += 1
    return dq, dk, dv


_BWD_KERNELS = {"flash_attention_bwd_sm90": flash_attention_bwd_sm90,
                "flash_attention_bwd_mma": flash_attention_bwd_mma}


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True,
                        window=None):
    """dQ, dK and dV of K3's function by the kernel that
    ``choose_bwd_kernel`` names (no fallback from one to the other).
    Deterministic: no atomics.

    q (b, hq, sq, d), k and v (b, hkv, sk, d), ``out`` and ``dout`` (b,
    hq, sq, d), any strides with the last dimension contiguous, float32 or
    bfloat16, d a multiple of 8 up to 128; ``lse`` the forward's (b, hq,
    sq) float32 log-sum-exp. Returns (dq, dk, dv) in q's dtype, each a
    (b, h, s, d) view of a (b, s, h, d) buffer. On CPU tensors it is
    ``flash_attention_bwd_plain`` (``out`` and ``lse`` unused)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    kernel = _BWD_KERNELS[choose_bwd_kernel(q, k, v, out, dout)]
    grads = kernel(q, k, v, out, dout, lse, causal=causal, window=window)
    flash_attention_bwd.launches += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    """K3 on CUDA tensors with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        b, hq, sq, _ = q.shape
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        out = _KERNELS[choose_kernel(q, k, v)](q, k, v, causal=causal,
                                                window=window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=None):
    """Attention of q (b, hq, sq, d) over k, v (b, hkv, sk, d); hkv divides
    hq and query head h reads kv head h // (hq / hkv).

    The reference's ``block_q``/``block_k`` (its TPU tile sizes) are not
    taken: the kernels' tiles are fixed by their design, and the plain
    version's blocks are those of ``impl="ref"``.

    On a CUDA tensor (float32 or bfloat16 with d a multiple of 8 up to 128
    and any strides with the last dimension contiguous, or bf16 with d =
    256 and 16-byte-aligned pointers and strides) the kernel that
    ``choose_kernel`` names runs and returns a (b, hq, sq, d) view of a
    (b, sq, hq, d) buffer, so the caller's merge of the heads is free. Rows
    with no valid key come out as zeros there. Where grad mode is on and an
    input requires grad, the kernel also keeps each row's log-sum-exp and
    the gradient is ``flash_attention_bwd``'s (the module docstring).
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_bwd(q)
        out = _FlashAttention.apply(q, k, v, causal, window)
    else:
        out = _KERNELS[choose_kernel(q, k, v)](q, k, v, causal=causal,
                                                window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention_mma.launches = 0
flash_attention_sm90.launches = 0
flash_attention_sm90_d256.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_mma.launches = 0
flash_attention_bwd_sm90.launches = 0
