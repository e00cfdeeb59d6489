"""Public attention op: the GQA/SWA-aware wrapper of K3, which has four
CUDA forward kernels.

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
* ``flash_attention_sm90_d64`` (``csrc/flash_attention_sm90_d64.cu``: TMA,
  wgmma, 128-key blocks, two or three consumer warpgroups issuing their
  products in turns, a persistent grid, and for non-causal shapes with few
  query tiles a split of the keys combined in a second pass; ``d64_plan``
  picks the launch)
  for bf16 with head_dim 64 and the same alignment: whisper-small's
  encoder, decoder self- and cross-attention;
* ``flash_attention_mma`` (``csrc/flash_attention.cu``: mma.sync in bf16,
  CUDA cores in float32) for everything else it takes (head_dim a
  multiple of 8 up to 128).

Nothing else has a kernel: float32 (or unaligned bf16) at head_dim above
128 raises. There is no device probe, and no fallback from one kernel to
another or to the plain version. Each kernel wrapper counts its own
launches (``flash_attention_sm90.launches``,
``flash_attention_sm90_d256.launches``,
``flash_attention_sm90_d64.launches``, ``flash_attention_mma.launches``);
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
* ``flash_attention_bwd_sm90_d64`` (the same source at head_dim 64) where
  the forward took ``flash_attention_sm90_d64`` (whisper-small) and O and
  dO pass that test;
* ``flash_attention_bwd_sm90_d256`` (``csrc/flash_attention_bwd_sm90_d256.cu``:
  the head dim split between two consumer warpgroups, S and dP computed
  once and exchanged, a kv head's query heads split over CTAs as
  ``d256_bwd_plan`` says) where the forward took
  ``flash_attention_sm90_d256`` (recurrentgemma-2b's local attention) and
  O and dO pass that test;
* ``flash_attention_bwd_mma`` (``csrc/flash_attention_bwd.cu``: mma.sync
  in bf16, CUDA cores in float32) for everything else: float32, and bf16
  that is unaligned (at head_dim 256 too) or has no Hopper forward.

The reference has no backward kernel: its gradient through attention is
autodiff of ``attention_ref``, so the plain version of the backward is
autograd through ``flash_attention_plain``, and on a CPU tensor the op is
the plain version, autograd and all. Where no backward kernel takes
the inputs (a dtype other than float32 and bfloat16, head_dim not a
multiple of 8 up to 128 and not bf16 at 256), the op raises rather than
fall back.
``flash_attention_bwd.launches`` counts calls of its wrapper, and each
kernel wrapper its own: one call, one layer's backward, runs two to four
CUDA kernels. D, the row sum that every dS of a row subtracts, is
``rowsum(P·dP)`` in float32 from the same P and dP that dS is built from
(a first sweep of each Hopper kernel's dQ pass; a pass of the mma.sync
kernel's dQ kernel in bf16), and ``rowsum(dO·O)`` only in the mma.sync
kernel's float32 path: O rounded to bf16 would shift D, and dQ with it.
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
SM90_D64 = 64


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
def _launcher_sm90_d64():
    lib = _build.load("flash_attention_sm90_d64")
    fn = lib.flash_attention_sm90_d64_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


D64_BLOCK_K = 128       # keys a kv block of the head_dim 64 kernel
D64_MAX_SPLITS = 4
D64_MIN_SPLIT_BLOCKS = 4


def d64_units(b, hq, sq, sk, consumers, splits) -> tuple[int, list]:
    """The work of ``flash_attention_sm90_d64`` with ``consumers`` warpgroups
    a CTA and ``splits`` key splits: (the query tiles of 64 · consumers
    rows over the b·hq heads, the [start, end) kv block runs of the
    splits). A unit is a tile and one run, ``units = tiles · splits``; the
    kernel's launch cuts the runs as here (``per_split`` blocks each, the
    last one shorter), and its walk clips a run to a tile's causal or
    window range."""
    tiles = -(-sq // (64 * consumers)) * b * hq
    n_kb = -(-sk // D64_BLOCK_K)
    per = -(-n_kb // splits)
    return tiles, [(z * per, min(n_kb, (z + 1) * per)) for z in range(splits)]


@functools.cache
def d64_plan(b, hq, sq, sk, causal, window, sms) -> tuple[int, int, int]:
    """The launch of ``flash_attention_sm90_d64``: (consumer warpgroups a
    CTA, key splits, CTAs in the grid). A pure function of the shape and
    of ``sms``, the card's SMs (cached: the op asks it at every call).

    A CTA is 64 query rows a consumer warpgroup: three (192 rows) unless
    two (128 rows) pad sq to fewer rows. A unit of work is a query tile of
    one (batch, head) and one run of its kv blocks (``d64_units``). Where
    every tile sees every key (non-causal, no window), the kv blocks may be
    split in s runs, s in 1..4 and each run at least 4 blocks: the s that
    gives the fewest rounds of ``sms`` units times blocks a run, the
    smallest on a tie; else 1. A split adds a second pass that merges each
    row's runs. A CTA holds an SM alone (its registers), and the grid is
    persistent: the fewer of ``sms`` and the units, each CTA walking its
    units."""
    rows = {c: -(-sq // (64 * c)) * 64 * c for c in (2, 3)}
    consumers = 3 if rows[3] <= rows[2] else 2
    top = 1 if causal or window is not None else D64_MAX_SPLITS
    splits, best = 1, None
    for s in range(1, top + 1):
        tiles, runs = d64_units(b, hq, sq, sk, consumers, s)
        if s > 1 and runs[-1][1] - runs[-1][0] < D64_MIN_SPLIT_BLOCKS:
            continue
        cost = -(-tiles * s // sms) * (runs[0][1] - runs[0][0])
        if best is None or cost < best:
            best, splits = cost, s
    tiles, _ = d64_units(b, hq, sq, sk, consumers, splits)
    return consumers, splits, min(sms, tiles * splits)


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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 21
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_bwd_sm90_d256():
    lib = _build.load("flash_attention_bwd_sm90_d256")
    fn = lib.flash_attention_bwd_sm90_d256_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 21
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


D256_BWD_BLOCK = 64     # keys a dK/dV CTA and rows a dQ CTA at head_dim 256


def d256_bwd_units(b, hq, hkv, sk, splits) -> list[tuple]:
    """The dK/dV CTAs of ``flash_attention_bwd_sm90_d256`` with ``splits``
    CTAs a key block: (key block, batch, kv head, split, its query heads),
    in the grid's order (key block 0 first). Split z of kv head j takes
    query heads j·group + [z·per, min(group, (z + 1)·per)), per =
    ceil(group / splits); the partials' pass adds a key's splits in the
    order z = 0, 1, ..."""
    group = hq // hkv
    per = -(-group // splits)
    n_kb = -(-sk // D256_BWD_BLOCK)
    return [(kb, bi, j, z, tuple(range(j * group + z * per,
                                       j * group + min(group, (z + 1) * per))))
            for kb in range(n_kb) for bi in range(b) for j in range(hkv)
            for z in range(splits)]


@functools.cache
def d256_bwd_plan(b, hq, hkv, sk, sms) -> tuple[int, int]:
    """The group split of ``flash_attention_bwd_sm90_d256``: (splits, query
    heads a split). A pure function of the shape and of ``sms``, the
    card's SMs (cached: the op asks it at every call). A key block of 64
    keys has one dK/dV CTA a split; splits divide the group hq / hkv
    evenly, and the plan takes the split count with the fewest rounds of
    ``sms`` CTAs times query heads a CTA, the smaller on a tie (two at
    recurrentgemma-2b's 10/1 heads and 4096 keys: 128 CTAs of 5 heads).
    More than one split adds float32 partials of dK and dV and a pass that
    adds them in split order."""
    group = hq // hkv
    base = -(-sk // D256_BWD_BLOCK) * b * hkv
    best = splits = None
    for s in range(1, group + 1):
        if group % s:
            continue
        cost = -(-base * s // sms) * (group // s)
        if best is None or cost < best:
            best, splits = cost, s
    return splits, group // splits


def _tma_strides(t):
    """The (batch, head, sequence) element strides of a (b, h, s, d) view,
    with any stride of an extent-1 dimension (which addresses nothing)
    replaced by the packed one, so that the tensor map takes it. (Written
    out: every Hopper launch reads it several times.)"""
    b, h, s, d = t.shape
    sb, sh, ss = t.stride()[:3]
    return (h * s * d if b == 1 else sb, s * d if h == 1 else sh,
            d if s == 1 else ss)


def _tma_aligned(t) -> bool:
    """The last dimension contiguous, the base pointer 16-byte aligned and
    every other stride a multiple of 8 elements (16 bytes): the tensor
    map's rule."""
    sb, sh, ss = _tma_strides(t)
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and sb % 8 == 0
            and sh % 8 == 0 and ss % 8 == 0)


def choose_kernel(q, k, v) -> str:
    """Which CUDA kernel takes (q, k, v): for bf16 with non-empty
    sequences, the last dimension contiguous, every base pointer 16-byte
    aligned and every other stride a multiple of 8 elements (16 bytes, the
    tensor map's rule),
    ``"flash_attention_sm90"`` at head_dim 120 or 128,
    ``"flash_attention_sm90_d256"`` at 256 and
    ``"flash_attention_sm90_d64"`` at 64; else ``"flash_attention_mma"``
    (which refuses head_dim above 128). Reads only dtypes, shapes, strides
    and pointers: no device query."""
    d = q.shape[-1]
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and d in SM90_HEAD_DIMS + (SM90_D256, SM90_D64)
            and q.shape[2] > 0 and k.shape[2] > 0
            and all(_tma_aligned(t) for t in (q, k, v))):
        return {SM90_D256: "flash_attention_sm90_d256",
                SM90_D64: "flash_attention_sm90_d64"}.get(
                    d, "flash_attention_sm90")
    return "flash_attention_mma"


_BWD_OF = {"flash_attention_sm90": "flash_attention_bwd_sm90",
           "flash_attention_sm90_d64": "flash_attention_bwd_sm90_d64",
           "flash_attention_sm90_d256": "flash_attention_bwd_sm90_d256"}


def choose_bwd_kernel(q, k, v, out, dout) -> str:
    """Which backward kernel takes (q, k, v, O, dO): where
    ``choose_kernel(q, k, v)`` names a Hopper forward and ``out`` and
    ``dout`` are bf16 and pass the same alignment test, its Hopper
    backward (``"flash_attention_bwd_sm90"`` at head_dim 120 or 128,
    ``"flash_attention_bwd_sm90_d64"`` at 64,
    ``"flash_attention_bwd_sm90_d256"`` at 256); else
    ``"flash_attention_bwd_mma"``. Reads only dtypes, shapes, strides and
    pointers: no device query."""
    hopper = _BWD_OF.get(choose_kernel(q, k, v))
    if (hopper is not None and out.dtype == dout.dtype == torch.bfloat16
            and _tma_aligned(out) and _tma_aligned(dout)):
        return hopper
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
        dims = {"flash_attention_sm90": SM90_HEAD_DIMS,
                "flash_attention_sm90_d256": (SM90_D256,),
                "flash_attention_sm90_d64": (SM90_D64,)}[name]
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


def flash_attention_sm90_d64(q, k, v, *, causal=True, window=None,
                             lse=None):
    """The kernel of ``csrc/flash_attention_sm90_d64.cu`` (bf16, head_dim
    64) on CUDA tensors that ``choose_kernel`` sends to it; raises on any
    other. The launch is ``d64_plan``'s; with a key split the wrapper
    allocates the partial rows' float32 scratch and the call is two CUDA
    kernels (the split runs, then their merge), counted as one launch.
    ``lse`` as in ``flash_attention_mma``."""
    _check_sm90(q, k, v, window, "flash_attention_sm90_d64")
    return _routed_sm90_d64(q, k, v, causal=causal, window=window, lse=lse)


def _routed_sm90_d64(q, k, v, *, causal=True, window=None, lse=None):
    """``flash_attention_sm90_d64`` on the op's route, where ``_check`` has
    passed and ``choose_kernel`` has named it: the wrapper's checks would
    only repeat them, at each of whisper's 36 calls a forward."""
    b, hq, sq, _ = q.shape
    sk = k.shape[2]
    if sq == 0 or b * hq == 0:
        _lse_ptr(lse, q)
        return _new_out(q)
    plan = d64_plan(b, hq, sq, sk, causal, window, _sm_count(q.device.index))
    out = d64_call(q, k, v, causal, window, lse, *plan)
    flash_attention_sm90_d64.launches += 1
    return out


def d64_call(q, k, v, causal, window, lse, consumers, splits, ctas):
    """One call of the head_dim 64 kernel on inputs the wrapper has
    checked, with the launch (consumers, splits, CTAs), ``d64_plan``'s or
    another: returns the output. With a split, the partial rows' float32
    scratch is allocated here."""
    b, hq, sq, d = q.shape
    out = _new_out(q)
    part = None
    if splits > 1:
        part = torch.empty(splits * b * hq * sq * (d + 2),
                           dtype=torch.float32, device=q.device)
    lib, fn = _launcher_sm90_d64()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, k.shape[1], sq, k.shape[2], *_tma_strides(q),
                  *_tma_strides(k), *_tma_strides(v), *out.stride()[:3],
                  int(bool(causal)), int(window or 0),
                  d ** -0.5 * math.log2(math.e), _lse_ptr(lse, q),
                  consumers, splits, ctas,
                  None if part is None else part.data_ptr(), _stream(q))
    _build.check(lib, code, "flash_attention_sm90_d64")
    return out


_KERNELS = {"flash_attention_sm90": flash_attention_sm90,
            "flash_attention_sm90_d256": flash_attention_sm90_d256,
            "flash_attention_sm90_d64": _routed_sm90_d64,
            "flash_attention_mma": flash_attention_mma}


# ---------------------------------------------------------------- backward
def check_bwd(q) -> None:
    """Raise unless a backward kernel takes q's dtype and head_dim: float32
    or bfloat16 with head_dim a multiple of 8 up to 128, or bfloat16 at
    256 (the Hopper kernel where aligned, the mma.sync kernel's pairs of
    warps else)."""
    d = q.shape[-1]
    if not (q.dtype in _DTYPES and d % 8 == 0 and d <= 128
            or q.dtype == torch.bfloat16 and d == SM90_D256):
        raise ValueError(
            f"flash_attention's backward kernel takes float32 or bfloat16 "
            f"with head_dim a multiple of 8 up to 128, or bfloat16 at 256, "
            f"not {q.dtype} with head_dim {d}: no gradient is taken through "
            f"K3 here")


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
    """The kernel of ``csrc/flash_attention_bwd.cu``: a pass for each
    row's D (``rowsum(dO·O)`` in float32; ``rowsum(P·dP)`` in bf16, a pass
    of the dQ kernel), one CTA per (batch, kv head, kv block) for dK
    and dV over the group's query heads and every q block in order, one
    CTA per (batch, query head, q block) for dQ; mma.sync in bf16, CUDA
    cores in float32. Takes float32 or bfloat16 with d a multiple of 8 up
    to 128, or bfloat16 at 256, and any strides with the last dimension
    contiguous; arguments and result as ``flash_attention_bwd``."""
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


def _check_bwd_hopper(q, k, v, out, dout, lse, window, name):
    """The checks of a Hopper backward wrapper: CUDA tensors that
    ``choose_bwd_kernel`` sends to ``name``. Returns (b, hq, hkv, sk, d)."""
    b, hq, hkv, sk, d = _check_bwd_args(q, k, v, out, dout, lse, window,
                                        name)
    if choose_bwd_kernel(q, k, v, out, dout) != name:
        dims = {"flash_attention_bwd_sm90": SM90_HEAD_DIMS,
                "flash_attention_bwd_sm90_d64": (SM90_D64,),
                "flash_attention_bwd_sm90_d256": (SM90_D256,)}[name]
        raise ValueError(
            f"{name} takes bf16 with head_dim in {dims}, non-empty sequences "
            f"and 16-byte-aligned pointers and strides of q, k, v, out and "
            f"dout; got {q.dtype}, d = {d}, strides {q.stride()}, "
            f"{k.stride()}, {v.stride()}, {out.stride()}, {dout.stride()}")
    if b * hq > 65535:
        raise ValueError(f"batch x heads = {b * hq} exceeds the grid's 65535")
    return b, hq, hkv, sk, d


def _bwd_sm90_call(q, k, v, dout, lse, causal, window):
    """One call of ``csrc/flash_attention_bwd_sm90.cu`` (head_dim 64, 120
    or 128) on checked inputs: returns (dq, dk, dv)."""
    b, hq, sq, d = q.shape
    dq, dk, dv = _new_out(q), _new_out(k), _new_out(v)
    sq_pad = -(-sq // 128) * 128
    scratch = torch.empty(2 * b * hq * sq_pad, dtype=torch.float32,
                          device=q.device)
    lib, fn = _launcher_bwd_sm90()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(),
                  b, hq, k.shape[1], sq, k.shape[2], d, sq_pad,
                  *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
                  *_tma_strides(dout), *dq.stride()[:3], *dk.stride()[:3],
                  *dv.stride()[:3], int(bool(causal)), int(window or 0),
                  d ** -0.5, _stream(q))
    _build.check(lib, code, "flash_attention_bwd_sm90")
    return dq, dk, dv


def flash_attention_bwd_sm90(q, k, v, out, dout, lse, *, causal=True,
                             window=None):
    """The kernel of ``csrc/flash_attention_bwd_sm90.cu`` at head_dim 120
    or 128, on CUDA tensors that ``choose_bwd_kernel`` sends to it; raises
    on any other. Two CUDA kernels: one CTA per (batch·query head, 128
    query rows) for each row's D = rowsum(P·dP) (a first sweep over the
    keys, into float32 scratch padded to 128 rows with lse·log2(e)) and dQ
    (a second sweep); then one per (batch·kv head, 128 keys) for dK and dV
    (TMA ring of Q and dO tiles, wgmma). Arguments and result as
    ``flash_attention_bwd``."""
    b, hq, _, _, _ = _check_bwd_hopper(q, k, v, out, dout, lse, window,
                                       "flash_attention_bwd_sm90")
    if b * hq == 0:
        return _new_out(q), _new_out(k), _new_out(v)
    grads = _bwd_sm90_call(q, k, v, dout, lse, causal, window)
    flash_attention_bwd_sm90.launches += 1
    return grads


def flash_attention_bwd_sm90_d64(q, k, v, out, dout, lse, *, causal=True,
                                 window=None):
    """The kernel of ``csrc/flash_attention_bwd_sm90.cu`` at head_dim 64
    (whisper-small's attention: every tile one 64-dim box, four stages a
    ring), on CUDA tensors that ``choose_bwd_kernel`` sends to it; raises
    on any other. The launches of ``flash_attention_bwd_sm90``; arguments
    and result as ``flash_attention_bwd``."""
    b, hq, _, _, _ = _check_bwd_hopper(q, k, v, out, dout, lse, window,
                                       "flash_attention_bwd_sm90_d64")
    if b * hq == 0:
        return _new_out(q), _new_out(k), _new_out(v)
    grads = _bwd_sm90_call(q, k, v, dout, lse, causal, window)
    flash_attention_bwd_sm90_d64.launches += 1
    return grads


def flash_attention_bwd_sm90_d256(q, k, v, out, dout, lse, *, causal=True,
                                  window=None):
    """The kernel of ``csrc/flash_attention_bwd_sm90_d256.cu`` (bf16,
    head_dim 256) on CUDA tensors that ``choose_bwd_kernel`` sends to it;
    raises on any other. One CTA per (batch·query head, 64 rows) for D
    and dQ, then one per (key block of 64, batch·kv head, split) for dK and
    dV, the group split as ``d256_bwd_plan`` says; with more than one split
    the wrapper allocates float32 partials and a third CUDA kernel adds
    them, counted as one launch. Arguments and result as
    ``flash_attention_bwd``."""
    b, hq, hkv, sk, d = _check_bwd_hopper(q, k, v, out, dout, lse, window,
                                          "flash_attention_bwd_sm90_d256")
    sq = q.shape[2]
    dq, dk, dv = _new_out(q), _new_out(k), _new_out(v)
    if b * hq == 0:
        return dq, dk, dv
    splits, per = d256_bwd_plan(b, hq, hkv, sk, _sm_count(q.device.index))
    sq_pad = -(-sq // D256_BWD_BLOCK) * D256_BWD_BLOCK
    scratch = torch.empty(2 * b * hq * sq_pad, dtype=torch.float32,
                          device=q.device)
    part = None
    if splits > 1:
        part = torch.empty(2 * splits * b * hkv * sk * d,
                           dtype=torch.float32, device=q.device)
    lib, fn = _launcher_bwd_sm90_d256()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), scratch.data_ptr(),
                  None if part is None else part.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, sq_pad,
                  splits, per, *_tma_strides(q), *_tma_strides(k),
                  *_tma_strides(v), *_tma_strides(dout), *dq.stride()[:3],
                  *dk.stride()[:3], *dv.stride()[:3], int(bool(causal)),
                  int(window or 0), d ** -0.5, _stream(q))
    _build.check(lib, code, "flash_attention_bwd_sm90_d256")
    flash_attention_bwd_sm90_d256.launches += 1
    return dq, dk, dv


_BWD_KERNELS = {"flash_attention_bwd_sm90": flash_attention_bwd_sm90,
                "flash_attention_bwd_sm90_d64": flash_attention_bwd_sm90_d64,
                "flash_attention_bwd_sm90_d256": flash_attention_bwd_sm90_d256,
                "flash_attention_bwd_mma": flash_attention_bwd_mma}


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True,
                        window=None):
    """dQ, dK and dV of K3's function by the kernel that
    ``choose_bwd_kernel`` names (no fallback from one to the other).
    Deterministic: no atomics.

    q (b, hq, sq, d), k and v (b, hkv, sk, d), ``out`` and ``dout`` (b,
    hq, sq, d), any strides with the last dimension contiguous, float32 or
    bfloat16, d a multiple of 8 up to 128 (or bf16 at 256); ``lse`` the
    forward's (b, hq, sq) float32 log-sum-exp. Returns (dq, dk, dv) in q's
    dtype, each a
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
    256 and 16-byte-aligned pointers and strides; bf16 at d = 64, 120 and
    128 with that alignment goes to a Hopper kernel) the kernel that
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
flash_attention_sm90_d64.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_mma.launches = 0
flash_attention_bwd_sm90.launches = 0
flash_attention_bwd_sm90_d64.launches = 0
flash_attention_bwd_sm90_d256.launches = 0
