"""P: ABO-ZO's perturbation, the port-only kernel of
``csrc/abo_zo_perturb.cu``, and its plain version.

``abo_zo_perturb(dst, src, key, offset, scale)`` writes ``(src.f32 +
scale·u).to(dtype)`` into ``dst`` (which may be ``src``), with ``u = ±1``
the reference's ``jax.random.rademacher`` draw for the tensor's elements
inside one reference leaf: element j is leaf element ``offset + j``, whose
sign comes from bit 31 of ``threefry2x32(key, (c >> 32, c mod 2**32))``'s
``x0 ^ x1`` (``train.abo_zo`` derives the leaf key and
``models.params.leaf_map`` the offset). On a CUDA tensor it launches the
kernel (counted in ``abo_zo_perturb.launches``); on a CPU tensor it runs
``abo_zo_perturb_plain``, the same arithmetic with the port's threefry in
int64 torch ops (``core.abo._threefry2x32``), which is also the kernel's
plain version on the card. No fallback.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.abo import _M32, _threefry2x32
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS = 132 * 16          # a grid-stride loop over 16 CTAs an SM
_PLAIN_CHUNK = 1 << 22      # the plain version's elements a pass


@functools.cache
def _launcher():
    lib = _build.load("abo_zo_perturb")
    fn = lib.abo_zo_perturb_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_ulonglong, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(dst, src, key, offset):
    if (tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype
            or dst.device != src.device):
        raise ValueError(f"dst {tuple(dst.shape)} {dst.dtype} {dst.device} "
                         f"does not match src {tuple(src.shape)} {src.dtype} "
                         f"{src.device}")
    if src.dtype not in _DTYPES:
        raise ValueError(f"the perturbation takes float32 or bfloat16, not "
                         f"{src.dtype}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("the perturbation needs contiguous tensors")
    if not (0 <= offset and offset + src.numel() <= 2**64):
        raise ValueError(f"offset {offset} + {src.numel()} elements leaves "
                         "the 64-bit counter")
    if len(key) != 2 or any(not 0 <= int(k) <= _M32 for k in key):
        raise ValueError(f"key must be two uint32 words, not {key!r}")


def signs_plain(key, offset: int, n: int, device) -> torch.Tensor:
    """The float32 ±1 of elements [offset, offset + n) of a leaf drawn from
    ``key``: +1 where bit 31 of threefry2x32(key, counter)'s x0 ^ x1 is 0."""
    c = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    x0, x1 = _threefry2x32(int(key[0]), int(key[1]), c >> 32, c & _M32)
    return 1.0 - 2.0 * (((x0 ^ x1) >> 31) & 1).to(torch.float32)


@torch.no_grad()
def abo_zo_perturb_plain(dst, src, key, offset: int, scale):
    """The plain version, in chunks of ``_PLAIN_CHUNK`` elements."""
    _check(dst, src, key, offset)
    scale = float(np.float32(scale))
    s, d = src.view(-1), dst.view(-1)
    for a in range(0, s.numel(), _PLAIN_CHUNK):
        b = min(a + _PLAIN_CHUNK, s.numel())
        u = signs_plain(key, offset + a, b - a, src.device)
        d[a:b] = (s[a:b].float() + u * scale).to(dst.dtype)
    return dst


@torch.no_grad()
def abo_zo_perturb(dst, src, key, offset: int, scale):
    """``dst = (src.f32 + scale·u).to(dtype)`` (module docstring); returns
    ``dst``. ``scale`` is taken as float32."""
    _check(dst, src, key, offset)
    if src.device.type == "cpu":
        return abo_zo_perturb_plain(dst, src, key, offset, scale)
    if src.device.type != "cuda":
        raise ValueError(f"abo_zo_perturb runs on cuda or cpu, not "
                         f"{src.device}")
    n = src.numel()
    if n == 0:
        return dst
    lib, fn = _launcher()
    blocks = min(_BLOCKS, -(-n // 256))
    with torch.cuda.device(src.device):
        code = fn(src.data_ptr(), dst.data_ptr(), _DTYPES[src.dtype], n,
                  int(key[0]), int(key[1]), int(offset),
                  float(np.float32(scale)), blocks,
                  torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, code, "abo_zo_perturb")
    abo_zo_perturb.launches += 1
    return dst


abo_zo_perturb.launches = 0
