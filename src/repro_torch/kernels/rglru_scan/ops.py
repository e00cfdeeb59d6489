"""S: the RG-LRU's linear recurrence, the port-only kernel of
``csrc/rglru_scan.cu``, and its plain version.

``rglru_scan(a, b)`` returns ``h`` with ``h_t = a_t · h_{t-1} + b_t`` from
``h_{-1} = 0`` over the time axis of contiguous (batch, T, channels)
float32 tensors: the recurrence of ``models.rglru``, where the reference
runs ``jax.lax.associative_scan`` (``src/repro/models/rglru.py``). On a
CUDA tensor it launches the kernel (three CUDA kernels a call, counted once
in ``rglru_scan.launches``), whose bits are those of the plain version
(``ref.rglru_scan_ref``); on a CPU tensor it runs the plain version. No
fallback. The kernel has no backward: on a CUDA tensor that requires grad
the op raises rather than stop the gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import CHUNK, rglru_scan_ref


@functools.cache
def _launcher():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(a, b):
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"the scan takes two (batch, T, channels) tensors "
                         f"of one shape, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"the scan takes float32, not {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise ValueError("rglru_scan's kernel has no backward: no gradient "
                         "is taken through the RG-LRU on the card")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the scan's kernel needs contiguous tensors")
    bsz, t, d = a.shape
    out = torch.empty_like(a)
    chunks = -(-t // CHUNK)
    scratch = torch.empty(2 * bsz * chunks * d, dtype=torch.float32,
                          device=a.device)
    lib, fn = _launcher()
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), bsz, t, d,
                  torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
