"""S: the RG-LRU's gates and recurrence in one pass, the port-only kernel of
``csrc/rglru_scan.cu``, and its plain version.

``rglru_lru(u, xi, xr, log_lambda)`` takes the conv output u and the gate
products xi = u @ w_input_gate, xr = u @ w_rec_gate, contiguous (batch, T,
channels) of one type (bf16 or float32), and Λ (channels,); it returns h in
that type and the last step's h in float32 (``ref.rglru_lru_ref``). It
stands for ``_gates`` after its matrix products and
``jax.lax.associative_scan`` in ``src/repro/models/rglru.py``.

On a CUDA tensor it launches the kernel (one launch a call, counted in
``rglru_lru.launches``), whose bits are those of the plain version run on
the card; on a CPU tensor it runs the plain version. No fallback.

The gradient. Where grad mode is on and an input requires grad, the op is
a ``torch.autograd.Function`` that saves u, xi, xr and Λ (not h). Its
backward is S-bwd (``rglru_lru_bwd``): on a CUDA tensor the port-only
kernel of ``csrc/rglru_scan_bwd.cu`` (counted in
``rglru_lru_bwd.launches``), on a CPU tensor its plain version
``ref.rglru_lru_bwd_ref``. It returns du, dxi and dxr in the model's type
and dΛ in float32, summed over the batch and T in a fixed order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import (decay_rate,
                                                rglru_lru_bwd_ref,
                                                rglru_lru_ref)


@functools.cache
def _launcher():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_bwd():
    lib = _build.load("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


BWD_ROWS = 64       # S-bwd's tile of steps: one checkpoint of h a tile


def _check(what, tensors, dtypes) -> bool:
    """Raise on shapes, types or devices that neither version takes;
    return whether the tensors lie on the card."""
    shape = tuple(tensors[0].shape)
    if len(shape) != 3 or any(tuple(x.shape) != shape for x in tensors):
        raise ValueError(f"{what} takes (batch, T, channels) tensors of one "
                         f"shape, got {[tuple(x.shape) for x in tensors]}")
    if tensors[0].dtype not in dtypes or any(
            x.dtype != tensors[0].dtype for x in tensors):
        raise ValueError(f"{what} takes one type of {dtypes}, not "
                         f"{[x.dtype for x in tensors]}")
    if any(x.device != tensors[0].device for x in tensors):
        raise ValueError(f"{what}'s tensors lie on different devices")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def _kernel_takes(what, tensors) -> None:
    """Raise on what the kernel does not take: a stride, a channel count
    that is not a multiple of 16 bytes (8 bf16, 4 float32) or a row that
    is not 16-byte aligned."""
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}'s kernel needs contiguous tensors")
    size = tensors[0].element_size()
    if tensors[0].shape[-1] * size % 16 or any(
            x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{what}'s kernel takes channels in groups of "
                         f"{16 // size}, 16-byte aligned")


def _launch(u, xi, xr, nsp, h, last) -> bool:
    """One launch on the current stream; False where there is no work."""
    bsz, t, d = u.shape
    if u.numel() == 0:
        return False
    lib, fn = _launcher()
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), xi.data_ptr(), xr.data_ptr(),
                  nsp.data_ptr(), h.data_ptr(), last.data_ptr(), bsz, t, d,
                  int(u.dtype == torch.bfloat16),
                  torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, code, "rglru_scan")
    return True


def _forward(u, xi, xr, log_lambda):
    on_card = _check("rglru_lru", (u, xi, xr),
                     (torch.bfloat16, torch.float32))
    if tuple(log_lambda.shape) != (u.shape[2],) or \
            log_lambda.device != u.device:
        raise ValueError(f"rglru_lru takes Λ of shape ({u.shape[2]},) on "
                         f"{u.device}, got {tuple(log_lambda.shape)} on "
                         f"{log_lambda.device}")
    if not on_card:
        return rglru_lru_ref(u, xi, xr, log_lambda)
    _kernel_takes("rglru_lru", (u, xi, xr))
    nsp = decay_rate(log_lambda)
    h = torch.empty_like(u)
    last = (torch.empty if u.shape[1] else torch.zeros)(
        u.shape[0], u.shape[2], dtype=torch.float32, device=u.device)
    if _launch(u, xi, xr, nsp, h, last):
        rglru_lru.launches += 1
    return h, last


class _RGLRU(torch.autograd.Function):
    """S with S-bwd as its gradient; saves the inputs, not h."""

    @staticmethod
    def forward(ctx, u, xi, xr, log_lambda):
        ctx.save_for_backward(u, xi, xr, log_lambda)
        return _forward(u, xi, xr, log_lambda)

    @staticmethod
    def backward(ctx, dh, dlast):     # autograd materializes unused grads
        u, xi, xr, log_lambda = ctx.saved_tensors
        du, dxi, dxr, dlam = rglru_lru_bwd(u, xi, xr, log_lambda, dh, dlast)
        return du, dxi, dxr, dlam.to(log_lambda.dtype)


def rglru_lru(u: torch.Tensor, xi: torch.Tensor, xr: torch.Tensor,
              log_lambda: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (u, xi, xr, log_lambda)):
        return _RGLRU.apply(u, xi, xr, log_lambda)
    return _forward(u, xi, xr, log_lambda)


def rglru_lru_bwd(u, xi, xr, log_lambda, dh, dlast=None):
    """S-bwd: the gradient of ``rglru_lru`` at (dh, dlast), as
    ``ref.rglru_lru_bwd_ref`` returns it: (du, dxi, dxr) in u's type and dΛ
    (channels,) float32. On CUDA tensors the kernel of
    ``csrc/rglru_scan_bwd.cu`` (the wrapper takes what S takes, and dh of
    u's shape, type and layout): two CUDA kernels, the sweeps over T and
    then dΛ's fixed-order sum over the batch, counted as one launch; on
    CPU tensors the plain version. No fallback."""
    on_card = _check("rglru_lru_bwd", (u, xi, xr, dh),
                     (torch.bfloat16, torch.float32))
    if tuple(log_lambda.shape) != (u.shape[2],) or \
            log_lambda.device != u.device:
        raise ValueError(f"rglru_lru_bwd takes Λ of shape ({u.shape[2]},) "
                         f"on {u.device}, got {tuple(log_lambda.shape)}")
    if dlast is not None and (tuple(dlast.shape) != (u.shape[0], u.shape[2])
                              or dlast.device != u.device):
        raise ValueError(f"rglru_lru_bwd takes dlast of shape "
                         f"{(u.shape[0], u.shape[2])}, got "
                         f"{tuple(dlast.shape)}")
    if not on_card:
        return rglru_lru_bwd_ref(u, xi, xr, log_lambda, dh, dlast)
    if not dh.is_contiguous():
        dh = dh.contiguous()
    _kernel_takes("rglru_lru_bwd", (u, xi, xr, dh))
    bsz, t, d = u.shape
    lam = log_lambda.float().contiguous()
    nsp = decay_rate(log_lambda).contiguous()
    du, dxi, dxr = (torch.empty_like(u) for _ in range(3))
    dlam = torch.empty(d, dtype=torch.float32, device=u.device)
    if u.numel() == 0:
        return du, dxi, dxr, dlam.zero_()
    tiles = -(-t // BWD_ROWS)
    ckpt = torch.empty((bsz, tiles, d), dtype=torch.float32, device=u.device)
    part = torch.empty((bsz, d), dtype=torch.float32, device=u.device)
    dl = None if dlast is None else dlast.float().contiguous()
    lib, fn = _launcher_bwd()
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), xi.data_ptr(), xr.data_ptr(), nsp.data_ptr(),
                  lam.data_ptr(), dh.data_ptr(),
                  None if dl is None else dl.data_ptr(), ckpt.data_ptr(),
                  du.data_ptr(), dxi.data_ptr(), dxr.data_ptr(),
                  part.data_ptr(), dlam.data_ptr(), bsz, t, d,
                  int(u.dtype == torch.bfloat16),
                  torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, code, "rglru_scan_bwd")
    rglru_lru_bwd.launches += 1
    return du, dxi, dxr, dlam


def shortcut_mismatches(device) -> dict:
    """S's two shortcuts held on the card, as mismatch counts: its bf16
    sigmoid rule (a table for |x| in [2^-9, 128), constants outside)
    against ``torch.sigmoid`` on all 65536 bf16 inputs, and its square
    root (the library's fast path without its branch) against
    ``__fsqrt_rn`` on every float in [1e-12, 1]."""
    device = torch.device(device)
    lib, _ = _launcher()
    table = torch.empty(65536, dtype=torch.int16, device=device)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for name, ptr in (("rglru_sigmoid_bf16", table.data_ptr()),
                          ("rglru_sqrt_mismatches", count.data_ptr())):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _build.check(lib, fn(ptr, stream), name)
    x = torch.arange(65536, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16)
    want = torch.sigmoid(x).view(torch.int16)
    return {"sigmoid_bf16": int((table != want).sum()),
            "sqrt": int(count.item())}


rglru_lru.launches = 0
rglru_lru_bwd.launches = 0
