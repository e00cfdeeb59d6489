"""W: RWKV6's WKV recurrence, the port-only kernel of ``csrc/rwkv6_wkv.cu``,
and its plain version.

``rwkv6_wkv(r, k, v, logw, u)`` takes r, k, v contiguous (b, T, H, hd) of
one type (bf16 or float32), logw of that shape and u (H, hd), both
float32, and returns y float32 (b, T, H, hd) and the last state float32
(b, H, hd, hd), from a zero state (``ref.wkv_ref``). hd is 16 or 64. It
stands for the ``jax.lax.scan`` of ``rwkv6_apply`` and ``rwkv6_prefill``
in ``src/repro/models/rwkv6.py``.

On a CUDA tensor it launches the kernel (one launch a call, counted in
``rwkv6_wkv.launches``): the recurrence in chunks of 16 steps, the chunk's
products with the state and with v on the tensor cores in split TF32, a
cluster of hd / 16 CTAs a head (``ref.wkv_chunked`` is its arithmetic in
plain PyTorch). It is held to the plain version by a tolerance, not bit
for bit; two runs give the same bits. On a CPU tensor it runs the plain
version. No fallback. The kernel has no backward: on a CUDA tensor that
requires grad the op raises rather than stop the gradient. Its tiles
arrive by TMA, so r, k, v and logw must start on 16 bytes.
"""
# repro: hot-path — RWKV6's prefill and forward; no host sync by construction
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref

HEAD_DIMS = (16, 64)


@functools.cache
def _launcher():
    lib = _build.load("rwkv6_wkv")
    fn = lib.rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(r, k, v, logw, u) -> bool:
    """Raise on shapes, types or devices that neither version takes;
    return whether the tensors lie on the card."""
    shape = tuple(r.shape)
    if len(shape) != 4 or any(tuple(x.shape) != shape for x in (k, v, logw)):
        raise ValueError(f"rwkv6_wkv takes r, k, v, logw of one (b, T, H, hd) "
                         f"shape, got {[tuple(x.shape) for x in (r, k, v, logw)]}")
    if tuple(u.shape) != shape[2:]:
        raise ValueError(f"rwkv6_wkv takes u of shape {shape[2:]}, got "
                         f"{tuple(u.shape)}")
    if r.dtype not in (torch.bfloat16, torch.float32) or any(
            x.dtype != r.dtype for x in (k, v)):
        raise ValueError(f"rwkv6_wkv takes r, k, v of one type, bf16 or "
                         f"float32, not {[x.dtype for x in (r, k, v)]}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"rwkv6_wkv takes logw and u in float32, not "
                         f"{logw.dtype} and {u.dtype}")
    if any(x.device != r.device for x in (k, v, logw, u)):
        raise ValueError("rwkv6_wkv's tensors lie on different devices")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_wkv runs on cuda or cpu, not {r.device}")
    return r.device.type == "cuda"


def _kernel_takes(tensors) -> None:
    """Raise on what the kernel does not take: a gradient, a stride, a head
    size other than 16 or 64, a start off 16 bytes."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise ValueError("rwkv6_wkv's kernel has no backward: no gradient is "
                         "taken through RWKV6's recurrence on the card")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rwkv6_wkv's kernel needs contiguous tensors")
    if tensors[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv's kernel takes head sizes {HEAD_DIMS}, "
                         f"not {tensors[0].shape[-1]}")
    if any(x.data_ptr() % 16 for x in tensors[:4]):
        raise ValueError("rwkv6_wkv's kernel needs r, k, v and logw aligned "
                         "to 16 bytes (its tiles arrive by TMA)")


def _launch(r, k, v, logw, u, y, state) -> bool:
    """One launch on the current stream; False where there is no work."""
    b, t, h, hd = r.shape
    if r.numel() == 0:
        return False
    lib, fn = _launcher()
    with torch.cuda.device(r.device):
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), y.data_ptr(), state.data_ptr(), b, t, h, hd,
                  int(r.dtype == torch.bfloat16),
                  torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_wkv")
    return True


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if not _check(r, k, v, logw, u):
        return wkv_ref(r, k, v, logw, u)
    _kernel_takes((r, k, v, logw, u))
    b, t, h, hd = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state = (torch.empty if t else torch.zeros)(
        b, h, hd, hd, dtype=torch.float32, device=r.device)
    if _launch(r, k, v, logw, u, y, state):
        rwkv6_wkv.launches += 1
    return y, state


rwkv6_wkv.launches = 0
