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
version. No fallback. Its tiles arrive by TMA, so r, k, v and logw must
start on 16 bytes.

The gradient. Where grad mode is on and an input requires grad, the op is
a ``torch.autograd.Function`` that saves r, k, v, logw and u. Its backward
is W-bwd (``rwkv6_wkv_bwd``): on a CUDA tensor the port-only kernel of
``csrc/rwkv6_wkv_bwd.cu`` (counted in ``rwkv6_wkv_bwd.launches``), on a
CPU tensor its plain version ``ref.wkv_bwd_ref``: dr, dk and dv in the
input's type, dlogw float32 and du float32 (H, hd), summed over the batch
and T in a fixed order.
"""
# repro: hot-path — RWKV6's prefill and forward; no host sync by construction
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref, wkv_ref

HEAD_DIMS = (16, 64)


@functools.cache
def _launcher():
    lib = _build.load("rwkv6_wkv")
    fn = lib.rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _launcher_bwd():
    lib = _build.load("rwkv6_wkv_bwd")
    fn = lib.rwkv6_wkv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


BWD_CHUNK = 16      # W-bwd's steps a chunk: one checkpoint of S a chunk


def bwd_scratch_bytes(b: int, t: int, h: int, hd: int) -> int:
    """The scratch W-bwd's wrapper allocates a call: the float32 state each
    chunk starts from, (b, H, ceil(T / 16), hd, hd), and du's (b, H, hd)
    sums over T before the batch's."""
    return 4 * b * h * hd * (-(-t // BWD_CHUNK) * hd + 1)


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
    """Raise on what the kernel does not take: a stride, a head size other
    than 16 or 64, a start off 16 bytes."""
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


def _forward(r, k, v, logw, u):
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


class _WKV(torch.autograd.Function):
    """W with W-bwd as its gradient; saves the inputs, not the states."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        return _forward(r, k, v, logw, u)

    @staticmethod
    def backward(ctx, dy, dS):        # autograd materializes unused grads
        return rwkv6_wkv_bwd(*ctx.saved_tensors, dy, dS)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, logw, u)):
        return _WKV.apply(r, k, v, logw, u)
    return _forward(r, k, v, logw, u)


def rwkv6_wkv_bwd(r, k, v, logw, u, dy, dS=None):
    """W-bwd: the gradient of ``rwkv6_wkv`` at (dy, dS), as
    ``ref.wkv_bwd_ref`` returns it: (dr, dk, dv) in r's type, dlogw float32
    (b, T, H, hd) and du float32 (H, hd). dy is float32 of r's shape, dS
    float32 (b, H, hd, hd) or None (zero). On CUDA tensors the kernel of
    ``csrc/rwkv6_wkv_bwd.cu`` (what W takes); on CPU tensors the plain
    version. No fallback.

    The kernel is a chunked backward (``ref.wkv_bwd_chunked`` is its
    arithmetic): chunks of ``BWD_CHUNK`` steps, the chunk's products on the
    tensor cores in split TF32 (dv's in plain TF32 where dv is bf16), a
    cluster of hd / 16 CTAs a head; two CUDA kernels, the sweeps over T and
    then du's fixed-order sum over the batch, counted as one launch. Its
    tiles arrive by TMA, so dy is made contiguous and 16-byte aligned here;
    its scratch is ``bwd_scratch_bytes``."""
    on_card = _check(r, k, v, logw, u)
    b, t, h, hd = r.shape
    if (tuple(dy.shape) != tuple(r.shape) or dy.dtype != torch.float32
            or dy.device != r.device):
        raise ValueError(f"rwkv6_wkv_bwd takes dy float32 of shape "
                         f"{tuple(r.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dS is not None and (tuple(dS.shape) != (b, h, hd, hd)
                           or dS.device != r.device):
        raise ValueError(f"rwkv6_wkv_bwd takes dS of shape {(b, h, hd, hd)}"
                         f", got {tuple(dS.shape)}")
    if not on_card:
        return wkv_bwd_ref(r, k, v, logw, u, dy, dS)
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    u = u.contiguous()
    _kernel_takes((r, k, v, logw, u))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((h, hd), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        du.zero_()
        return dr, dk, dv, dlogw, du
    chunks = -(-t // BWD_CHUNK)
    ckpt = torch.empty((b, h, chunks, hd, hd), dtype=torch.float32,
                       device=r.device)
    du_part = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    ds = None if dS is None else dS.float().contiguous()
    lib, fn = _launcher_bwd()
    with torch.cuda.device(r.device):
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), dy.data_ptr(),
                  None if ds is None else ds.data_ptr(), ckpt.data_ptr(),
                  dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  dlogw.data_ptr(), du_part.data_ptr(),
                  du.data_ptr(), b, t, h, hd, int(r.dtype == torch.bfloat16),
                  torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_wkv_bwd")
    rwkv6_wkv_bwd.launches += 1
    return dr, dk, dv, dlogw, du


rwkv6_wkv.launches = 0
rwkv6_wkv_bwd.launches = 0
