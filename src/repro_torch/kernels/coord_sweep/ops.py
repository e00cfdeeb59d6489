"""Wrapper of the coord_sweep kernel (``csrc/sweep_pass.cu``) and the whole
ABO solve on top of it.

``abo_minimize_kernel`` is the kernel-path counterpart of
:func:`repro_torch.core.abo.abo_minimize` for Griewank: one kernel launch
per pass, the initial aggregates and the exact final value from the
Griewank aggregates kernel. Like the JAX package's kernel path it takes
``x0`` but no ``seed``, does no per-pass resync, and reads its history from
the carried float32 aggregates.

On a CUDA tensor ``sweep_pass`` launches the CUDA kernel; on a CPU tensor
it runs the plain version of :mod:`.ref`. There is no fallback between the
two. ``sweep_pass.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.abo import ABOConfig, ABOResult
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.coord_sweep.ref import (AGG_LANES, kernel_route,
                                                 sweep_pass_ref)
from repro_torch.kernels.griewank.ops import griewank_aggregates
from repro_torch.objectives.griewank import GRIEWANK


def pack_aggs(aggs3: torch.Tensor) -> torch.Tensor:
    """(3,) float aggregates -> (1, AGG_LANES) kernel i/o vector."""
    out = torch.zeros((1, AGG_LANES), dtype=torch.float32, device=aggs3.device)
    out[0, :3] = aggs3.to(torch.float32)
    return out


@functools.cache
def _launcher():
    lib = _build.load("sweep_pass")
    fn = lib.sweep_pass_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def sweep_pass(x2d: torch.Tensor, aggs: torch.Tensor, *, m: int, n_valid: int,
               half_width: float, lam: float, is_first: bool):
    """One whole ABO pass of Griewank over ``x2d`` (n_blocks, B) float32.

    ``aggs`` is (1, AGG_LANES) float32 with [S, L, K] in lanes 0..2. Returns
    ``(x2d, aggs_out)``: ``x2d`` is updated IN PLACE and returned (the JAX
    kernel returned a new array), ``aggs_out`` is a new (1, AGG_LANES).
    """
    for name, t in (("x2d", x2d), ("aggs", aggs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"sweep_pass: {name} must be a contiguous 2-D "
                             f"float32 tensor, got {tuple(t.shape)} {t.dtype}")
    if aggs.shape != (1, AGG_LANES) or aggs.device != x2d.device:
        raise ValueError(f"sweep_pass: aggs must be (1, {AGG_LANES}) on "
                         f"{x2d.device}, got {tuple(aggs.shape)} on "
                         f"{aggs.device}")
    if m < 3:
        raise ValueError(f"sweep_pass: m must be >= 3, got {m}")
    lower, upper = GRIEWANK.lower, GRIEWANK.upper
    if x2d.device.type == "cpu":
        return sweep_pass_ref(x2d, aggs, m=m, n_valid=n_valid, lower=lower,
                              upper=upper, half_width=half_width, lam=lam,
                              is_first=is_first)
    if x2d.device.type != "cuda":
        raise ValueError(f"sweep_pass runs on cuda or cpu, not {x2d.device}")
    n_blocks, block = x2d.shape
    def f32(v):   # the float32 rounding the plain version makes
        return float(np.float32(v))

    center0 = f32(0.5 * (lower + upper))
    hw = f32(0.5 * (upper - lower)) if is_first else f32(half_width)
    lib, fn = _launcher()
    out = torch.empty((1, AGG_LANES), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        code = fn(x2d.data_ptr(), n_blocks, block, m, int(n_valid), lower,
                  upper, center0, hw, f32(2.0 / (m - 2)), f32(lam),
                  int(is_first), aggs.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, code, "sweep_pass")
    sweep_pass.launches += 1
    return x2d, out


sweep_pass.launches = 0


def abo_minimize_kernel(n: int, *, config: ABOConfig | None = None, x0=None,
                        dtype=torch.float32, device=None) -> ABOResult:
    """Griewank ABO with the sweep kernel, on ``device`` (the card by
    default; ``"cpu"`` runs the plain versions)."""
    return kernel_route(n, config or ABOConfig(), x0, dtype,
                        resolve_device(device), sweep=sweep_pass,
                        aggregates=griewank_aggregates)
