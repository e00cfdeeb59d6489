"""Wrapper of the Griewank aggregates kernel (``csrc/griewank_aggregates.cu``).

On a CUDA tensor the wrapper launches the CUDA kernel; on a CPU tensor it
runs the plain version of :mod:`.ref`. There is no fallback between the two.
``griewank_aggregates.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coord_sweep.ref import AGG_LANES
from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
from repro_torch.objectives.base import REDUCE_TILE
from repro_torch.objectives.griewank import GRIEWANK


@functools.cache
def _launcher():
    lib = _build.load("griewank_aggregates")
    fn = lib.griewank_aggregates_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def griewank_aggregates(x: torch.Tensor,
                        n_valid: int | None = None) -> torch.Tensor:
    """Masked [S, L, K] of Griewank over a flat float32 vector.

    Returns (1, AGG_LANES) float32 with the sums in lanes 0..2: coordinates
    at index >= ``n_valid`` (default: all of x) are masked out. The kernel
    reduces fixed-origin tiles of REDUCE_TILE coordinates and folds them in
    index order, as ``GRIEWANK.aggregates`` does; it reads x where it lies,
    with no padded copy.
    """
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("griewank_aggregates takes a contiguous 1-D float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.numel() == 0:
        raise ValueError("griewank_aggregates takes a non-empty tensor")
    n = x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if x.device.type == "cpu":
        return griewank_aggregates_ref(x, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"griewank_aggregates runs on cuda or cpu, not "
                         f"{x.device}")
    lib, fn = _launcher()
    n_tiles = -(-n // REDUCE_TILE)
    partials = torch.empty((n_tiles, 3), dtype=torch.float32, device=x.device)
    out = torch.empty((1, AGG_LANES), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), n, n_valid, REDUCE_TILE, partials.data_ptr(),
                  out.data_ptr(), stream)
    _build.check(lib, code, "griewank_aggregates")
    griewank_aggregates.launches += 1
    return out


griewank_aggregates.launches = 0


def griewank_eval(x: torch.Tensor) -> torch.Tensor:
    """Scalar Griewank value of a flat vector via the aggregates kernel.

    The JAX package's ``chunk`` argument has no counterpart: the kernel's
    tiles are always the fixed-origin REDUCE_TILE tiles of the aggregates.
    """
    aggs = griewank_aggregates(x)
    return GRIEWANK.combine(aggs[0, :3])
