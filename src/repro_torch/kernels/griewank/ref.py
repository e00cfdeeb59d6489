"""Plain PyTorch version of the Griewank aggregates kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.coord_sweep.ref import AGG_LANES
from repro_torch.objectives.griewank import GRIEWANK


def griewank_aggregates_ref(x2d: torch.Tensor, *, n_valid: int) -> torch.Tensor:
    """Same contract as the kernel: (1, AGG_LANES) float32 with [S, L, K] in
    lanes 0..2, the masked (index < n_valid) sums over the flattened x2d."""
    flat = x2d.reshape(-1)
    aggs = GRIEWANK.aggregates(flat, n_valid, agg_dtype=torch.float32)
    out = torch.zeros((1, AGG_LANES), dtype=torch.float32, device=flat.device)
    out[0, :3] = aggs
    return out
