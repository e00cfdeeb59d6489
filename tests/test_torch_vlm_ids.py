"""The stubbed vision front end's M-RoPE ids, shared by the qwen2-vl-7b
tests (tests/test_torch_qwen2_vl.py and tests/test_torch_models.py against
the JAX package on the CPU, tests/test_torch_gpu.py on the card against the
CPU), and a check of their layout. Imports numpy only, so the card's tests
can use it where JAX is absent."""
from __future__ import annotations

import numpy as np


def image_ids(b: int, t: int, at: int, grid: int) -> np.ndarray:
    """(b, 3, t) int64 ids: a grid x grid image from ``at`` with ids (at,
    at + row, at + col), text ids (i, i, i) elsewhere."""
    pos = np.broadcast_to(np.arange(t, dtype=np.int64), (b, 3, t)).copy()
    patch = np.arange(grid * grid)
    span = slice(at, at + grid * grid)
    pos[:, 0, span] = at
    pos[:, 1, span] = at + patch // grid
    pos[:, 2, span] = at + patch % grid
    return pos


def test_image_ids_layout():
    """Text positions carry (i, i, i); the image's patches carry (at, at +
    row, at + col) in row-major order; every position is covered once."""
    pos = image_ids(2, 30, 5, 3)
    assert pos.shape == (2, 3, 30) and pos.dtype == np.int64
    text = np.r_[0:5, 14:30]
    assert (pos[:, :, text] == text).all()
    for p in range(9):
        assert pos[:, :, 5 + p].tolist() == [[5, 5 + p // 3, 5 + p % 3]] * 2
