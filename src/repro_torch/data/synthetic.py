"""Deterministic, resumable synthetic LM data pipeline.

A copy of :mod:`repro.data.synthetic` (numpy, bit for bit), with
``torch_batch`` in place of ``jax_batch``. Batch ``i`` is a pure function
of (seed, i), so resume after preemption restores only the integer cursor
from the train checkpoint. Tokens follow a fixed random bigram chain, so
the loss has real structure to learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # plausible next-tokens per token


class BigramStream:
    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        # each token has `branching` allowed successors — learnable structure
        self.next_tokens = rng.randint(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching)
        ).astype(np.int32)

    def batch(self, cursor: int) -> np.ndarray:
        """(global_batch, seq_len + 1) tokens for step ``cursor``."""
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + cursor) % (2**31 - 1))
        b, t = cfg.global_batch, cfg.seq_len + 1
        toks = np.empty((b, t), np.int32)
        toks[:, 0] = rng.randint(0, cfg.vocab_size, size=b)
        choices = rng.randint(0, cfg.branching, size=(b, t - 1))
        for j in range(1, t):
            toks[:, j] = self.next_tokens[toks[:, j - 1], choices[:, j - 1]]
        return toks

    def torch_batch(self, cursor: int, device) -> torch.Tensor:
        """``batch(cursor)`` as an int64 tensor on ``device``."""
        return torch.from_numpy(self.batch(cursor).astype(np.int64)).to(device)
