"""The plain version of S, the RG-LRU's linear recurrence.

``rglru_scan_ref(a, b)`` is ``h_t = a_t · h_{t-1} + b_t`` from ``h_{-1} =
0`` over the time axis of (batch, T, channels) float32 tensors, in a fixed
order of arithmetic that ``csrc/rglru_scan.cu`` repeats bit for bit: chunks
of ``CHUNK`` steps along T (the last one padded with a = 1, b = 0, which
moves no bit of the output); per chunk its local state from 0 and the
product of its a; the state entering each chunk, carried across the chunks
in order; then each chunk's steps again from its entering state. Each step
is a multiply, then an add, each rounded (no FMA). The loops over a chunk's
steps are vectorised over the chunks, the carry over batch and channels.

It stands for ``jax.lax.associative_scan(compose, (a, b), axis=1)`` in
``src/repro/models/rglru.py``, whose tree order differs in the last bits.
"""
from __future__ import annotations

import torch

CHUNK = 64


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bsz, t, d = a.shape
    chunks = -(-t // CHUNK)
    pad = chunks * CHUNK - t
    if pad:
        a = torch.cat([a, a.new_ones(bsz, pad, d)], 1)
        b = torch.cat([b, b.new_zeros(bsz, pad, d)], 1)
    a = a.reshape(bsz, chunks, CHUNK, d)
    b = b.reshape(bsz, chunks, CHUNK, d)
    h = a.new_zeros(bsz, chunks, d)
    p = a.new_ones(bsz, chunks, d)
    for i in range(CHUNK):
        h = a[:, :, i] * h + b[:, :, i]
        p = p * a[:, :, i]
    carry = []
    c_in = a.new_zeros(bsz, d)
    for c in range(chunks):
        carry.append(c_in)
        c_in = p[:, c] * c_in + h[:, c]
    h = torch.stack(carry, 1) if carry else a.new_zeros(bsz, 0, d)
    out = []
    for i in range(CHUNK):
        h = a[:, :, i] * h + b[:, :, i]
        out.append(h)
    return torch.stack(out, 2).reshape(bsz, chunks * CHUNK, d)[:, :t]
