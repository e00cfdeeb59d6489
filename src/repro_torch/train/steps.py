"""Serving step factories, single device.

Port of the serving half of :mod:`repro.train.steps`: ``make_prefill_step``
and ``make_decode_step`` without the mesh and sharding arguments (the
multi-device path is ROADMAP queue 1, item 10). PyTorch runs eagerly, so a
step is a plain function over the model, which holds its parameters. The
training factories wait for the LM training slice (ROADMAP queue 1, item
11).
"""
from __future__ import annotations


def make_prefill_step(model):
    """``step(batch) -> logits[:, -1]`` of a full-sequence forward.

    Only the last position goes through the LM head: the same numbers as
    the reference's ``logits[:, -1]`` without the (T, vocab) logits.
    """
    def prefill(batch):
        logits, _ = model.forward(batch["tokens"],
                                  positions=batch.get("positions"),
                                  last_only=True)
        return logits[:, -1]
    return prefill


def make_decode_step(model, *, batch: int, max_len: int):
    """``step(tokens, cache, pos) -> (logits, cache)``: one token of each of
    ``batch`` lanes against caches of ``max_len`` slots (the model's
    ``init_cache(batch, max_len)``). The cache is updated in place."""
    def decode(tokens, cache, pos):
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"decode step built for tokens ({batch}, 1), "
                             f"got {tuple(tokens.shape)}")
        if cache[0]["kv"]["k"].shape[2] > max_len:
            raise ValueError(f"cache of {cache[0]['kv']['k'].shape[2]} "
                             f"slots exceeds max_len {max_len}")
        return model.decode_step(tokens, cache, pos)
    return decode
