"""Train and serve step factories, single device.

Port of :mod:`repro.train.steps` without the mesh and sharding arguments
(ZeRO-1, the sharding helpers and the multi-device path are ROADMAP queue
1, item 10). PyTorch runs eagerly, so a step is a plain function over the
model, which holds its parameters and is updated in place.

  * ``make_train_step(model, optimizer="adamw")`` -> ``step(opt_state,
    batch) -> (opt_state, metrics)``: bf16 params, float32 gradient
    accumulation over microbatches (in index order), gradients cast to bf16
    (``grad_compression``), AdamW with a float32 master and moments;
    ``remat`` recomputes each layer group's unit in the backward pass.
  * ``make_train_step(model, optimizer="abo_zo")`` -> ``step(opt_state,
    batch, key)``: forward passes only, no optimizer state beyond the step
    and the window (``train.abo_zo``).
  * ``make_prefill_step`` / ``make_decode_step``: the serving steps.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import reference_leaves
from repro_torch.optim import adamw as adamw_mod
from repro_torch.train import abo_zo as abo_zo_mod


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def make_train_step(model, *, optimizer: str = "adamw", remat=True,
                    grad_compression: str | None = "bf16",
                    microbatches: int = 1,
                    adamw_cfg: adamw_mod.AdamWConfig | None = None,
                    abo_cfg: abo_zo_mod.ABOZOConfig | None = None):
    """adamw:  ``step(opt_state, batch) -> (opt_state, metrics)``
    abo_zo: ``step(opt_state, batch, key) -> (opt_state, metrics)``

    ``batch`` is ``{"tokens": (b, t + 1)}`` on the model's device; the
    model's parameters are updated in place. metrics: ``loss`` (0-d
    tensor), and for AdamW ``ce``, ``aux`` and ``gnorm``."""
    if optimizer not in ("adamw", "abo_zo"):
        raise ValueError(f"optimizer must be 'adamw' or 'abo_zo', not "
                         f"{optimizer!r}")
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"grad_compression must be None or 'bf16', not "
                         f"{grad_compression!r}")

    def loss_fn(batch):
        return model.loss(batch, remat=remat)[0]

    if optimizer == "abo_zo":
        model.requires_grad_(False)
        return abo_zo_mod.make_step(model, loss_fn,
                                    abo_cfg or abo_zo_mod.ABOZOConfig())

    acfg = adamw_cfg or adamw_mod.AdamWConfig()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    groups = reference_leaves(model.cfg)

    def grads_of(batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(opt_state, batch):
        if microbatches > 1:
            tokens = batch["tokens"]
            per = tokens.shape[0] // microbatches
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
            for i in range(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss, _, grads = grads_of(mb)
                for n, g in grads.items():
                    acc[n].add_(g.float())
                del grads
                loss_sum = loss_sum + loss
            grads = {n: a.div_(microbatches) for n, a in acc.items()}
            loss = loss_sum / microbatches
            metrics = {"ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        else:
            loss, metrics, grads = grads_of(batch)
        if grad_compression == "bf16":
            grads = {n: g.to(torch.bfloat16) for n, g in grads.items()}
        _, opt_state, gnorm = adamw_mod.apply_update(
            params, grads, opt_state, acfg, leaf_groups=groups)
        return opt_state, {**metrics, "loss": loss, "gnorm": gnorm}

    return step


def init_opt_state(model, optimizer: str = "adamw",
                   abo_cfg: abo_zo_mod.ABOZOConfig | None = None):
    """The optimizer's initial state: AdamW's float32 master and moments on
    the model's device, or ABO-ZO's step and window."""
    if optimizer == "abo_zo":
        return abo_zo_mod.init_state(abo_cfg or abo_zo_mod.ABOZOConfig())
    return adamw_mod.init_state(dict(model.named_parameters()))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_prefill_step(model):
    """``step(batch) -> logits[:, -1]`` of a full-sequence forward.

    Only the last position goes through the LM head: the same numbers as
    the reference's ``logits[:, -1]`` without the (T, vocab) logits.
    """
    @torch.no_grad()
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
        slots = max((lc["kv"]["k"].shape[2] for lc in cache if "kv" in lc),
                    default=0)
        if slots > max_len:
            raise ValueError(f"cache of {slots} slots exceeds max_len "
                             f"{max_len}")
        return model.decode_step(tokens, cache, pos)
    return decode
