"""Mixture-of-Experts FFN: a top-k router and capacity-based GShard dispatch.

Port of :mod:`repro.models.moe`, with the reference's routing exactly:

  * the router's logits in float32 (``tokens.float() @ router``; the router
    is a float32 parameter in a bf16 model), softmax, top-k, and with
    ``renorm_gates`` the gates divided by ``max(sum, 1e-9)``;
  * expert capacity ``max(int(cf·T·k/E), 1)``, rounded up to a multiple of
    8 from 8 on; ``capacity_factor=None`` is lossless (capacity T);
  * a (token, slot)'s position in its expert's buffer is the count of
    earlier (token, slot) pairs routed to that expert, token-major and
    slot-minor (the exclusive cumsum over the flat one-hot); a pair is kept
    where its position is under the capacity, and dropped otherwise;
  * shared experts added to the routed output; the GShard aux loss
    ``E·Σ f·p`` with ``f`` from each token's top-1 expert;
  * with ``moe_dispatch_chunk`` (and a capacity), the tokens dispatched a
    chunk at a time, aux the mean over the chunks.

The reference writes dispatch and combine as dense one-hot einsums over
(T, E, C). The port indexes instead: each kept (token, slot) is copied into
an (E, C, d) buffer at (expert, position), the three expert products run
batched over the experts (``layers.mlp_apply`` on 3-D weights), and each
slot's row is gathered back and the token's slots summed, weighted by their
gates in x's dtype, in one batched product. C is the fullest expert's kept
count (at most the capacity): the slots past it are empty and add exactly
0 in the reference, so a lossless call does not compute T·E rows. No
kernel of the port is involved: the reference runs these einsums outside
any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (dense_init, expert_init, is_gated,
                                       mlp_apply, mlp_init)


def moe_init(cfg, dtype, device) -> nn.ParameterDict:
    """``router`` (d, E) in float32, the experts' ``w_in``/``w_gate``
    (E, d, d_ff) and ``w_out`` (E, d_ff, d) in ``dtype``, and
    ``shared_{i}`` dense MLPs."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    gated = is_gated(cfg.activation)
    p = {"router": dense_init(d, e, torch.float32, device),
         "w_in": expert_init(e, d, dff, dtype, device),
         "w_out": expert_init(e, dff, d, dtype, device)}
    if gated:
        p["w_gate"] = expert_init(e, d, dff, dtype, device)
    for i in range(cfg.n_shared_experts):
        p[f"shared_{i}"] = mlp_init(d, dff, dtype, device, gated)
    return nn.ParameterDict(p)


def capacity(cfg, n_tok: int, capacity_factor: float | None) -> int:
    """Slots per expert for ``n_tok`` tokens (the reference's rule)."""
    if capacity_factor is None:
        return n_tok
    c = max(int(capacity_factor * n_tok * cfg.top_k / cfg.n_experts), 1)
    return -(-c // 8) * 8 if c >= 8 else c


def route(params, cfg, tokens):
    """(T, d) tokens -> (probs (T, E) float32, gates (T, k) float32,
    expert index (T, k)), the slots in descending probability."""
    probs = torch.softmax(tokens.float() @ params["router"], dim=-1)
    gates, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.renorm_gates:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, expert_idx


def positions(expert_idx, n_experts: int):
    """Each (token, slot)'s position in its expert's buffer, (T, k), and the
    pairs routed to each expert, (E,). The one-hot is laid out (E, T·k), so
    that the cumsum runs along contiguous rows (a scan down the T·k rows of
    a (T·k, E) one-hot took ~3 ms a dispatch on the card)."""
    flat = expert_idx.reshape(-1)
    experts = torch.arange(n_experts, device=flat.device)
    onehot = (flat[None, :] == experts[:, None]).to(torch.int32)  # (E, T·k)
    before = onehot.cumsum(1, dtype=torch.int32) - onehot
    pos = before.gather(0, flat[None, :]).view_as(expert_idx)
    return pos.long(), onehot.sum(1)


def moe_apply(params, cfg, x, *, capacity_factor: float | None | str = "cfg"):
    """x: (b, t, d) -> (out, aux loss). ``capacity_factor`` None is lossless
    (decode, prefill); "cfg" takes ``cfg.moe_capacity_factor``."""
    b, t, d = x.shape
    n_tok = b * t
    chunk = cfg.moe_dispatch_chunk
    if capacity_factor == "cfg":
        capacity_factor = cfg.moe_capacity_factor
    if (chunk and n_tok > chunk and n_tok % chunk == 0
            and capacity_factor is not None):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for tokens in x.reshape(n_tok // chunk, chunk, d):
            out, a = _moe_tokens(params, cfg, tokens, capacity_factor)
            outs.append(out)
            aux = aux + a
        return torch.cat(outs).reshape(b, t, d), aux / (n_tok // chunk)
    out, aux = _moe_tokens(params, cfg, x.reshape(n_tok, d), capacity_factor)
    return out.reshape(b, t, d), aux


def _moe_tokens(params, cfg, tokens, capacity_factor):
    """Dispatch one flat (T, d) token block through the experts."""
    n_tok, d = tokens.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gates, expert_idx = route(params, cfg, tokens)
    pos, counts = positions(expert_idx, e)
    cap = capacity(cfg, n_tok, capacity_factor)
    keep = pos < cap
    c = min(cap, int(counts.max()))            # the fullest expert's kept
    # row of each (token, slot) in the flat (E·C) buffer; a dropped pair
    # goes to one spare row past it, which is never read back
    row = torch.where(keep, expert_idx * c + pos, e * c).view(-1)
    buf = tokens.new_zeros(e * c + 1, d).index_copy(
        0, row, tokens.repeat_interleave(k, dim=0))
    ys = mlp_apply(params, buf[:e * c].view(e, c, d), cfg.activation)
    ys = torch.cat([ys.reshape(e * c, d), ys.new_zeros(1, d)])
    # combine: each token's slots weighted by their gates in x's dtype (0
    # where dropped) and summed in one product, as the reference's einsum
    weight = (gates * keep).to(tokens.dtype)
    out = torch.bmm(weight[:, None, :],
                    ys.index_select(0, row).view(n_tok, k, d))[:, 0]

    # GShard aux loss: E · Σ_e f_e · p_e
    frac_tokens = F.one_hot(expert_idx[:, 0], e).float().mean(0)
    aux = e * (frac_tokens * probs.mean(0)).sum()

    for i in range(cfg.n_shared_experts):
        out = out + mlp_apply(params[f"shared_{i}"], tokens, cfg.activation)
    return out, aux
