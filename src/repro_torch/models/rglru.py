"""Griffin recurrent block (RG-LRU + short conv): RecurrentGemma's mixer.

Port of :mod:`repro.models.rglru`, with the reference's names, so that
``models.params`` carries its weights across with no special case. The
full-sequence forms (``rglru_apply``, ``rglru_prefill``) run the gates'
elementwise part and the recurrence ``h_t = a_t · h_{t-1} + b_t`` through
S (``kernels.rglru_scan.ops.rglru_lru``: one CUDA kernel on the card, its
plain version on the CPU) where the reference runs ``_gates`` and
``jax.lax.associative_scan``; S writes h in the model's type, and its
gradient is S-bwd (``rglru_lru_bwd``). Decode is the
one-step update in plain torch, through the same gate function
(``ref.rglru_gates_ref``) as S's plain version. The gates, ``a``, the
gated input and the decode state ``h`` are float32; the state a decode
step needs is ``h`` (b, lru_width) and the last ``CONV_WIDTH - 1`` conv
*inputs* (b, 3, lru_width).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru_scan.ops import rglru_lru
from repro_torch.kernels.rglru_scan.ref import (C, decay_rate,
                                                rglru_gates_ref)
from repro_torch.models.layers import dense_init, param

CONV_WIDTH = 4


def rglru_init(cfg, dtype, device) -> nn.ParameterDict:
    """The mixer's parameters, uninitialised (``models.layers.draw_`` fills
    them with the reference's rules, ``log_lambda_init`` for Λ)."""
    d, dl = cfg.d_model, cfg.lru_width
    return nn.ParameterDict({
        "w_x": dense_init(d, dl, dtype, device),
        "w_y": dense_init(d, dl, dtype, device),
        "conv_w": param((CONV_WIDTH, dl), dtype, device),
        "conv_b": param((dl,), dtype, device),
        "w_input_gate": dense_init(dl, dl, dtype, device),
        "w_rec_gate": dense_init(dl, dl, dtype, device),
        "log_lambda": param((dl,), dtype, device),
        "w_out": dense_init(dl, d, dtype, device),
    })


def log_lambda_init(dl: int, device=None) -> torch.Tensor:
    """Λ in float32, so that a = exp(-C·softplus(Λ)) is spread over (0.9,
    0.999); the caller casts it to the parameter dtype, as the reference
    does."""
    a = torch.linspace(0.9, 0.999, dl, dtype=torch.float32, device=device)
    return torch.log(torch.expm1(-torch.log(a) / C))


def _gates(params, u):
    """a (the decay) and the gated input of the LRU, float32."""
    return rglru_gates_ref(u @ params["w_input_gate"],
                           u @ params["w_rec_gate"], u,
                           decay_rate(params["log_lambda"]))


def _lru(params, u):
    """S on the conv output: (h in u's type, the last h in float32)."""
    return rglru_lru(u, u @ params["w_input_gate"], u @ params["w_rec_gate"],
                     params["log_lambda"])


def _causal_conv(params, u, conv_state=None):
    """Depthwise causal conv, width 4. u: (b, t, dl). Returns the conv
    output and the state (the last width - 1 INPUTS) a decode step needs."""
    if conv_state is not None:
        u_hist = torch.cat([conv_state, u], dim=1)        # (b, w-1+t, dl)
    else:
        u_hist = F.pad(u, (0, 0, CONV_WIDTH - 1, 0))
    t = u.shape[1]
    w = params["conv_w"]
    out = u_hist[:, 0:t] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + u_hist[:, i:i + t] * w[i]
    out = out + params["conv_b"]
    return out, u_hist[:, -(CONV_WIDTH - 1):]


def _mix(params, x, h):
    # S's h is already x's type (no copy); the decode step's is float32
    y = h.to(x.dtype) * F.gelu(x @ params["w_y"], approximate="tanh")
    return y @ params["w_out"]


def rglru_apply(params, cfg, x):
    """Full-sequence mixer. x: (b, t, d) -> (b, t, d)."""
    u, _ = _causal_conv(params, x @ params["w_x"])
    return _mix(params, x, _lru(params, u)[0])


def rglru_prefill(params, cfg, x):
    """Full-sequence mixer returning (y, the decode state after the
    sequence): ``{"h": the last step's h (float32), "conv": the last 3
    conv inputs}``."""
    u_conv, conv_state = _causal_conv(params, x @ params["w_x"])
    h, h_last = _lru(params, u_conv)
    # a copy, so that the cache does not hold the whole sequence's input
    return _mix(params, x, h), {"h": h_last, "conv": conv_state.clone()}


def rglru_state_init(batch, cfg, dtype, device=None):
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.lru_width),
                                dtype=dtype, device=device)}


def rglru_decode_step(params, cfg, x, state):
    """x: (b, 1, d) -> (y, state)."""
    u, conv_state = _causal_conv(params, x @ params["w_x"], state["conv"])
    a, b_in = _gates(params, u)
    h = a[:, 0] * state["h"] + b_in[:, 0]                      # (b, dl)
    return _mix(params, x, h[:, None, :]), {"h": h, "conv": conv_state}
