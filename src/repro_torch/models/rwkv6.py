"""RWKV6 "Finch": attention-free time mix with data-dependent decay, and
the squared-ReLU channel mix.

Port of :mod:`repro.models.rwkv6`, with the reference's names, so that
``models.params`` carries its weights across with no special case: ddlerp
token shift (a low-rank, data-dependent interpolation with the previous
token) for five streams, a per-channel log-decay from a LoRA head, the
bonus u for the current token, a float32 (dk x dv) WKV state a head, group
norm and a SiLU output gate. The full-sequence forms (``rwkv6_apply``,
``rwkv6_prefill``) run the WKV recurrence through W
(``kernels.rwkv6_wkv.ops.rwkv6_wkv``: one CUDA kernel on the card, its plain
version on the CPU), which returns the last state too and whose gradient
is W-bwd (``rwkv6_wkv_bwd``), where the reference runs a ``jax.lax.scan``
over T; decode is one eager step, through the same
step function as W's plain version (``ref.wkv_decode``). The decode state is
S (b, H, hd, hd) float32 and the last normed input of the mixer (``shift``)
and of the channel mix (the layer's ``cmix_shift``): O(1) in sequence
length.
"""
# repro: hot-path — RWKV6's prefill and forward; no host sync by construction
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import wkv_decode
from repro_torch.models.layers import dense_init, param

LORA_SHIFT = 32      # ddlerp low-rank dim
LORA_DECAY = 64      # decay LoRA dim
_STREAMS = ("w", "k", "v", "r", "g")


def rwkv6_init(cfg, dtype, device) -> nn.ParameterDict:
    """The time mix's parameters, uninitialised (``models.layers.draw_``
    fills them with the reference's rules)."""
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    n = len(_STREAMS)
    return nn.ParameterDict({
        "mu_x": param((d,), dtype, device),
        "shift_w1": dense_init(d, LORA_SHIFT * n, dtype, device),
        "shift_w2": param((n, LORA_SHIFT, d), dtype, device),
        "mu": param((n, d), dtype, device),
        "w_r": dense_init(d, d, dtype, device),
        "w_k": dense_init(d, d, dtype, device),
        "w_v": dense_init(d, d, dtype, device),
        "w_g": dense_init(d, d, dtype, device),
        "w_o": dense_init(d, d, dtype, device),
        "decay_w1": dense_init(d, LORA_DECAY, dtype, device),
        "decay_w2": dense_init(LORA_DECAY, d, dtype, device),
        "decay_base": param((d,), dtype, device),
        "bonus_u": param((h, hd), dtype, device),
        "gn_scale": param((d,), dtype, device),
        "gn_bias": param((d,), dtype, device),
    })


def decay_base_init(d: int, dtype, device=None) -> torch.Tensor:
    """``linspace(-6, -0.5, d)`` in float32, cast to the parameter type."""
    return torch.linspace(-6.0, -0.5, d, dtype=torch.float32,
                          device=device).to(dtype)


def _shifted(x):
    """The previous token's x, zero before the first: pad(x)[:, :-1]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(params, x, x_prev):
    """Data-dependent token shift for the five streams. x: (b, t, d)."""
    xx = x_prev - x
    xxx = x + xx * params["mu_x"]
    lora = torch.tanh(xxx @ params["shift_w1"])                 # (b,t,5*32)
    b, t, _ = x.shape
    lora = lora.reshape(b, t, len(_STREAMS), LORA_SHIFT)
    adj = torch.einsum("btsl,sld->btsd", lora, params["shift_w2"])
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (params["mu"] + adj)
    return tuple(mixed[:, :, i] for i in range(len(_STREAMS)))  # 5 x (b,t,d)


def _decay(params, xw):
    """Per-channel log-decay (negative, float32): the LoRA product in the
    model's type, then cast. w = exp(logw)."""
    lw = params["decay_base"].float() + (
        torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]).float()
    return -torch.exp(lw)


def _group_norm(params, y, n_heads, eps=1e-5):
    """Per-head normalisation in float32 with the population variance
    (``jnp.var``), then the scale and bias."""
    b, t, d = y.shape
    yf = y.float().reshape(b, t, n_heads, d // n_heads)
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(b, t, d)
    return yn * params["gn_scale"].float() + params["gn_bias"].float()


def _project(params, cfg, x, x_prev):
    """r, k, v (b, t, H, hd) in x's type, the gate g (b, t, d) and logw
    (b, t, H, hd) float32; each contiguous."""
    xw, xk, xv, xr, xg = _ddlerp(params, x, x_prev)
    b, t, _ = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r = (xr @ params["w_r"]).reshape(b, t, h, hd)
    k = (xk @ params["w_k"]).reshape(b, t, h, hd)
    v = (xv @ params["w_v"]).reshape(b, t, h, hd)
    g = F.silu(xg @ params["w_g"])
    logw = _decay(params, xw).reshape(b, t, h, hd)
    return r, k, v, g, logw


def _out(params, cfg, x, y, g):
    """Group norm of the WKV output y (float32, x's shape), gated, then
    the output projection."""
    y = _group_norm(params, y, cfg.rwkv_heads).to(x.dtype) * g
    return y @ params["w_o"]


def _time_mix(params, cfg, x):
    """The full-sequence time mix through W: (output, the last S)."""
    r, k, v, g, logw = _project(params, cfg, x, _shifted(x))
    y, S = rwkv6_wkv(r, k, v, logw, params["bonus_u"].float())
    return _out(params, cfg, x, y.reshape(x.shape), g), S


def rwkv6_apply(params, cfg, x):
    """Full-sequence time mix. x: (b, t, d) -> (b, t, d)."""
    return _time_mix(params, cfg, x)[0]


def rwkv6_prefill(params, cfg, x):
    """Full-sequence time mix returning (y, the decode state after the
    sequence): ``{"S": the last S (float32), "shift": the last x}``."""
    out, S = _time_mix(params, cfg, x)
    # a copy, so that the cache does not hold the whole sequence's input
    return out, {"S": S, "shift": x[:, -1].clone()}


def rwkv6_state_init(batch, cfg, dtype, device=None):
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {"S": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device)}


def rwkv6_decode_step(params, cfg, x, state):
    """x: (b, 1, d) -> (y, state)."""
    r, k, v, g, logw = _project(params, cfg, x, state["shift"][:, None, :])
    y, S = wkv_decode(state["S"], r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                      params["bonus_u"])
    return (_out(params, cfg, x, y.reshape(x.shape[0], 1, -1), g),
            {"S": S, "shift": x[:, 0]})


# ---------------------------------------------------------------------------
# channel mix (RWKV's FFN)
# ---------------------------------------------------------------------------
def channel_mix_init(cfg, dtype, device) -> nn.ParameterDict:
    d, dff = cfg.d_model, cfg.d_ff
    return nn.ParameterDict({
        "mu_k": param((d,), dtype, device),
        "mu_r": param((d,), dtype, device),
        "w_k": dense_init(d, dff, dtype, device),
        "w_v": dense_init(dff, d, dtype, device),
        "w_r": dense_init(d, d, dtype, device),
    })


def channel_mix_apply(params, x, x_prev):
    xk = x + (x_prev - x) * params["mu_k"]
    xr = x + (x_prev - x) * params["mu_r"]
    k = torch.square(F.relu(xk @ params["w_k"]))
    return torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])


def channel_mix_full(params, x):
    return channel_mix_apply(params, x, _shifted(x))


def channel_mix_decode(params, x, shift_state):
    """x: (b, 1, d); shift_state: (b, d)."""
    out = channel_mix_apply(params, x, shift_state[:, None, :])
    return out, x[:, 0]
