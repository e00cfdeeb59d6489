"""Shared NN layers: init rules, norms, MLPs, RoPE and M-RoPE.

Port of :mod:`repro.models.layers`. Parameters are ``nn.ParameterDict``s
keyed as the reference's pytrees (``params["w_in"]``), weights ``(d_in,
d_out)`` so ``x @ w`` reads the same. Building a dict allocates its tensors
uninitialised on the device; :func:`draw_` fills one parameter in place
with the reference's init rule (:meth:`repro_torch.models.model.Model.init`
walks them one at a time), so no second copy of a model is ever made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EMBED_NAMES = ("embed", "unembed", "pos_embed", "enc_pos_embed")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, made without a gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(d_in, d_out, dtype, device) -> nn.Parameter:
    """A (d_in, d_out) weight; :func:`draw_` gives it N(0, 2/(d_in+d_out))."""
    return param((d_in, d_out), dtype, device)


def expert_init(e, d_in, d_out, dtype, device) -> nn.Parameter:
    """``e`` stacked (d_in, d_out) expert weights; :func:`draw_` gives them
    N(0, 2/(d_in+d_out))."""
    return param((e, d_in, d_out), dtype, device)


def embed_init(vocab, d, dtype, device) -> nn.Parameter:
    """A (vocab, d) table; :func:`draw_` gives it N(0, 1/d)."""
    return param((vocab, d), dtype, device)


def _scaled_normal_(p: torch.Tensor, scale: float, gen) -> None:
    p.normal_(generator=gen)
    # the reference multiplies by the scale rounded to the parameter dtype
    p.mul_(torch.tensor(scale, dtype=p.dtype).item())


@torch.no_grad()
def draw_(name: str, p: torch.Tensor, gen: torch.Generator,
          norm: str) -> None:
    """Fill parameter ``name`` in place with the reference's init rule:
    dense and expert weights N(0, 2/(d_in+d_out)) over their last two
    dimensions, embedding tables N(0, 1/d), norm scales 0 (RMSNorm's
    ``1 + scale``) or 1 (LayerNorm), biases 0; the RG-LRU's conv weights
    N(0, 0.01), its conv bias 0 and its Λ from
    ``models.rglru.log_lambda_init``; RWKV6's interpolation weights 0.5
    (``mu`` N(0.5, 0.02²)), its shift LoRA's second factor and its bonus
    N(0, 0.02²), its decay base ``models.rwkv6.decay_base_init`` and its
    group norm's scale 1 and bias 0."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in EMBED_NAMES:
        _scaled_normal_(p, p.shape[1] ** -0.5, gen)
    elif leaf == "scale":
        p.fill_(0.0 if norm == "rmsnorm" else 1.0)
    elif leaf in ("bias", "conv_b", "gn_bias"):
        p.zero_()
    elif leaf == "gn_scale":
        p.fill_(1.0)
    elif leaf in ("mu_x", "mu_k", "mu_r"):
        p.fill_(0.5)
    elif leaf in ("shift_w2", "bonus_u"):
        _scaled_normal_(p, 0.02, gen)
    elif leaf == "mu":
        _scaled_normal_(p, 0.02, gen)
        p.add_(0.5)
    elif leaf == "decay_base":
        from repro_torch.models.rwkv6 import decay_base_init
        p.copy_(decay_base_init(p.shape[0], p.dtype, p.device))
    elif leaf == "conv_w":
        _scaled_normal_(p, 0.1, gen)
    elif leaf == "log_lambda":
        from repro_torch.models.rglru import log_lambda_init
        p.copy_(log_lambda_init(p.shape[0], p.device).to(p.dtype))
    else:
        _scaled_normal_(p, (2.0 / (p.shape[-2] + p.shape[-1])) ** 0.5, gen)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d, dtype, device):
    return nn.ParameterDict({"scale": param((d,), dtype, device)})


def rmsnorm(params, x, eps=1e-6):
    """Gemma-style RMSNorm, ``x / rms(x) * (1 + scale)``, in float32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    nx = xf * torch.rsqrt(var + eps)
    return (nx * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d, dtype, device):
    return nn.ParameterDict({"scale": param((d,), dtype, device),
                             "bias": param((d,), dtype, device)})


def layernorm(params, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    nx = (xf - mu) * torch.rsqrt(var + eps)
    return (nx * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(d, d_ff, dtype, device, gated: bool):
    p = {"w_in": dense_init(d, d_ff, dtype, device),
         "w_out": dense_init(d_ff, d, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(d, d_ff, dtype, device)
    return nn.ParameterDict(p)


def mlp_apply(params, x, activation: str):
    h = x @ params["w_in"]
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    elif activation == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * h
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(activation)
    return h @ params["w_out"]


def is_gated(activation: str) -> bool:
    return activation in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# RoPE (rotate-half, not interleaved) and qwen2-vl's M-RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate_half(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate x's two halves by the float32 angles ``ang`` (b, 1, t, half);
    the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (b, h, t, d_head); positions: (b, t) int. Angles and the rotation
    in float32, the result cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    return _rotate_half(x, positions[:, None, :, None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE. x: (b, h, t, d_head); positions: (b, 3, t)
    int, the (temporal, height, width) ids.

    The rotary half-dim is split into ``sections`` (t, h, w), and each
    section rotates by its own position stream. Text tokens carry equal
    (t, h, w) ids, which gives :func:`apply_rope`'s result bit for bit; a
    vision patch's ids come from the (stubbed) front end. Angles and the
    rotation in float32, the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    parts, start = [], 0
    for s_i, sec in enumerate(sections):
        pos = positions[:, s_i]                                  # (b, t)
        parts.append(pos[:, None, :, None].float() * freqs[start:start + sec])
        start += sec
    return _rotate_half(x, torch.cat(parts, dim=-1))             # (b,1,t,half)
