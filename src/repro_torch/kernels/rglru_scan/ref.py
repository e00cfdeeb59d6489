"""The plain version of S, the RG-LRU's gates and recurrence.

``rglru_lru_ref(u, xi, xr, log_lambda)`` is, over (batch, T, channels)
tensors of one type (the model's), ``rglru_gates_ref``'s (a, g) followed by
``rglru_scan_ref``: ``h_t = a_t · h_{t-1} + g_t`` from ``h_{-1} = 0``,
stepped over T in order, each step a multiply, then an add, each rounded
(no FMA). It returns h in the inputs' type (the cast that the model's mix
does) and the last step's h in float32 (the decode state).
``csrc/rglru_scan.cu`` repeats these torch ops' arithmetic bit for bit on
the card; the model's ``_gates`` (the decode step) calls the same
``rglru_gates_ref``, so the two cannot drift.

It stands for ``_gates`` and ``jax.lax.associative_scan(compose, (a, b),
axis=1)`` in ``src/repro/models/rglru.py``, whose tree order differs from
the step loop in the last bits.
"""
from __future__ import annotations

import torch

C = 8.0             # Griffin's recurrence sharpness constant


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def decay_rate(log_lambda: torch.Tensor) -> torch.Tensor:
    """-C · softplus(Λ) in float32, so that a = exp(decay_rate · r)."""
    return -C * softplus(log_lambda.float())


def rglru_gates_ref(xi, xr, u, nsp):
    """The gates' elementwise part: a (the decay) and the gated input g,
    float32, from the two gate products, the conv output u and
    ``decay_rate(Λ)``. The sigmoids run in the products' type."""
    i_gate = torch.sigmoid(xi).float()
    r_gate = torch.sigmoid(xr).float()
    a = torch.exp(nsp * r_gate)
    gated_in = (torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12))
                * i_gate * u.float())
    return a, gated_in


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t from h_{-1} = 0 over the time axis of
    (batch, T, channels) float32, step by step."""
    h = a.new_zeros(a.shape[0], a.shape[2])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1) if out else torch.zeros_like(a)


def rglru_lru_ref(u, xi, xr, log_lambda):
    """(h in u's type, the last step's h in float32)."""
    a, g = rglru_gates_ref(xi, xr, u, decay_rate(log_lambda))
    h = rglru_scan_ref(a, g)
    last = h[:, -1] if h.shape[1] else h.new_zeros(h.shape[0], h.shape[2])
    return h.to(u.dtype), last.clone()
