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

``rglru_lru_bwd_ref(u, xi, xr, log_lambda, dh, dlast)`` is its gradient,
the plain version of S-bwd (``csrc/rglru_scan_bwd.cu``): the gates and h
recomputed in float32, the reverse recurrence ``dH_t = dh_t + a_{t+1} ·
dH_{t+1}``, then back through the gates. Float64 inputs stay float64 in
both functions (the tests hold the backward to autograd of the forward in
float64); float32 and bf16 work in float32.
"""
from __future__ import annotations

import torch

C = 8.0             # Griffin's recurrence sharpness constant


def _work(x):
    """x in float32, or as it is where it is float64."""
    return x if x.dtype == torch.float64 else x.float()


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def decay_rate(log_lambda: torch.Tensor) -> torch.Tensor:
    """-C · softplus(Λ) in float32, so that a = exp(decay_rate · r)."""
    return -C * softplus(_work(log_lambda))


def rglru_gates_ref(xi, xr, u, nsp):
    """The gates' elementwise part: a (the decay) and the gated input g,
    float32, from the two gate products, the conv output u and
    ``decay_rate(Λ)``. The sigmoids run in the products' type."""
    i_gate = _work(torch.sigmoid(xi))
    r_gate = _work(torch.sigmoid(xr))
    a = torch.exp(nsp * r_gate)
    gated_in = (torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12))
                * i_gate * _work(u))
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


def rglru_lru_bwd_ref(u, xi, xr, log_lambda, dh, dlast=None):
    """The gradient of ``rglru_lru_ref``'s (h, last h) at (dh, dlast):
    (du, dxi, dxr) in u's type and dΛ (channels,) in float32 (float64 for
    float64 inputs). ``dlast`` None is zero.

    With the gates i = σ(xi), r = σ(xr) (rounded to the inputs' type, as
    the forward's), a = exp(nsp · r), x = 1 - a², s = √max(x, 1e-12),
    g = s · i · u and h_{-1} = 0:

    - dH_t = dh_t + a_{t+1} · dH_{t+1}, from dH_{T-1} = dh_{T-1} + dlast;
    - da_t = dH_t · h_{t-1} - 2 a_t · dx_t, dg_t = dH_t, where dx = ds ·
      0.5 / s · [x > 1e-12] with ds = dg · i · u; at x = 1e-12 the clamp
      passes half (JAX's rule for ``maximum``: a tie splits the gradient
      between its two arguments);
    - dr = da · a · nsp, dxr = dr · r (1 - r); dxi = dg · s · u · i (1 -
      i); du = dg · s · i;
    - dΛ = -C · σ(Λ) · Σ_{batch, T} da · a · r, summed over T, then over
      the batch.
    """
    work = _work(u).dtype
    lam = _work(log_lambda)
    nsp = -C * softplus(lam)
    i = _work(torch.sigmoid(xi))
    r = _work(torch.sigmoid(xr))
    uf = _work(u)
    a = torch.exp(nsp * r)
    x = 1.0 - torch.square(a)
    s = torch.sqrt(torch.clamp_min(x, 1e-12))
    h = rglru_scan_ref(a, s * i * uf)
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    dhf = dh.to(work)
    dH = torch.empty_like(h)
    nxt = (torch.zeros_like(h[:, 0]) if dlast is None
           else dlast.to(work).clone())
    for t in range(h.shape[1] - 1, -1, -1):
        dH[:, t] = dhf[:, t] + nxt
        nxt = a[:, t] * dH[:, t]
    clamp = torch.where(x > 1e-12, 1.0, torch.where(x == 1e-12, 0.5, 0.0))
    dx = dH * i * uf * 0.5 / s * clamp
    da = dH * hprev - 2.0 * a * dx
    dloga = da * a
    dxr = dloga * nsp * r * (1.0 - r)
    dxi = dH * s * uf * i * (1.0 - i)
    du = dH * s * i
    dnsp = (dloga * r).sum(1).sum(0)
    dlam = dnsp * (-C) * torch.sigmoid(lam)
    return du.to(u.dtype), dxi.to(u.dtype), dxr.to(u.dtype), dlam
