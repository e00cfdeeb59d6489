"""W-bwd's chunked arithmetic (``ref.wkv_bwd_chunked``, the plain mirror of
``csrc/rwkv6_wkv_bwd.cu``) against W-bwd's plain version, against torch
autograd of W's plain forward, and against the JAX package's autodiff, on
the CPU.

The CUDA kernel cannot run here, so this is where its mathematics is held:
chunks of 16 steps from a checkpointed state, the chain G ← D ⊙ G + r̃ᵀ dY,
the products dr̃ = dY S0ᵀ, dK̂ = V Gᵀ, dV = Aᵀ dY + K̂ G and dA = dY Vᵀ,
and dr, dk, du and dlogw through the decays, every factor a product of
decays of at most 1 (W[t, s] as products of w, P, Q and D as powers of 2
of sums <= 0), none inverted.

Cases: T = 1, 7, 16, 23 and 100 (one step, a T below one chunk, one chunk,
ragged last chunks), head sizes 16 and 64, with and without a gradient of
the last state; a strong-decay draw (the decay base + 3: the fastest
channels decay by e^-12 a step), where every output stays finite.

Limits: in float64, max |got - want| over the tensor's max |want|, 1e-10
against ``wkv_bwd_ref`` and against torch autograd of ``wkv_ref``
(measured 1.3e-15); in float32 against ``jax.grad`` of the reference's
``rwkv6_apply`` (its ``lax.scan``, through
``test_torch_rtrain._jax_wkv_grads``), RTRAIN_W_TOL = 1e-5, the limit W-bwd's
plain version is held to there (measured 4.2e-7).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_wkv.ref import (wkv_bwd_chunked, wkv_bwd_ref,
                                               wkv_ref)
from test_torch_rtrain import RTRAIN_W_TOL, _jax_wkv_grads

F64_TOL = 1e-10
NAMES = ("dr", "dk", "dv", "dlogw", "du")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, h, hd, shift, seed, dtype=np.float64):
    """r, k, v N(0, 1); logw = -exp(lw), lw spread over the channels as
    rwkv6's decay base (-6 to -0.5) plus ``shift`` plus N(0, 0.25); u
    N(0, 0.25); dy N(0, 1) and dS N(0, 1); numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.normal(size=(b, t, h, hd)) for _ in range(3))
    base = shift + np.linspace(-6.0, -0.5, h * hd).reshape(h, hd)
    logw = -np.exp(base + 0.5 * rng.normal(size=(b, t, h, hd)))
    u = 0.5 * rng.normal(size=(h, hd))
    dy = rng.normal(size=(b, t, h, hd))
    dS = rng.normal(size=(b, h, hd, hd))
    return tuple(x.astype(dtype) for x in (r, k, v, logw, u, dy, dS))


def _rel(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _autograd(r, k, v, logw, u, dy, dS):
    """torch autograd of Σ y·dy (+ Σ S_T·dS) through ``wkv_ref``."""
    xs = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u)]
    y, S = wkv_ref(*xs)
    out = (y * dy).sum() + ((S * dS).sum() if dS is not None else 0.0)
    return torch.autograd.grad(out, xs, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", [1, 7, 16, 23, 100])
def test_chunked_bwd_is_the_plain_bwd_and_autograd_in_float64(t, hd, last):
    b, h = (2, 3) if hd == 16 else (1, 2)
    r, k, v, logw, u, dy, dS = (torch.from_numpy(x) for x in _inputs(
        b, t, h, hd, 0.0, 100 * t + hd + last))
    dS = dS if last else None
    got = wkv_bwd_chunked(r, k, v, logw, u, dy, dS)
    ref = wkv_bwd_ref(r, k, v, logw, u, dy, dS)
    auto = _autograd(r, k, v, logw, u, dy, dS)
    for name, a, w, z in zip(NAMES, got, ref, auto):
        assert a.dtype == torch.float64 and a.shape == w.shape, name
        assert _rel(a, w) < F64_TOL, (name, _rel(a, w))
        assert _rel(a, z) < F64_TOL, (name, _rel(a, z))


@pytest.mark.parametrize("last", [False, True])
def test_chunked_bwd_under_strong_decay_in_float64(last):
    """The decay base + 3 (log-decays down to about -12 a step and below):
    a rank-1 split of the decays over a chunk would overflow; every output
    here is finite and within the float64 limit."""
    r, k, v, logw, u, dy, dS = (torch.from_numpy(x) for x in _inputs(
        1, 77, 2, 64, 3.0, 7 + last))
    assert float(logw.min()) < -12.0
    dS = dS if last else None
    got = wkv_bwd_chunked(r, k, v, logw, u, dy, dS)
    for name, a, w, z in zip(NAMES, got, wkv_bwd_ref(r, k, v, logw, u, dy,
                                                     dS),
                             _autograd(r, k, v, logw, u, dy, dS)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, w) < F64_TOL, (name, _rel(a, w))
        assert _rel(a, z) < F64_TOL, (name, _rel(a, z))


@pytest.mark.parametrize("shift", [0.0, 3.0])
@pytest.mark.parametrize("t", [7, 23, 100])
def test_chunked_bwd_matches_jax_grad_in_float32(monkeypatch, t, shift):
    """float32 inputs, the port's types (dr, dk, dv in r's, dlogw and du
    float32), against ``jax.grad`` of the reference's scan."""
    r, k, v, logw, u, dy, _ = _inputs(2, t, 3, 16, shift, 300 + t,
                                      np.float32)
    want = _jax_wkv_grads(monkeypatch, r, k, v, logw, u, dy)
    got = wkv_bwd_chunked(*(torch.from_numpy(x) for x in (r, k, v, logw, u,
                                                          dy)))
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        assert bool(torch.isfinite(a).all()), name
        w = torch.from_numpy(np.array(w))
        assert _rel(a, w) < RTRAIN_W_TOL, (name, _rel(a, w))


def test_chunked_bwd_keeps_the_types_and_a_bf16_model():
    """bf16 r, k, v give bf16 dr, dk, dv and float32 dlogw and du, as the
    kernel's wrapper returns them; within a bf16 rounding of the float32
    gradient of the same bf16 inputs."""
    r, k, v, logw, u, dy, dS = (torch.from_numpy(x) for x in _inputs(
        1, 40, 2, 64, 0.0, 11, np.float32))
    rb, kb, vb = (x.bfloat16() for x in (r, k, v))
    got = wkv_bwd_chunked(rb, kb, vb, logw, u, dy, dS)
    want = wkv_bwd_ref(*(x.float() for x in (rb, kb, vb)), logw, u, dy, dS)
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for name, a, w in zip(NAMES, got, want):
        tol = 1e-2 if name in ("dr", "dk", "dv") else RTRAIN_W_TOL
        assert _rel(a.float(), w) < tol, (name, _rel(a.float(), w))
