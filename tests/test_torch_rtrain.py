"""The recurrent families' training path on the CPU: the plain versions of
the port's three backward kernels against the JAX package's autodiff, and
against torch autograd of their own plain forwards.

* S-bwd's plain version (``rglru_scan.ref.rglru_lru_bwd_ref``) against
  ``jax.grad`` of the reference's ``_gates`` followed by
  ``jax.lax.associative_scan``, composed as ``rglru_apply`` composes them
  (``src/repro/models/rglru.py:63-76``), on the same numpy inputs: the
  gradients of u, the two gate matrices and Λ, the port's dxi and dxr
  carried through the gate products (u @ W) by the chain rule; float32.
* W-bwd's plain version (``rwkv6_wkv.ref.wkv_bwd_ref``) against
  ``jax.grad`` of the reference's ``rwkv6_apply`` (its ``lax.scan``), with
  ``_project`` handing the scan the test's r, k, v and logw and the group
  norm, gate and output projection made the identity, so that the output
  is the scan's y; float32.
* Both against torch autograd of their plain forwards (``rglru_lru_ref``,
  ``wkv_ref``) in float64, with a gradient of the last h or state too.
* K3-bwd's plain version at head_dim 256, with a window and MQA (1 kv head
  for 4 query heads), against the reference's autodiff of
  ``flash_attention(impl="ref")``.
* On CPU tensors the ops' gradients are those plain versions and launch
  nothing; the backward wrappers' argument checks.

Tolerances (measured on these inputs, CPU): float64 against autograd
1e-10 relative to the tensor's max (measured <= 5e-16); against JAX in
float32, each max |port - JAX| over the tensor's max |JAX|: S 1e-4
(RTRAIN_S_TOL; measured 1.33e-5, u's gradient at T = 300: the reference's
tree-ordered scan against the step loop, over decays up to 0.999) and W
1e-5 (RTRAIN_W_TOL; measured 3.4e-7); K3-bwd 1e-5 absolute on N(0, 1)
inputs (as tests/test_torch_train.py's d = 16 case).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as JR
import repro.models.rwkv6 as JW
from repro.kernels.flash_attention.ops import flash_attention as jfa
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rglru_scan import ops as s_ops
from repro_torch.kernels.rglru_scan.ref import (rglru_lru_bwd_ref,
                                                rglru_lru_ref)
from repro_torch.kernels.rwkv6_wkv import ops as w_ops
from repro_torch.kernels.rwkv6_wkv import ref as w_ref
from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref, wkv_ref
from repro_torch.models.rglru import log_lambda_init

F64_TOL = 1e-10
RTRAIN_S_TOL = 1e-4
RTRAIN_W_TOL = 1e-5
K3_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# S-bwd
# ---------------------------------------------------------------------------
def _jax_lru_grads(u, wi, wr, lam, dh, dlast):
    """jax.grad of Σ h·dh + Σ h_T·dlast, h the reference's ``_gates`` then
    ``associative_scan`` (as ``rglru_apply`` composes them), w.r.t. u, the
    two gate matrices and Λ."""
    def compose(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    def loss(u, wi, wr, lam):
        a, b = JR._gates({"w_input_gate": wi, "w_rec_gate": wr,
                          "log_lambda": lam}, u)
        _, h = jax.lax.associative_scan(compose, (a, b), axis=1)
        return jnp.sum(h * dh) + jnp.sum(h[:, -1] * dlast)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (u, wi, wr, lam)))


def _hold_lru(u, wi, wr, lam, dh, dlast):
    """The plain backward's gradients of u, the gate matrices and Λ (dxi
    and dxr carried through u @ W) against ``_jax_lru_grads``."""
    want = _jax_lru_grads(u, wi, wr, lam, dh, dlast)
    ut, wit, wrt = (torch.from_numpy(x) for x in (u, wi, wr))
    xi, xr = ut @ wit, ut @ wrt
    du, dxi, dxr, dlam = rglru_lru_bwd_ref(
        ut, xi, xr, torch.from_numpy(lam), torch.from_numpy(dh),
        torch.from_numpy(dlast))
    assert dlam.dtype == torch.float32 and dlam.shape == lam.shape
    got = (du + dxi @ wit.T + dxr @ wrt.T,
           torch.einsum("btc,btd->cd", ut, dxi),
           torch.einsum("btc,btd->cd", ut, dxr), dlam)
    for name, g, w in zip(("u", "w_input_gate", "w_rec_gate", "log_lambda"),
                          got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), w) < RTRAIN_S_TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("t", [1, 37, 64, 65, 300])
def test_lru_bwd_plain_version_matches_jax_grad(t):
    rng = np.random.RandomState(t)
    b, d = 2, 24
    u = _normal(rng, b, t, d)
    wi, wr = _normal(rng, d, d, scale=d ** -0.5), _normal(rng, d, d,
                                                          scale=d ** -0.5)
    lam = log_lambda_init(d).numpy()
    _hold_lru(u, wi, wr, lam, _normal(rng, b, t, d), _normal(rng, b, d))


def test_lru_bwd_below_the_clamp_matches_jax_grad():
    """Λ very negative: a = exp(-8·softplus(Λ)·r) rounds to 1 and 1 - a² to
    0, below the clamp of 1e-12, where ``maximum`` passes a nothing
    through the square root; with Λ spread over the init's range beside
    it. (At a tie, 1 - a² equal to the clamp, both split the gradient in
    half: JAX's rule for ``maximum``.)"""
    rng = np.random.RandomState(11)
    b, t, d = 1, 20, 8
    lam = log_lambda_init(d).numpy()
    lam[:3] = -30.0
    _hold_lru(_normal(rng, b, t, d), _normal(rng, d, d, scale=0.3),
              _normal(rng, d, d, scale=0.3), lam, _normal(rng, b, t, d),
              _normal(rng, b, d))


@pytest.mark.parametrize("last", [False, True])
def test_lru_bwd_plain_version_is_autograd_of_its_forward_in_float64(last):
    g = torch.Generator().manual_seed(3)
    b, t, d = 2, 50, 12
    u, xi, xr = (torch.randn(b, t, d, generator=g, dtype=torch.float64)
                 .requires_grad_(True) for _ in range(3))
    lam = (log_lambda_init(d).double()
           + 0.5 * torch.randn(d, generator=g, dtype=torch.float64)
           ).requires_grad_(True)
    dh = torch.randn(b, t, d, generator=g, dtype=torch.float64)
    dlast = torch.randn(b, d, generator=g, dtype=torch.float64) if last \
        else None
    h, h_last = rglru_lru_ref(u, xi, xr, lam)
    assert h.dtype == torch.float64
    out = (h * dh).sum() + ((h_last * dlast).sum() if last else 0.0)
    want = torch.autograd.grad(out, (u, xi, xr, lam))
    got = rglru_lru_bwd_ref(*(x.detach() for x in (u, xi, xr, lam)), dh,
                            dlast)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        assert _rel(a, w) < F64_TOL


def test_lru_op_gradient_on_the_cpu_is_the_plain_backward():
    g = torch.Generator().manual_seed(4)
    u, xi, xr = (torch.randn(2, 70, 16, generator=g).requires_grad_(True)
                 for _ in range(3))
    lam = log_lambda_init(16).requires_grad_(True)
    dh = torch.randn(2, 70, 16, generator=g)
    before = (s_ops.rglru_lru.launches, s_ops.rglru_lru_bwd.launches)
    h, _ = s_ops.rglru_lru(u, xi, xr, lam)
    got = torch.autograd.grad(h, (u, xi, xr, lam), dh)
    want = rglru_lru_bwd_ref(*(x.detach() for x in (u, xi, xr, lam)), dh)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (s_ops.rglru_lru.launches, s_ops.rglru_lru_bwd.launches) == before
    with torch.no_grad():                        # no graph, the forward only
        assert not s_ops.rglru_lru(u, xi, xr, lam)[0].requires_grad


def test_lru_bwd_wrapper_checks():
    u = torch.zeros(1, 8, 8)
    lam = torch.zeros(8)
    with pytest.raises(ValueError, match="one shape"):
        s_ops.rglru_lru_bwd(u, u, u, lam, u[:, 1:])
    with pytest.raises(ValueError, match="one type"):
        s_ops.rglru_lru_bwd(u, u, u, lam, u.bfloat16())
    with pytest.raises(ValueError, match="Λ"):
        s_ops.rglru_lru_bwd(u, u, u, lam[1:], u)
    with pytest.raises(ValueError, match="dlast"):
        s_ops.rglru_lru_bwd(u, u, u, lam, u, torch.zeros(2, 8))


# ---------------------------------------------------------------------------
# W-bwd
# ---------------------------------------------------------------------------
class _Cfg:
    rwkv_heads = 3
    rwkv_head_dim = 16


def _wkv_inputs(rng, b, t, h, hd):
    r, k, v = (_normal(rng, b, t, h, hd) for _ in range(3))
    base = np.linspace(-6.0, -0.5, h * hd).reshape(h, hd)
    logw = -np.exp(base + 0.5 * rng.normal(size=(b, t, h, hd))).astype(
        np.float32)
    u = _normal(rng, h, hd, scale=0.5)
    return r, k, v, logw, u


def _jax_wkv_grads(monkeypatch, r, k, v, logw, u, dy):
    """jax.grad of Σ y·dy, y the scan of the reference's ``rwkv6_apply``
    on r, k, v and logw (``_project`` patched to hand them over; the group
    norm, the gate and the output projection the identity), w.r.t. r, k,
    v, logw and the bonus u."""
    b, t, h, hd = r.shape
    d = h * hd
    x = jnp.zeros((b, t, d), jnp.float32)

    def loss(r, k, v, logw, u):
        monkeypatch.setattr(JW, "_project", lambda p, c, x, xp: (
            r, k, v, jnp.ones((b, t, d), jnp.float32), logw))
        monkeypatch.setattr(JW, "_group_norm", lambda p, y, n, eps=1e-5: y)
        out = JW.rwkv6_apply({"bonus_u": u, "w_o": jnp.eye(d)}, _Cfg, x)
        return jnp.sum(out.reshape(b, t, h, hd) * dy)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)))


@pytest.mark.parametrize("t", [1, 7, 64, 100])
def test_wkv_bwd_plain_version_matches_jax_grad(monkeypatch, t):
    rng = np.random.RandomState(10 + t)
    r, k, v, logw, u = _wkv_inputs(rng, 2, t, 3, 16)
    dy = _normal(rng, 2, t, 3, 16)
    want = _jax_wkv_grads(monkeypatch, r, k, v, logw, u, dy)
    got = wkv_bwd_ref(*(torch.from_numpy(a) for a in (r, k, v, logw, u, dy)))
    assert got[3].dtype == got[4].dtype == torch.float32
    assert tuple(got[4].shape) == (3, 16)
    for name, g, w in zip(("r", "k", "v", "logw", "u"), got, want):
        assert _rel(g.numpy(), w) < RTRAIN_W_TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("chunk", [7, 512])
@pytest.mark.parametrize("last", [False, True])
def test_wkv_bwd_plain_version_is_autograd_of_its_forward_in_float64(
        monkeypatch, chunk, last):
    """In float64, checkpointed every ``chunk`` steps (7: a T no chunk
    divides; 512: one chunk), with a gradient of the last state too."""
    monkeypatch.setattr(w_ref, "CHUNK", chunk)
    g = torch.Generator().manual_seed(5)
    b, t, h, hd = 2, 23, 3, 16
    r, k, v = (torch.randn(b, t, h, hd, generator=g, dtype=torch.float64)
               .requires_grad_(True) for _ in range(3))
    logw = (-torch.exp(torch.randn(b, t, h, hd, generator=g,
                                   dtype=torch.float64) - 1.0)
            ).requires_grad_(True)
    u = torch.randn(h, hd, generator=g, dtype=torch.float64
                    ).requires_grad_(True)
    y, S = wkv_ref(r, k, v, logw, u)
    assert y.dtype == S.dtype == torch.float64
    dy = torch.randn_like(y)
    dS = torch.randn_like(S) if last else None
    out = (y * dy).sum() + ((S * dS).sum() if last else 0.0)
    want = torch.autograd.grad(out, (r, k, v, logw, u))
    got = wkv_bwd_ref(*(x.detach() for x in (r, k, v, logw, u)), dy, dS)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        assert _rel(a, w) < F64_TOL


def test_wkv_op_gradient_on_the_cpu_is_the_plain_backward():
    g = torch.Generator().manual_seed(6)
    r, k, v = (torch.randn(2, 30, 3, 16, generator=g).requires_grad_(True)
               for _ in range(3))
    logw = (-torch.exp(torch.randn(2, 30, 3, 16, generator=g))
            ).requires_grad_(True)
    u = torch.randn(3, 16, generator=g).requires_grad_(True)
    dy = torch.randn(2, 30, 3, 16, generator=g)
    before = (w_ops.rwkv6_wkv.launches, w_ops.rwkv6_wkv_bwd.launches)
    y, _ = w_ops.rwkv6_wkv(r, k, v, logw, u)
    got = torch.autograd.grad(y, (r, k, v, logw, u), dy)
    want = wkv_bwd_ref(*(x.detach() for x in (r, k, v, logw, u)), dy)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (w_ops.rwkv6_wkv.launches,
            w_ops.rwkv6_wkv_bwd.launches) == before


def test_wkv_bwd_wrapper_checks():
    r = torch.zeros(1, 4, 2, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="dy"):
        w_ops.rwkv6_wkv_bwd(r, r, r, r, u, r[:, 1:])
    with pytest.raises(ValueError, match="dy"):
        w_ops.rwkv6_wkv_bwd(r, r, r, r, u, r.double())
    with pytest.raises(ValueError, match="dS"):
        w_ops.rwkv6_wkv_bwd(r, r, r, r, u, r, torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="one type"):
        w_ops.rwkv6_wkv_bwd(r.half(), r.half(), r.half(), r, u, r)


# ---------------------------------------------------------------------------
# K3-bwd at head_dim 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 32])
def test_attention_bwd_plain_version_at_d256_matches_jax(window):
    """The plain backward at recurrentgemma-2b's head_dim, MQA (4 query
    heads on 1 kv head) and its local window, against the reference's
    autodiff of ``attention_ref`` (GQA through ``jnp.repeat``)."""
    rng = np.random.RandomState(7)
    q = _normal(rng, 1, 4, 80, 256)
    k, v = _normal(rng, 1, 1, 80, 256), _normal(rng, 1, 1, 80, 256)
    dout = _normal(rng, 1, 4, 80, 256)
    got = fa.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), None,
        torch.from_numpy(dout), None, causal=True, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jfa(a, b, c, causal=True, window=window,
                                         impl="ref"),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(dout))):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() < K3_TOL
