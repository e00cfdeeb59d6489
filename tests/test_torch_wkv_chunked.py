"""W's chunked arithmetic (``ref.wkv_chunked``, the plain mirror of
``csrc/rwkv6_wkv.cu``) against W's plain step loop and against the JAX
package's scan, on the CPU.

The CUDA kernel cannot run here, so this is where its mathematics is held:
chunks of C steps cut into sub-chunks of c, every decay a power of 2 of a
sum <= 0, the products between sub-chunks factored about their boundary
and the terms within a sub-chunk a product of decays each, as the kernel
takes them. Cases: T = 0, 1, 7,
a T below one chunk, one that no chunk divides and several chunks; hd 16
in float32 and hd 64 in bf16; the kernel's (16, 16) and (64, 16), (32, 8);
and a strong-decay draw (the decay base + 3: the fastest channels decay by
e^-12 a step), where the rank-1 split e^b_t · e^-b_s over a whole chunk
gives inf or NaN.

Limits: against ``wkv_ref`` max |got - want| over max |want|, of y and of
the last state, overall and per head, 1e-5 (W's own limit on the card,
chip_smoke.py's WKV_TOL; measured here 1.2e-7 to 7.3e-7); against the
reference's ``lax.scan`` in ``rwkv6_prefill`` (r, k, v and logw from its
own projection) ``tests/test_torch_rwkv6.py``'s max-abs limits on y and
S (WKV_Y_TOL, WKV_S_TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.rwkv6 as JR
from repro_torch.kernels.rwkv6_wkv.ref import LOG2E, wkv_chunked, wkv_ref

WKV_TOL = 1e-5
WKV_Y_TOL = 1e-4     # tests/test_torch_rwkv6.py's
WKV_S_TOL = 5e-5
JCFG = JC.reduced(JC.ARCHS["rwkv6-3b"])
# (b, T, H, hd, type, shift of the decay's log-log, chunk, sub)
CASES = [
    (2, 0, 4, 16, torch.float32, 0.0, 16, 16),
    (2, 1, 4, 16, torch.float32, 0.0, 16, 16),
    (2, 7, 4, 16, torch.float32, 0.0, 16, 16),
    (2, 12, 4, 16, torch.float32, 0.0, 16, 16),       # below one chunk
    (3, 100, 4, 16, torch.float32, 0.0, 16, 16),      # no chunk divides
    (3, 100, 4, 16, torch.float32, 0.0, 64, 16),
    (2, 77, 3, 64, torch.bfloat16, 0.0, 16, 16),
    (2, 77, 3, 64, torch.bfloat16, 0.0, 64, 16),
    (1, 40, 3, 64, torch.bfloat16, 0.0, 64, 16),      # below one chunk
    (1, 200, 2, 64, torch.bfloat16, 0.0, 16, 16),     # several chunks
    (1, 200, 2, 64, torch.bfloat16, 0.0, 32, 8),
    (1, 1, 2, 64, torch.bfloat16, 0.0, 64, 16),
    (1, 7, 2, 64, torch.bfloat16, 0.0, 16, 16),
    (1, 333, 2, 64, torch.bfloat16, 3.0, 16, 16),     # strong decay
    (1, 333, 2, 64, torch.bfloat16, 3.0, 64, 16),
    (2, 77, 4, 16, torch.float32, 3.0, 64, 16),
]


def _inputs(shape, dtype, shift, seed):
    """r, k, v N(0, 1) in dtype; logw = -exp(lw) with lw spread over the
    channels as rwkv6's decay base (-6 to -0.5) plus ``shift`` plus N(0,
    0.25) (chip_smoke.py's wkv_inputs); u N(0, 0.25); from numpy."""
    b, t, h, hd = shape
    rng = np.random.RandomState(seed)
    r, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dtype) for _ in range(3))
    base = shift + np.linspace(-6.0, -0.5, h * hd).reshape(h, hd)
    lw = base + 0.5 * rng.normal(size=shape)
    u = 0.5 * rng.normal(size=(h, hd))
    return (r, k, v, torch.from_numpy(-np.exp(lw).astype(np.float32)),
            torch.from_numpy(u.astype(np.float32)))


def _rel(got, want, dims):
    """max |got - want| over max |want| for each index the max is not
    taken over."""
    return ((got - want).abs().amax(dims)
            / want.abs().amax(dims).clamp_min(1e-30))


@pytest.mark.parametrize("case", CASES)
def test_chunked_matches_plain_version(case):
    *shape, dtype, shift, chunk, sub = case
    x = _inputs(tuple(shape), dtype, shift, sum(shape) + int(shift))
    y, S = wkv_chunked(*x, chunk=chunk, sub=sub)
    want_y, want_s = wkv_ref(*x)
    b, t, h, hd = shape
    assert y.dtype == S.dtype == torch.float32
    assert y.shape == (b, t, h, hd) and S.shape == (b, h, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    if t == 0:
        assert not S.any()
        return
    assert float(_rel(y, want_y, (0, 1, 2, 3))) <= WKV_TOL
    assert float(_rel(S, want_s, (0, 1, 2, 3))) <= WKV_TOL
    assert float(_rel(y, want_y, (0, 1, 3)).max()) <= WKV_TOL
    assert float(_rel(S, want_s, (0, 2, 3)).max()) <= WKV_TOL


def _unsplit_chunk_a(r, k, logw, chunk):
    """The first chunk's A[t][s] (s < t) by the rank-1 split about the
    chunk's start: (r_t · e^b_t) · (k_s · e^-b_{s+1}), b the decay's log
    summed from the chunk's start. Overflows where the decay is fast."""
    lg = logw[:, :chunk].float()
    b1 = lg.cumsum(1)
    b0 = b1 - lg
    a = torch.einsum("bthi,bshi->bhts", r[:, :chunk].float() * torch.exp(b0),
                     k[:, :chunk].float() * torch.exp(-b1))
    return a.tril(-1)


def test_unsplit_factorisation_overflows_where_chunked_holds():
    """At the strong-decay draw the whole-chunk rank-1 split is not
    finite; the chunked form with sub-chunks stays within WKV_TOL."""
    x = _inputs((1, 64, 2, 64), torch.bfloat16, 3.0, 5)
    r, k, v, logw, u = x
    assert not bool(torch.isfinite(_unsplit_chunk_a(r, k, logw, 64)).all())
    # the same split over the default draw is finite: the overflow is the
    # decay's, not the split's arithmetic
    d = _inputs((1, 64, 2, 64), torch.bfloat16, 0.0, 5)
    assert bool(torch.isfinite(_unsplit_chunk_a(d[0], d[1], d[3], 16)).all())
    for chunk, sub in ((64, 16), (16, 16)):
        y, S = wkv_chunked(*x, chunk=chunk, sub=sub)
        want_y, want_s = wkv_ref(*x)
        assert float(_rel(y, want_y, (0, 1, 3)).max()) <= WKV_TOL
        assert float(_rel(S, want_s, (0, 2, 3)).max()) <= WKV_TOL


def test_chunked_decays_are_powers_of_two_of_sums_at_most_zero():
    """Every exponent the chunked form takes is <= 0 (up to rounding), so
    no factor exceeds 1: checked on the strong-decay draw's sub-chunk
    sums."""
    _, _, _, logw, _ = _inputs((1, 64, 2, 64), torch.bfloat16, 3.0, 6)
    lg = logw.float() * LOG2E
    lb1 = lg.reshape(1, 4, 16, 2, 64).cumsum(2)
    lb = lb1 - lg.reshape(1, 4, 16, 2, 64)
    L = lb1[:, :, -1:]
    assert float(lb.max()) <= 0.0 and float((L - lb1).max()) <= 1e-4
    assert float(lb1.min()) < -128        # 2^-lb1 alone would overflow


def test_chunked_refuses_a_sub_chunk_that_does_not_divide():
    x = _inputs((1, 8, 1, 16), torch.float32, 0.0, 1)
    with pytest.raises(ValueError, match="divide"):
        wkv_chunked(*x, chunk=16, sub=6)


def _reference_scan(monkeypatch, cfg, params, x):
    """The reference's r, k, v, logw on x (its own projection) and its
    scan's y (captured at ``_group_norm``'s input) and last S
    (``rwkv6_prefill``)."""
    seen = []
    group_norm = JR._group_norm

    def capture(p, y, n_heads, eps=1e-5):
        seen.append(np.asarray(y, dtype=np.float32))
        return group_norm(p, y, n_heads, eps)
    monkeypatch.setattr(JR, "_group_norm", capture)
    xj = jnp.asarray(x)
    xp = jnp.pad(xj, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    r, k, v, _, logw = JR._project(params, cfg, xj, xp)
    _, state = JR.rwkv6_prefill(params, cfg, xj)
    return (r, k, v, logw), seen[0], np.asarray(state["S"])


def _torch_of(a):
    """A JAX array as a float32 torch tensor (bf16 values are exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("t,hd,chunk,sub", [
    (1, 16, 16, 16), (7, 16, 16, 16), (40, 16, 64, 16), (100, 16, 16, 16),
    (100, 16, 64, 16), (77, 64, 16, 16), (77, 64, 64, 16)])
def test_chunked_matches_reference_scan(monkeypatch, t, hd, chunk, sub):
    """At the reduced config (4 heads of 16, float32) and at one head of
    64 in bf16, the chunked form on the reference's own r, k, v, logw
    against its scan's y and last S."""
    if hd == 16:
        cfg, dtype = JCFG, jnp.float32
    else:
        cfg = dataclasses.replace(JCFG, rwkv_heads=1, rwkv_head_dim=64)
        dtype = jnp.bfloat16
    params = JR.rwkv6_init(jax.random.PRNGKey(3), cfg, dtype)
    params["bonus_u"] = jnp.asarray(
        np.random.RandomState(4).normal(size=params["bonus_u"].shape),
        dtype)
    x = np.random.RandomState(5 + t).normal(size=(2, t, 64)).astype(
        np.float32)
    (r, k, v, logw), y_want, s_want = _reference_scan(
        monkeypatch, cfg, params, jnp.asarray(x, dtype))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    rt, kt, vt = (_torch_of(a).to(tdt) for a in (r, k, v))
    y, S = wkv_chunked(rt, kt, vt, _torch_of(logw).float(),
                       _torch_of(params["bonus_u"]).float(), chunk=chunk,
                       sub=sub)
    assert np.abs(y.reshape(2, t, 64).numpy() - y_want).max() < WKV_Y_TOL
    assert np.abs(S.numpy() - s_want).max() < WKV_S_TOL
