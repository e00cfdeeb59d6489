"""The port's RG-LRU (repro_torch.models.rglru) and S's plain version
(kernels/rglru_scan) against the JAX package's, on the CPU, in float32.

The same numpy inputs and weights go through ``repro.models.rglru`` and
its port: the gates, the causal conv with and without a conv state, the
full-sequence mixer, the prefill (output and decode state) and a decode
step; the scan's plain version against ``jax.lax.associative_scan`` and
against a step-by-step loop; Λ's init. On the CPU ``rglru_scan`` is the
plain version and launches nothing.

Tolerances, max abs (measured on these inputs, CPU, float32): the gates
2.3e-6 (1e-5); the conv bit for bit (0.0); the mixer, prefill and decode
<= 9.6e-7 on outputs of ~1.4 and states (1e-5); the scan 1.9e-6 on
|h| <= 12 (2e-5: the reference's tree order against the plain version's
chunks); Λ 5.1e-5 on |Λ| <= 9 (relative 1e-4: linspace rounds apart in
the two packages, and log(expm1(·)) of small arguments magnifies it).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as JR
import repro_torch.models.rglru as TR
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import CHUNK, rglru_scan_ref

TOL = 1e-5
SCAN_TOL = 2e-5
CFG = SimpleNamespace(d_model=32, lru_width=48)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def weights():
    """The reference's init (Λ included), with a nonzero conv bias, as
    numpy: the same numbers for both packages."""
    p = {k: np.asarray(v) for k, v in
         JR.rglru_init(jax.random.PRNGKey(1), CFG, jnp.float32).items()}
    p["conv_b"] = (np.random.RandomState(9).normal(size=p["conv_b"].shape)
                   * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _inputs(seed, *shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def test_gates_match_reference(weights):
    jp, tp = weights
    u = _inputs(0, 2, 100, 48)
    aj, bj = JR._gates(jp, jnp.asarray(u))
    at, bt = TR._gates(tp, torch.from_numpy(u))
    assert at.dtype == bt.dtype == torch.float32
    assert np.abs(at.numpy() - _np(aj)).max() < TOL
    assert np.abs(bt.numpy() - _np(bj)).max() < TOL
    assert float(at.min()) > 0 and float(at.max()) < 1


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 2, 50])
def test_causal_conv_matches_reference(weights, with_state, t):
    jp, tp = weights
    u = _inputs(1, 2, t, 48)
    st = _inputs(2, 2, TR.CONV_WIDTH - 1, 48) if with_state else None
    oj, sj = JR._causal_conv(jp, jnp.asarray(u),
                             None if st is None else jnp.asarray(st))
    ot, s_t = TR._causal_conv(tp, torch.from_numpy(u),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(ot.numpy(), _np(oj))
    np.testing.assert_array_equal(s_t.numpy(), _np(sj))
    assert s_t.shape == (2, TR.CONV_WIDTH - 1, 48)


def test_apply_prefill_and_decode_match_reference(weights):
    jp, tp = weights
    x = _inputs(3, 2, 100, 32)
    yj = JR.rglru_apply(jp, CFG, jnp.asarray(x))
    yt = TR.rglru_apply(tp, CFG, torch.from_numpy(x))
    assert np.abs(yt.numpy() - _np(yj)).max() < TOL

    pj, sj = JR.rglru_prefill(jp, CFG, jnp.asarray(x[:, :90]))
    pt, s_t = TR.rglru_prefill(tp, CFG, torch.from_numpy(x[:, :90]))
    assert np.abs(pt.numpy() - _np(pj)).max() < TOL
    assert s_t["h"].dtype == torch.float32 and s_t["h"].shape == (2, 48)
    for key in ("h", "conv"):
        assert np.abs(s_t[key].numpy() - _np(sj[key])).max() < TOL
    for i in range(90, 100):          # decode continues the full sequence
        dj, sj = JR.rglru_decode_step(jp, CFG, jnp.asarray(x[:, i:i + 1]), sj)
        dt, s_t = TR.rglru_decode_step(tp, CFG, torch.from_numpy(x[:, i:i + 1]),
                                       s_t)
        assert np.abs(dt.numpy() - _np(dj)).max() < TOL
        assert np.abs(dt.numpy()[:, 0] - yt.numpy()[:, i]).max() < TOL
        assert np.abs(s_t["h"].numpy() - _np(sj["h"])).max() < TOL


def test_state_init_matches_reference():
    sj = JR.rglru_state_init(3, CFG, jnp.bfloat16)
    st = TR.rglru_state_init(3, CFG, torch.bfloat16)
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16
    for key in ("h", "conv"):
        assert tuple(st[key].shape) == sj[key].shape
        assert not st[key].any()


def test_log_lambda_init_matches_reference():
    want = _np(JR.rglru_init(jax.random.PRNGKey(0),
                             SimpleNamespace(d_model=8, lru_width=2560),
                             jnp.float32)["log_lambda"])
    got = TR.log_lambda_init(2560).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    a = np.exp(-TR.C * np.logaddexp(got.astype(np.float64), 0))
    assert 0.9 - 1e-6 < a.min() and a.max() < 0.999 + 1e-6


@pytest.mark.parametrize("t", [1, 63, 64, 65, 1000])
def test_scan_plain_version_matches_associative_scan(t):
    rng = np.random.RandomState(t)
    a = (rng.rand(3, t, 40) * 0.2 + 0.8).astype(np.float32)
    b = rng.normal(size=(3, t, 40)).astype(np.float32)

    def compose(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    _, want = jax.lax.associative_scan(compose, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3, t, 40) and got.dtype == torch.float32
    assert np.abs(got.numpy() - _np(want)).max() < SCAN_TOL


def test_scan_plain_version_is_the_step_loop_within_a_chunk():
    """Inside the first chunk the order is the step loop's, bit for bit;
    past it, the carried state differs in the last bits only."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 3 * CHUNK + 5, 7, generator=g) * 0.5 + 0.5
    b = torch.randn(2, 3 * CHUNK + 5, 7, generator=g)
    h, loop = torch.zeros(2, 7), []
    for i in range(a.shape[1]):
        h = a[:, i] * h + b[:, i]
        loop.append(h)
    loop = torch.stack(loop, 1)
    got = rglru_scan_ref(a, b)
    assert torch.equal(got[:, :CHUNK], loop[:, :CHUNK])
    assert float((got - loop).abs().max()) < SCAN_TOL


def test_scan_op_on_the_cpu_is_the_plain_version_and_launches_nothing():
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 130, 9, generator=g)
    b = torch.randn(2, 130, 9, generator=g)
    before = ops.rglru_scan.launches
    assert torch.equal(ops.rglru_scan(a, b), rglru_scan_ref(a, b))
    assert ops.rglru_scan.launches == before
    assert ops.rglru_scan(a[:, :0], b[:, :0]).shape == (2, 0, 9)
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b[:, 1:])
    with pytest.raises(ValueError):
        ops.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError):
        ops.rglru_scan(a.to("meta"), b.to("meta"))
