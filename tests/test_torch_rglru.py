"""The port's RG-LRU (repro_torch.models.rglru) and S's plain version
(kernels/rglru_scan) against the JAX package's, on the CPU.

The same numpy inputs and weights go through ``repro.models.rglru`` and
its port: the gates, the causal conv with and without a conv state, the
full-sequence mixer, the prefill (output and decode state) and a decode
step, in float32; S's plain version (``rglru_lru_ref``: the gates, then
the step loop) against the reference's ``_gates`` and
``jax.lax.associative_scan`` in float32 and bf16, and bit for bit against
the model's own ``_gates`` followed by a step loop, in float32 and bf16;
the recurrence's plain version (``rglru_scan_ref``) against
``associative_scan``, and bit for bit against the decode step's own update
stepped over the same a and b; the prefill's last h against the decode
update stepped over the same tokens, bit for bit; Λ's init. On the CPU
``rglru_lru`` is the plain version and launches nothing.

Tolerances, max abs (measured on these inputs, CPU, float32): the gates
2.3e-6 (1e-5); the conv bit for bit (0.0); the mixer, prefill and decode
<= 9.6e-7 on outputs of ~1.4 and states (1e-5); the scan 1.9e-6 on
|h| <= 12 (2e-5: the reference's tree order against the plain version's
step loop); S against the reference's gates and scan 1.6e-5 on |h| <=
2.8 (LRU_TOL 5e-5: the gates' differences, within 1e-5, carried through
decays up to 0.999 over up to 1000 steps, beside the two orders); in
bf16 (the weights, u and the products in bf16 in both packages) h 1.56e-2
on |h| <= 2.75, one bf16 spacing there, and the last h 5.0e-3 (BF16_TOL
3.2e-2, two spacings at |h| < 4, and BF16_LAST_TOL 1e-2: the two packages'
bf16 products and sigmoids round apart in the last bit on some 40-60% of
elements); Λ
5.1e-5 on |Λ| <= 9 (relative 1e-4: linspace rounds apart in the two
packages, and log(expm1(·)) of small arguments magnifies it).
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
from repro_torch.kernels.rglru_scan.ref import rglru_lru_ref, rglru_scan_ref

TOL = 1e-5
SCAN_TOL = 2e-5
LRU_TOL = 5e-5
BF16_TOL = 3.2e-2        # h in bf16: two bf16 spacings at |h| < 4
BF16_LAST_TOL = 1e-2     # the last h, float32
CFG = SimpleNamespace(d_model=32, lru_width=48)
SEQ_LENS = [1, 63, 64, 65, 1000]
RAGGED = SimpleNamespace(d_model=16, lru_width=44)   # not a multiple of 8


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


def test_scan_plain_version_is_the_step_loop_within_a_chunk(monkeypatch):
    """The recurrence's plain version has the bits of the decode step's own
    update (``rglru_decode_step``, its gates replaced by the given a and b)
    stepped over the same steps, within the first 64 steps and past them:
    S runs no chunks."""
    g = torch.Generator().manual_seed(0)
    t, dl = 3 * 64 + 5, RAGGED.lru_width
    a = torch.rand(2, t, dl, generator=g) * 0.5 + 0.5
    b = torch.randn(2, t, dl, generator=g)
    tp = _ragged_weights(torch.float32)
    x = torch.from_numpy(_inputs(7, 2, t, RAGGED.d_model))
    state, hs = TR.rglru_state_init(2, RAGGED, torch.float32), []
    for i in range(t):
        monkeypatch.setattr(TR, "_gates", lambda p, u, i=i: (
            a[:, i:i + 1], b[:, i:i + 1]))
        _, state = TR.rglru_decode_step(tp, RAGGED, x[:, i:i + 1], state)
        hs.append(state["h"])
    loop = torch.stack(hs, 1)
    got = rglru_scan_ref(a, b)
    assert torch.equal(got[:, :64], loop[:, :64])
    assert torch.equal(got, loop)


def test_scan_op_on_the_cpu_is_the_plain_version_and_launches_nothing():
    """float32 at a channel count the kernel would not take: on the CPU the
    op is the plain version whatever the width."""
    g = torch.Generator().manual_seed(1)
    u, xi, xr = (torch.randn(2, 130, 9, generator=g) for _ in range(3))
    lam = TR.log_lambda_init(9)
    before = ops.rglru_lru.launches
    got = ops.rglru_lru(u, xi, xr, lam)
    want = rglru_lru_ref(u, xi, xr, lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.rglru_lru.launches == before
    assert ops.rglru_lru(u[:, :0], xi[:, :0], xr[:, :0], lam)[0].shape == (
        2, 0, 9)
    with pytest.raises(ValueError):
        ops.rglru_lru(u, xi, xr[:, 1:], lam)
    with pytest.raises(ValueError):
        ops.rglru_lru(u.double(), xi.double(), xr.double(), lam)
    with pytest.raises(ValueError):
        ops.rglru_lru(u.to("meta"), xi.to("meta"), xr.to("meta"),
                      lam.to("meta"))


def _ragged_weights(dtype):
    """The reference's init at a channel count that is not a multiple of
    8, as torch tensors of ``dtype``."""
    p = JR.rglru_init(jax.random.PRNGKey(4), RAGGED, jnp.float32)
    return {k: torch.from_numpy(np.asarray(v).copy()).to(dtype)
            for k, v in p.items()}


def _step_loop(a, g):
    """The decode step's update, ``a * h + g``, over every step."""
    h, out = torch.zeros(a.shape[0], a.shape[2]), []
    for i in range(a.shape[1]):
        h = a[:, i] * h + g[:, i]
        out.append(h)
    return torch.stack(out, 1), h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", SEQ_LENS)
def test_lru_plain_version_is_the_gates_then_the_step_loop(t, dtype):
    """S's plain version equals the model's ``_gates`` (the decode step's
    gates) followed by the step loop, bit for bit: h in the model's type,
    the last h in float32."""
    tp = _ragged_weights(dtype)
    u = torch.from_numpy(_inputs(t, 2, t, RAGGED.lru_width)).to(dtype)
    a, g = TR._gates(tp, u)
    want, last = _step_loop(a, g)
    h, h_last = TR._lru(tp, u)
    assert h.dtype == dtype and h_last.dtype == torch.float32
    assert torch.equal(h, want.to(dtype))
    assert torch.equal(h_last, last)
    xi, xr = u @ tp["w_input_gate"], u @ tp["w_rec_gate"]
    h2, last2 = rglru_lru_ref(u, xi, xr, tp["log_lambda"])
    assert torch.equal(h2, h) and torch.equal(last2, h_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", SEQ_LENS)
def test_lru_matches_reference_gates_and_associative_scan(weights, t, dtype):
    """S (its plain version, on the CPU) against the reference's
    ``_gates`` and ``associative_scan`` on the same numpy inputs, the
    weights and u cast to ``dtype`` in both packages; h compared in that
    type (the reference's ``h.astype(x.dtype)``), the last h in float32."""
    jp, tp = weights
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: v.astype(jdt) for k, v in jp.items()}
    tp = {k: v.to(tdt) for k, v in tp.items()}
    u = _inputs(10 + t, 3, t, CFG.lru_width)
    uj = jnp.asarray(u).astype(jdt)
    aj, bj = JR._gates(jp, uj)

    def compose(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    _, want = jax.lax.associative_scan(compose, (aj, bj), axis=1)
    ut = torch.from_numpy(u).to(tdt)
    h, h_last = ops.rglru_lru(ut, ut @ tp["w_input_gate"],
                              ut @ tp["w_rec_gate"], tp["log_lambda"])
    assert h.shape == (3, t, CFG.lru_width) and h.dtype == tdt
    assert h_last.dtype == torch.float32
    tol, last_tol = ((LRU_TOL, LRU_TOL) if dtype == "float32"
                     else (BF16_TOL, BF16_LAST_TOL))
    assert np.abs(h.float().numpy() - _np(want.astype(jdt))).max() < tol
    assert np.abs(h_last.numpy() - _np(want)[:, -1]).max() < last_tol


def test_prefill_last_h_is_the_decode_update_stepped_bit_for_bit(weights):
    """The prefill's decode state h equals stepping the decode step's
    update (its ``_gates``, then ``a * h + b``) over the same tokens."""
    _, tp = weights
    x = torch.from_numpy(_inputs(5, 2, 77, CFG.d_model))
    _, state = TR.rglru_prefill(tp, CFG, x)
    u, _ = TR._causal_conv(tp, x @ tp["w_x"])
    a, b = TR._gates(tp, u)
    h = torch.zeros(2, CFG.lru_width)
    for i in range(x.shape[1]):
        h = a[:, i] * h + b[:, i]
    assert torch.equal(state["h"], h)


def test_lru_op_on_the_cpu_is_the_plain_version_and_launches_nothing():
    tp = _ragged_weights(torch.bfloat16)
    u = torch.from_numpy(_inputs(6, 2, 130, RAGGED.lru_width)).bfloat16()
    xi, xr = u @ tp["w_input_gate"], u @ tp["w_rec_gate"]
    before = ops.rglru_lru.launches
    got = ops.rglru_lru(u, xi, xr, tp["log_lambda"])
    want = rglru_lru_ref(u, xi, xr, tp["log_lambda"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.rglru_lru.launches == before
    h, last = ops.rglru_lru(u[:, :0], xi[:, :0], xr[:, :0], tp["log_lambda"])
    assert h.shape == (2, 0, RAGGED.lru_width) and not last.any()
    with pytest.raises(ValueError):
        ops.rglru_lru(u, xi, xr[:, 1:], tp["log_lambda"])
    with pytest.raises(ValueError):
        ops.rglru_lru(u, xi.float(), xr, tp["log_lambda"])
    with pytest.raises(ValueError):
        ops.rglru_lru(u.half(), xi.half(), xr.half(), tp["log_lambda"])
    with pytest.raises(ValueError):
        ops.rglru_lru(u, xi, xr, tp["log_lambda"][1:])
    with pytest.raises(ValueError):
        ops.rglru_lru(u.to("meta"), xi.to("meta"), xr.to("meta"),
                      tp["log_lambda"].to("meta"))
