"""The port's RWKV6 (repro_torch.models.rwkv6) and W's plain version
(kernels/rwkv6_wkv) against the JAX package's, on the CPU.

The same numpy inputs and weights go through ``repro.models.rwkv6`` and its
port at the reduced config (float32, d 64, 4 heads of 16): the ddlerp
token shift, the decay, the group norm (float32 and bf16: ``jnp.var`` is
the population variance, torch's default the unbiased one), the WKV
recurrence (``wkv_ref`` on the reference's own r, k, v and logw against
the reference's ``lax.scan`` over T in {1, 7, 64}, its last S against
``rwkv6_prefill``'s), the decode step, the channel mix, one decoder layer
(forward, prefill cache, decode), and rwkv6-3b's reduced model with the
reference's weights carried across (``models.params.params_from_jax``):
forward, prefill caches, prefill + decode, the serve launcher. The decode
state's size does not grow with max_len. On the CPU ``rwkv6_wkv`` is the
plain version and launches nothing.

Tolerances, max abs (measured on these inputs, CPU, float32:
tests/torch_parity_report.py --only rwkv6): the token shift, decay and
group norm 1e-5 (measured <= 7.2e-7 on outputs up to 4.8); the
recurrence's y 1e-4 (WKV_Y_TOL; measured 5.7e-6 on |y| <= 51 at T = 64)
and its last S 5e-5 (WKV_S_TOL; 1.9e-6 on |S| <= 24): the two packages'
dk sums and S + u·kv round apart, and the state carries it over T; the
time mix, decode step, channel mix and layer 1e-5 (<= 8.3e-7 on outputs
up to 3.9); the model's logits and caches 1e-4 (MODEL_TOL, that of
tests/test_torch_models.py; measured 1.1e-5 on |logits| <= 4.2, the
caches' S 8.0e-6 on |S| <= 25).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.rwkv6 as JR
import repro.models.transformer as JT
import repro_torch.configs as TC
import repro_torch.models.rwkv6 as TR
from repro.models.model import Model as JModel
from repro_torch.kernels.rwkv6_wkv import ops, ref
from repro_torch.kernels.rwkv6_wkv.ref import wkv_decode, wkv_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax, reference_leaves

ARCH = "rwkv6-3b"
TOL = 1e-5
WKV_Y_TOL = 1e-4
WKV_S_TOL = 5e-5
MODEL_TOL = 1e-4
CFG = TC.reduced(TC.ARCHS[ARCH])
JCFG = JC.reduced(JC.ARCHS[ARCH])
SEQ_LENS = [1, 7, 64]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _inputs(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape)
            * scale).astype(np.float32)


def _torch(tree):
    return {k: (_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for k, v in tree.items()}


def _jax(tree):
    return {k: (_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def make_weights():
    """The reference's time-mix and channel-mix init, as numpy, with the
    bonus, the group norm's scale and bias and the interpolation weights
    spread so that each term shows: the same numbers for both packages."""
    rng = np.random.RandomState(11)
    tm = {k: np.asarray(v) for k, v in
          JR.rwkv6_init(jax.random.PRNGKey(1), JCFG, jnp.float32).items()}
    tm["bonus_u"] = rng.normal(size=tm["bonus_u"].shape).astype(np.float32)
    tm["gn_scale"] = (1 + 0.3 * rng.normal(size=64)).astype(np.float32)
    tm["gn_bias"] = (0.3 * rng.normal(size=64)).astype(np.float32)
    tm["mu_x"] = rng.rand(64).astype(np.float32)
    cm = {k: np.asarray(v) for k, v in
          JR.channel_mix_init(jax.random.PRNGKey(2), JCFG,
                              jnp.float32).items()}
    cm["mu_k"] = rng.rand(64).astype(np.float32)
    cm["mu_r"] = rng.rand(64).astype(np.float32)
    return {"j": _jax(tm), "t": _torch(tm), "jc": _jax(cm), "tc": _torch(cm)}


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _pair_x(seed, t, b=2):
    x = _inputs(seed, b, t, 64)
    return x, np.concatenate([np.zeros((b, 1, 64), np.float32), x[:, :-1]], 1)


def test_ddlerp_matches_reference(weights):
    x, xp = _pair_x(0, 33)
    got = TR._ddlerp(weights["t"], torch.from_numpy(x), torch.from_numpy(xp))
    want = JR._ddlerp(weights["j"], jnp.asarray(x), jnp.asarray(xp))
    assert len(got) == len(TR._STREAMS) == 5
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - _np(w)).max() < TOL


def test_decay_matches_reference(weights):
    xw = _inputs(1, 2, 33, 64)
    got = TR._decay(weights["t"], torch.from_numpy(xw))
    want = JR._decay(weights["j"], jnp.asarray(xw))
    assert got.dtype == torch.float32 and float(got.max()) < 0
    assert np.abs(got.numpy() - _np(want)).max() < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(weights, dtype):
    """The population variance and rsqrt(var + 1e-5), per head; in bf16
    the inputs and parameters are rounded alike in both packages."""
    y = _inputs(2, 2, 9, 64, scale=3.0) + 1.0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: weights["j"][k].astype(jd) for k in ("gn_scale", "gn_bias")}
    tp = {k: weights["t"][k].to(td) for k in ("gn_scale", "gn_bias")}
    got = TR._group_norm(tp, torch.from_numpy(y).to(td), CFG.rwkv_heads)
    want = JR._group_norm(jp, jnp.asarray(y).astype(jd), CFG.rwkv_heads)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - _np(want)).max() < TOL


def _reference_scan(weights, monkeypatch, x):
    """The reference's r, k, v, logw on x and its scan's y (captured at
    ``_group_norm``'s input) and last S (``rwkv6_prefill``)."""
    seen = []
    group_norm = JR._group_norm

    def capture(params, y, n_heads, eps=1e-5):
        seen.append(np.asarray(y))
        return group_norm(params, y, n_heads, eps)
    monkeypatch.setattr(JR, "_group_norm", capture)
    xj = jnp.asarray(x)
    xp = jnp.pad(xj, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    rkvgw = JR._project(weights["j"], JCFG, xj, xp)
    JR.rwkv6_apply(weights["j"], JCFG, xj)
    _, state = JR.rwkv6_prefill(weights["j"], JCFG, xj)
    return rkvgw, seen[0], np.asarray(state["S"])


@pytest.mark.parametrize("t", SEQ_LENS)
def test_wkv_plain_version_matches_reference_scan(weights, monkeypatch, t):
    x = _inputs(3 + t, 2, t, 64)
    (r, k, v, _, logw), y_want, s_want = _reference_scan(weights,
                                                         monkeypatch, x)
    u = weights["t"]["bonus_u"]
    y, S = wkv_ref(*(torch.from_numpy(np.array(a)) for a in (r, k, v, logw)),
                   u)
    assert y.dtype == S.dtype == torch.float32
    assert tuple(S.shape) == (2, 4, 16, 16)
    assert np.abs(y.reshape(2, t, 64).numpy() - y_want).max() < WKV_Y_TOL
    assert np.abs(S.numpy() - s_want).max() < WKV_S_TOL
    # the op on CPU tensors is the plain version and launches nothing
    before = ops.rwkv6_wkv.launches
    y2, S2 = ops.rwkv6_wkv(*(torch.from_numpy(np.array(a))
                             for a in (r, k, v, logw)), u)
    assert torch.equal(y2, y) and torch.equal(S2, S)
    assert ops.rwkv6_wkv.launches == before


def test_wkv_plain_version_continues_from_a_state():
    """Two halves, the second from the first's last S, give the whole
    sequence's y and S; T = 0 gives the zero state."""
    rng = np.random.RandomState(5)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 2, 16)).astype(
        np.float32)) for _ in range(3))
    logw = -torch.from_numpy(rng.rand(1, 20, 2, 16).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    y, S = wkv_ref(r, k, v, logw, u)
    y1, S1 = wkv_ref(r[:, :12], k[:, :12], v[:, :12], logw[:, :12], u)
    y2, S2 = wkv_ref(r[:, 12:], k[:, 12:], v[:, 12:], logw[:, 12:], u, S1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(S2, S)
    y0, S0 = ops.rwkv6_wkv(r[:, :0], k[:, :0], v[:, :0], logw[:, :0], u)
    assert y0.shape == (1, 0, 2, 16) and not S0.any()


def test_wkv_plain_version_in_chunks_is_the_decode_step_bit_for_bit(
        monkeypatch):
    """k ⊗ v taken a chunk at a time (chunks of 8 over 21 steps, the last
    one short) gives the bits of one chunk over all steps and of the
    decode step stepped alone: the chunks change the memory, not the
    numbers."""
    rng = np.random.RandomState(6)
    r, k, v = (torch.from_numpy(rng.normal(size=(2, 21, 3, 16)).astype(
        np.float32)) for _ in range(3))
    logw = -torch.from_numpy(rng.rand(2, 21, 3, 16).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    y, S = wkv_ref(r, k, v, logw, u)
    monkeypatch.setattr(ref, "CHUNK", 8)
    y8, S8 = wkv_ref(r, k, v, logw, u)
    assert torch.equal(y8, y) and torch.equal(S8, S)
    S1 = torch.zeros(2, 3, 16, 16)
    for i in range(21):
        y1, S1 = wkv_decode(S1, r[:, i], k[:, i], v[:, i], logw[:, i], u)
        assert torch.equal(y1, y[:, i])
    assert torch.equal(S1, S)


def test_wkv_op_refuses_what_neither_version_takes():
    r = torch.zeros(1, 4, 2, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="one"):
        ops.rwkv6_wkv(r, r, r[:, 1:], r, u)
    with pytest.raises(ValueError, match="u of shape"):
        ops.rwkv6_wkv(r, r, r, r, u[:1])
    with pytest.raises(ValueError, match="float32"):
        ops.rwkv6_wkv(r, r, r, r.bfloat16(), u)
    with pytest.raises(ValueError, match="one type"):
        ops.rwkv6_wkv(r.half(), r.half(), r.half(), r, u)


def test_decode_steps_match_reference_and_the_prefill(weights):
    x = _inputs(4, 2, 24, 64)
    y_full = TR.rwkv6_apply(weights["t"], CFG, torch.from_numpy(x))
    y_want = JR.rwkv6_apply(weights["j"], JCFG, jnp.asarray(x))
    assert np.abs(y_full.numpy() - _np(y_want)).max() < TOL
    pt, st = TR.rwkv6_prefill(weights["t"], CFG, torch.from_numpy(x[:, :16]))
    pj, sj = JR.rwkv6_prefill(weights["j"], JCFG, jnp.asarray(x[:, :16]))
    assert np.abs(pt.numpy() - _np(pj)).max() < TOL
    assert st["S"].dtype == torch.float32
    for key in ("S", "shift"):
        assert np.abs(st[key].numpy() - _np(sj[key])).max() < TOL
    for i in range(16, 21):
        dt, st = TR.rwkv6_decode_step(weights["t"], CFG,
                                      torch.from_numpy(x[:, i:i + 1]), st)
        dj, sj = JR.rwkv6_decode_step(weights["j"], JCFG,
                                      jnp.asarray(x[:, i:i + 1]), sj)
        assert np.abs(dt.numpy() - _np(dj)).max() < TOL
        assert np.abs(dt.numpy()[:, 0] - y_full.numpy()[:, i]).max() < TOL
        assert np.abs(st["S"].numpy() - _np(sj["S"])).max() < TOL


def test_state_init_matches_reference():
    sj = JR.rwkv6_state_init(3, JCFG, jnp.bfloat16)
    st = TR.rwkv6_state_init(3, CFG, torch.bfloat16)
    assert st["S"].dtype == torch.float32
    assert st["shift"].dtype == torch.bfloat16
    for key in ("S", "shift"):
        assert tuple(st[key].shape) == sj[key].shape
        assert not st[key].any()


def test_channel_mix_matches_reference(weights):
    x, xp = _pair_x(5, 21)
    got = TR.channel_mix_full(weights["tc"], torch.from_numpy(x))
    want = JR.channel_mix_full(weights["jc"], jnp.asarray(x))
    assert np.abs(got.numpy() - _np(want)).max() < TOL
    shift = xp[:, 7]
    dt, st = TR.channel_mix_decode(weights["tc"], torch.from_numpy(x[:, 7:8]),
                                   torch.from_numpy(shift))
    dj, sj = JR.channel_mix_decode(weights["jc"], jnp.asarray(x[:, 7:8]),
                                   jnp.asarray(shift))
    assert np.abs(dt.numpy() - _np(dj)).max() < TOL
    assert np.abs(dt.numpy()[:, 0] - got.numpy()[:, 7]).max() < TOL
    np.testing.assert_array_equal(st.numpy(), _np(sj))


def test_one_layer_matches_reference():
    """A decoder layer (layernorm, time mix, layernorm, channel mix):
    forward, prefill with its cache, then decode steps."""
    jp = JT.layer_init(jax.random.PRNGKey(6), JCFG, 0, jnp.float32)
    tp = tfm.layer_init(CFG, 0, torch.float32, "cpu")
    assert sorted(tp.keys()) == sorted(jp) == ["cmix", "norm_mixer",
                                               "norm_mlp", "rwkv"]
    with torch.no_grad():
        for part, leaves in jp.items():
            for name, a in leaves.items():
                tp[part][name].copy_(torch.from_numpy(np.array(a)))
    x = _inputs(7, 2, 20, 64)
    kw = dict(positions=None)
    got, aux = tfm.layer_apply(tp, CFG, "rwkv6", "channel_mix",
                               torch.from_numpy(x), **kw)
    want, _ = JT.layer_apply(jp, JCFG, "rwkv6", "channel_mix",
                             jnp.asarray(x), **kw)
    assert float(aux) == 0.0
    assert np.abs(got.numpy() - _np(want)).max() < TOL
    pt, ct = tfm.layer_prefill(tp, CFG, "rwkv6", "channel_mix",
                               torch.from_numpy(x[:, :14]), max_len=32, **kw)
    pj, cj = JT.layer_prefill(jp, JCFG, "rwkv6", "channel_mix",
                              jnp.asarray(x[:, :14]), max_len=32, **kw)
    assert np.abs(pt.numpy() - _np(pj)).max() < TOL
    assert sorted(ct) == ["cmix_shift", "rec"]
    assert sorted(ct["rec"]) == ["S", "shift"]
    for got_c, want_c in ((ct["cmix_shift"], cj["cmix_shift"]),
                          (ct["rec"]["S"], cj["rec"]["S"]),
                          (ct["rec"]["shift"], cj["rec"]["shift"])):
        assert np.abs(got_c.numpy() - _np(want_c)).max() < TOL
    for i in range(14, 18):
        dt, ct = tfm.layer_decode(tp, CFG, "rwkv6", "channel_mix",
                                  torch.from_numpy(x[:, i:i + 1]), ct, i)
        dj, cj = JT.layer_decode(jp, JCFG, "rwkv6", "channel_mix",
                                 jnp.asarray(x[:, i:i + 1]), cj, i)
        assert np.abs(dt.numpy() - _np(dj)).max() < TOL
        assert np.abs(dt.numpy()[:, 0] - got.numpy()[:, i]).max() < TOL


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JCFG)
    params = jm.init(jax.random.PRNGKey(3))
    tm = params_from_jax(CFG, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _layer_caches(jcache):
    """The reference's cache (2 groups of a one-layer unit) per layer."""
    (unit,) = jcache["groups"]
    assert not jcache["head"] and not jcache["tail"]
    return [{"cmix_shift": np.asarray(unit["cmix_shift"])[g],
             "S": np.asarray(unit["rec"]["S"])[g],
             "shift": np.asarray(unit["rec"]["shift"])[g]}
            for g in range(CFG.n_layers)]


def test_model_matches_reference(pair):
    """rwkv6-3b reduced (2 layers, one group each): the same parameter
    count in the reference's leaf order, forward logits, the prefill's
    logits and caches, and decode steps that continue the forward."""
    jm, params, tm = pair
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    assert [names[0].rsplit(".", 2)[-2:] for names in reference_leaves(CFG)
            if names[0].startswith("decoder.0.")][:3] == [
        ["cmix", "mu_k"], ["cmix", "mu_r"], ["cmix", "w_k"]]
    b, t_prompt, t_gen = 2, 30, 6
    toks = np.random.RandomState(4).randint(0, CFG.vocab_size,
                                            (b, t_prompt + t_gen))
    lj, _ = jm.forward(params, jnp.asarray(toks))
    lt, aux = tm.forward(torch.from_numpy(toks))
    assert float(aux) == 0.0
    assert np.abs(lt.numpy() - _np(lj)).max() < MODEL_TOL

    lpj, cj = jm.prefill(params, jnp.asarray(toks[:, :t_prompt]), max_len=64)
    lpt, ct = tm.prefill(torch.from_numpy(toks[:, :t_prompt]), max_len=64)
    assert np.abs(lpt.numpy() - _np(lpj)).max() < MODEL_TOL
    for want, got in zip(_layer_caches(cj), ct):
        got = {"cmix_shift": got["cmix_shift"], **got["rec"]}
        assert sorted(got) == sorted(want)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape
            assert np.abs(got[key].numpy() - want[key]).max() < MODEL_TOL
    for i in range(t_prompt, t_prompt + t_gen):
        gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(gt.numpy() - _np(gj)).max() < MODEL_TOL
        assert np.abs(gt.numpy()[:, 0] - lt.numpy()[:, i]).max() < MODEL_TOL


def test_decode_from_empty_cache_matches_forward(pair):
    """Token-by-token decode from ``init_cache`` (the serve launcher's
    path): zero states, zero shifts."""
    _, _, tm = pair
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 512, (1, 24)))
    full, _ = tm.forward(toks)
    cache = tm.init_cache(1, 64)
    assert [sorted(lc) for lc in cache] == [["cmix_shift", "rec"]] * 2
    for i in range(24):
        lg, cache = tm.decode_step(toks[:, i:i + 1], cache, i)
        assert (lg[:, 0] - full[:, i]).abs().max() < MODEL_TOL


def test_long_context_state_is_constant_memory():
    """The port's counterpart of the reference's: attention-free, the
    decode state does not depend on max_len."""
    model = Model(CFG, device="cpu")

    def size(cache):
        return sum(x.numel() for lc in cache for x in
                   (lc["cmix_shift"], *lc["rec"].values()))
    c1 = model.init_cache(1, max_len=64, dtype=torch.float32)
    c2 = model.init_cache(1, max_len=4096, dtype=torch.float32)
    assert size(c1) == size(c2) == 2 * (4 * 16 * 16 + 64 + 64)


def test_init_draws_the_rwkv6_rules():
    """The reference's init rules on the port's leaves: the interpolation
    weights 0.5, ``mu`` around 0.5, the decay base a linspace, the group
    norm 1 and 0, the bonus and the shift LoRA's second factor N(0,
    0.02²), the projections N(0, 2/(d_in+d_out))."""
    sd = dict(Model(CFG, device="cpu").init(0).named_parameters())
    p = "decoder.0."
    for name in ("rwkv.mu_x", "cmix.mu_k", "cmix.mu_r"):
        assert torch.equal(sd[p + name], torch.full((64,), 0.5))
    assert abs(float(sd[p + "rwkv.mu"].mean()) - 0.5) < 0.01
    assert abs(float(sd[p + "rwkv.mu"].std()) - 0.02) < 0.005
    # torch's and jnp's float32 linspace round apart in the last bit
    np.testing.assert_allclose(
        sd[p + "rwkv.decay_base"].numpy(),
        _np(jnp.linspace(-6.0, -0.5, 64, dtype=jnp.float32)), rtol=0,
        atol=1e-6)
    assert torch.equal(sd[p + "rwkv.gn_scale"], torch.ones(64))
    assert not sd[p + "rwkv.gn_bias"].any()
    for name in ("rwkv.bonus_u", "rwkv.shift_w2"):
        assert abs(float(sd[p + name].std()) - 0.02) < 0.005
    w = sd[p + "cmix.w_k"]
    assert abs(float(w.std()) - (2 / (64 + 128)) ** 0.5) < 0.02


def test_serve_launcher_prints_the_reference_summary(capsys):
    """``launch.serve`` on the reduced rwkv6-3b on the CPU: every request
    answered, the reference's summary line, tokens in the vocabulary. A
    lane's recurrent state is not reset when a request takes it, as in
    the reference."""
    outputs = tserve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                           "--batch-slots", "2", "--prompt-len", "5",
                           "--max-new", "4", "--max-len", "32",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(outputs) == 3
    assert all(len(g) == 4 and all(0 <= t < CFG.vocab_size for t in g)
               for _, g in outputs)
    line = next(s for s in out.splitlines() if s.startswith("[serve] 3/3"))
    assert "requests," in line and "steps," in line
    assert "tok/s (batch=2)" in line

