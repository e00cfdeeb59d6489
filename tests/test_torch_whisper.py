"""The port's encoder-decoder (whisper-small, reduced) against the JAX
package's, on the CPU, in float32.

The reduced config (2 encoder and 2 decoder layers, d 64, 4/2 heads of 16,
24 frames) carries the reference's weights across
(``models.params.params_from_jax``) and runs, on the same numpy tokens and
frames as ``repro.models.model.Model``: ``encode``, ``forward(frames=)``,
``loss`` with ``batch["frames"]`` and its gradients, ``fill_cross_cache``
and ``decode_step`` (the cross caches and every step's logits), the
prefill serving step with frames, and the layer pieces (``cross_kv``,
``attn_apply(kv_override=)``, ``attn_decode_step(kv_override=)``). Also:
decode against the forward (the reference's < 5e-3 of
tests/test_models.py), the reference's parameter count, and
``fill_cross_cache`` from frames shorter than ``encoder_len``, which
replaces the cross caches with shorter ones, as the reference's does.

Tolerance: 1e-4 max abs on logits and the loss's gradients (|logits| <=
~5), 1e-5 on the encoder's output, the cross caches and one layer's
attention, as tests/test_torch_models.py. Measured (CPU): <= 3e-6 on
logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.attention as JA
import repro_torch.configs as TC
import repro_torch.models.attention as TA
from repro.models.model import Model as JModel
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax
from repro_torch.train import steps as tsteps

ARCH = "whisper-small"
CPU = "cpu"
TOL = 1e-4
TOL_LAYER = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small tensor ops: torch's intra-op threads
    would only contend for them with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def pair():
    cfg_j = JC.reduced(JC.ARCHS[ARCH])
    jm = JModel(cfg_j)
    params = jm.init(jax.random.PRNGKey(3))
    tm = params_from_jax(TC.reduced(TC.ARCHS[ARCH]),
                         jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _inputs(cfg, b, t, seed, te=None):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, t))
    frames = rng.normal(size=(b, te or cfg.encoder_len, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


def test_params_carried_across(pair):
    jm, params, tm = pair
    names = dict(tm.named_parameters())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    # the encoder stack, its norm and positions; each decoder layer's cross
    np.testing.assert_array_equal(names["enc_pos_embed"].numpy(),
                                  _np(params["enc_pos_embed"]))
    np.testing.assert_array_equal(names["enc_norm.scale"].numpy(),
                                  _np(params["enc_norm"]["scale"]))
    for g in range(tm.cfg.encoder_layers):
        np.testing.assert_array_equal(
            names[f"encoder.{g}.attn.wq"].numpy(),
            _np(params["encoder"]["groups"][0]["attn"]["wq"][g]))
    for g in range(tm.cfg.n_layers):
        for leaf in ("wk", "wo"):
            np.testing.assert_array_equal(
                names[f"decoder.{g}.cross.{leaf}"].numpy(),
                _np(params["decoder"]["groups"][0]["cross"][leaf][g]))
        np.testing.assert_array_equal(
            names[f"decoder.{g}.norm_cross.bias"].numpy(),
            _np(params["decoder"]["groups"][0]["norm_cross"]["bias"][g]))


def test_param_count_analytic_vs_actual():
    """tests/test_models.py's check, on the port: the model's parameters
    within 15% of the config's analytic count, reduced and full width."""
    for cfg in (TC.reduced(TC.ARCHS[ARCH]), TC.ARCHS[ARCH]):
        model = Model(cfg, device="meta")
        actual = sum(p.numel() for p in model.parameters())
        assert abs(actual - cfg.n_params()) / actual < 0.15, \
            (actual, cfg.n_params())
    jm = JModel(JC.reduced(JC.ARCHS[ARCH]))
    want = sum(x.size for x in jax.tree.leaves(jm.init(jax.random.PRNGKey(0))))
    model = Model(TC.reduced(TC.ARCHS[ARCH]), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want


def test_init_draws_every_parameter():
    tm = Model(TC.reduced(TC.ARCHS[ARCH]), device=CPU).init(0)
    sd = dict(tm.named_parameters())
    assert abs(float(sd["enc_pos_embed"].std()) - 64 ** -0.5) < 0.02
    assert torch.equal(sd["decoder.0.norm_cross.scale"], torch.ones(64))
    assert not sd["enc_norm.bias"].any()
    assert all(torch.isfinite(p).all() for p in sd.values())


def test_cross_attention_pieces_match_reference(pair):
    jm, params, tm = pair
    cfg, cfg_j = tm.cfg, jm.cfg
    rng = np.random.RandomState(8)
    enc = rng.normal(size=(2, 24, 64)).astype(np.float32)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], params["decoder"]["groups"][0]["cross"])
    tp = tm.decoder[1]["cross"]
    kj, vj = JA.cross_kv(jp, cfg_j, jnp.asarray(enc))
    kt, vt = TA.cross_kv(tp, cfg, torch.from_numpy(enc))
    assert kt.shape == (2, 2, 24, 16)
    np.testing.assert_allclose(kt.detach().numpy(), _np(kj), atol=TOL_LAYER)
    np.testing.assert_allclose(vt.detach().numpy(), _np(vj), atol=TOL_LAYER)
    oj = JA.attn_apply(jp, cfg_j, jnp.asarray(x), positions=None,
                       causal=False, kv_override=(kj, vj))
    ot = TA.attn_apply(tp, cfg, torch.from_numpy(x), positions=None,
                       causal=False, kv_override=(kt, vt))
    np.testing.assert_allclose(ot.detach().numpy(), _np(oj), atol=TOL_LAYER)
    oj, _ = JA.attn_decode_step(jp, cfg_j, jnp.asarray(x[:, :1]), None,
                                jnp.asarray(3), kv_override=(kj, vj))
    ot, c = TA.attn_decode_step(tp, cfg, torch.from_numpy(x[:, :1]), None, 3,
                                kv_override=(kt, vt))
    assert c is None
    np.testing.assert_allclose(ot.detach().numpy(), _np(oj), atol=TOL_LAYER)


def test_encode_matches_reference(pair):
    jm, params, tm = pair
    _, frames = _inputs(tm.cfg, 2, 1, seed=9)
    ej = jm.encode(params, jnp.asarray(frames))
    et = tm.encode(torch.from_numpy(frames))
    assert et.shape == (2, 24, 64)
    np.testing.assert_allclose(et.detach().numpy(), _np(ej), atol=TOL_LAYER)


def test_forward_with_frames_matches_reference(pair):
    jm, params, tm = pair
    toks, frames = _inputs(tm.cfg, 2, 12, seed=10)
    lj, aux_j = jm.forward(params, jnp.asarray(toks),
                           frames=jnp.asarray(frames))
    lt, aux = tm.forward(torch.from_numpy(toks),
                         frames=torch.from_numpy(frames))
    assert lt.shape == (2, 12, tm.cfg.vocab_size)
    assert float(aux) == float(aux_j) == 0.0
    assert np.abs(lt.detach().numpy() - _np(lj)).max() < TOL
    last, _ = tm.forward(torch.from_numpy(toks),
                         frames=torch.from_numpy(frames), last_only=True)
    assert (last[:, 0] - lt[:, -1]).abs().max() < TOL_LAYER
    with pytest.raises(ValueError, match="frames"):
        tm.forward(torch.from_numpy(toks))
    with pytest.raises(ValueError, match="fill_cross_cache"):
        tm.prefill(torch.from_numpy(toks), max_len=32)


def test_loss_with_frames_matches_reference(pair):
    jm, params, tm = pair
    toks, frames = _inputs(tm.cfg, 2, 13, seed=11)
    bj = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jm.loss(p, bj), has_aux=True)(params)
    tm.requires_grad_(True)
    try:
        lt, mt = tm.loss({"tokens": torch.from_numpy(toks),
                          "frames": torch.from_numpy(frames)}, remat=True)
        lt.backward()
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    finally:
        tm.zero_grad(set_to_none=True)
        tm.requires_grad_(False)
    assert abs(float(lt.detach()) - float(lj)) < TOL
    assert abs(float(mt["ce"].detach()) - float(mj["ce"])) < TOL
    np.testing.assert_allclose(
        grads["enc_pos_embed"].numpy(), _np(gj["enc_pos_embed"]), atol=TOL)
    np.testing.assert_allclose(
        grads["encoder.0.attn.wq"].numpy(),
        _np(gj["encoder"]["groups"][0]["attn"]["wq"][0]), atol=TOL)
    np.testing.assert_allclose(
        grads["decoder.1.cross.wv"].numpy(),
        _np(gj["decoder"]["groups"][0]["cross"]["wv"][1]), atol=TOL)
    np.testing.assert_allclose(grads["embed"].numpy(), _np(gj["embed"]),
                               atol=TOL)


def test_prefill_step_with_frames_matches_reference(pair):
    jm, params, tm = pair
    toks, frames = _inputs(tm.cfg, 2, 9, seed=12)
    lj, _ = jm.forward(params, jnp.asarray(toks), frames=jnp.asarray(frames))
    got = tsteps.make_prefill_step(tm)({"tokens": torch.from_numpy(toks),
                                        "frames": torch.from_numpy(frames)})
    assert np.abs(got.numpy() - _np(lj)[:, -1]).max() < TOL


@pytest.mark.parametrize("te", [24, 10])
def test_fill_cross_cache_and_decode_match_reference(pair, te):
    """From ``init_cache``, ``fill_cross_cache`` (te = encoder_len, and
    shorter frames: the cross caches are replaced by te-key ones, as the
    reference's) and 8 decode steps."""
    jm, params, tm = pair
    cfg = tm.cfg
    b, t = 2, 8
    toks, frames = _inputs(cfg, b, t, seed=13, te=te)
    cj = jm.init_cache(b, max_len=32, dtype=jnp.float32)
    ct = tm.init_cache(b, 32)
    assert [sorted(lc) for lc in ct] == [["cross_k", "cross_v", "kv"]] * 2
    assert ct[0]["cross_k"].shape == (b, 2, cfg.encoder_len, 16)
    assert not ct[0]["cross_k"].any()
    cj = jm.fill_cross_cache(params, cj, jnp.asarray(frames))
    ct = tm.fill_cross_cache(ct, torch.from_numpy(frames))
    for i, lc in enumerate(ct):
        assert lc["cross_k"].shape == (b, 2, te, 16)
        for key in ("cross_k", "cross_v"):
            want = _np(cj["groups"][0][key][i])
            np.testing.assert_allclose(lc[key].numpy(), want, atol=TOL_LAYER)
    for i in range(t):
        gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(gt.numpy() - _np(gj)).max() < TOL, i


def test_decode_matches_forward(pair):
    """tests/test_models.py's decode == forward, on the port: the forward
    with frames against fill_cross_cache and token-by-token decode."""
    _, _, tm = pair
    b, t = 2, 12
    toks, frames = _inputs(tm.cfg, b, t, seed=14)
    full, _ = tm.forward(torch.from_numpy(toks),
                         frames=torch.from_numpy(frames))
    cache = tm.fill_cross_cache(tm.init_cache(b, 32),
                                torch.from_numpy(frames))
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), cache,
                                   i)
        outs.append(lg[:, 0])
    err = float((full - torch.stack(outs, dim=1)).abs().max())
    assert err < 5e-3, err
