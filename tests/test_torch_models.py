"""The port's LM serving path (repro_torch.configs, models, train.steps,
launch.serve) against the JAX package's, on the CPU, in float32.

The reduced configs of four dense decoders carry the reference's weights
across (``models.params.params_from_jax``) and run ``forward``, ``prefill``
(logits and ring caches) and six ``decode_step``s on the same numpy tokens
as ``repro.models.model.Model``: mistral-nemo-12b (GQA), h2o-danube-3-4b
(SWA, with the ring wrapping: prompt 50 > window 32), granite-20b (MQA,
learned positions, LayerNorm, gelu, tied embeddings) and internlm2-20b.
So do the two mixture-of-experts decoders, whose reduced configs route
losslessly (forward, prefill and decode give the same numbers):
olmoe-1b-7b and moonshot-v1-16b-a3b (a dense head layer, a shared
expert); their forward's aux loss is held to 1e-6. So does the hybrid
recurrentgemma-2b (7 layers: 2 groups of (rglru, rglru, swa) and an rglru
tail, window 32, MQA), whose prefill and decode run past the window (the
ring wraps) and whose RG-LRU layers' decode state (float32 h, the conv's
last inputs) is held beside the attention layers' ring caches; its serving
steps and the serve launcher too. rwkv6-3b's serving steps and launcher
are held here as well (its model and layers in tests/test_torch_rwkv6.py).

Tolerance: 1e-4 max abs on logits (|logits| <= ~5) and caches, layers
1e-5. Measured (CPU, tests/torch_parity_report.py): <= 3.5e-6 on logits.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.layers as JL
import repro_torch.configs as TC
import repro_torch.models.layers as TL
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model as JModel
from repro.train import steps as jsteps
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_jax
from repro_torch.train import steps as tsteps

CPU = "cpu"
TOL = 1e-4
DENSE = ["mistral-nemo-12b", "h2o-danube-3-4b", "granite-20b",
         "internlm2-20b"]
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
HYBRID = ["recurrentgemma-2b"]
RWKV = ["rwkv6-3b"]


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JC.ARCHS))
def test_configs_match_reference(name):
    cj, ct = JC.ARCHS[name], TC.ARCHS[name]
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    assert dt == dj
    assert ct.n_params() == cj.n_params()
    assert ct.n_active_params() == cj.n_active_params()
    rj, rt = JC.reduced(cj), TC.reduced(ct)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert rt.n_params() == rj.n_params()
    assert TC.supported_shapes(ct) == JC.supported_shapes(cj)
    assert (ct.param_dtype == torch.bfloat16) == (cj.param_dtype == jnp.bfloat16)


def test_full_width_mistral_parameter_count():
    cfg = TC.get("mistral-nemo-12b")
    assert cfg.n_params() == 12_247_777_280
    with pytest.raises(KeyError):
        TC.get("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_norms_match_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    got = TL.layernorm(p, torch.from_numpy(x))
    want = JL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    with pytest.raises(ValueError):
        TL.make_norm("batchnorm")


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(40) + 1000])
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               _np(JL.rope_freqs(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_activations_match_reference(activation):
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    names = ["w_in", "w_out"] + (["w_gate"] if TL.is_gated(activation) else [])
    w = {n: (rng.normal(size=(32, 48) if n != "w_out" else (48, 32))
             * 0.2).astype(np.float32) for n in names}
    got = TL.mlp_apply({n: torch.from_numpy(a) for n, a in w.items()},
                       torch.from_numpy(x), activation)
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x), activation)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


# ---------------------------------------------------------------------------
# whole models, the reference's weights carried across
# ---------------------------------------------------------------------------
def _pair(arch, seed=3):
    cfg_j = JC.reduced(JC.ARCHS[arch])
    jm = JModel(cfg_j)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(TC.reduced(TC.ARCHS[arch]),
                         jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _flat(cache):
    """A layer's cache as {"kv.k": ..., "rec.h": ...}."""
    return {f"{part}.{k}": v for part, d in cache.items() for k, v in d.items()}


def _cache_layers(jcache, n_layers):
    """The reference's stack-layout cache as a per-layer list of flat
    dicts (``_flat``)."""
    out = [_flat(lc) for lc in jcache["head"]]
    if jcache["groups"] is not None:
        unit0 = _flat(jcache["groups"][0])
        n_groups = np.asarray(next(iter(unit0.values()))).shape[0]
        for g in range(n_groups):
            for unit in jcache["groups"]:
                out.append({k: np.asarray(v)[g]
                            for k, v in _flat(unit).items()})
    out += [_flat(lc) for lc in jcache["tail"]]
    assert len(out) == n_layers
    return out


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
def test_model_matches_reference(arch):
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    swa = cfg.window is not None
    b, t_prompt, t_gen = 2, (50 if swa else 40), 6
    max_len = cfg.window if swa else 64
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                            (b, t_prompt + t_gen))

    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    lj, aux_j = jm.forward(params, jnp.asarray(toks))
    lt, aux = tm.forward(torch.from_numpy(toks))
    assert lt.shape == (b, t_prompt + t_gen, cfg.vocab_size)
    if cfg.n_experts:           # the MoE layers' summed load-balancing loss
        assert abs(float(aux) - float(aux_j)) <= 1e-6
    else:
        assert float(aux) == 0.0
    assert np.abs(lt.numpy() - _np(lj)).max() < TOL

    lpj, cj = jm.prefill(params, jnp.asarray(toks[:, :t_prompt]),
                         max_len=max_len)
    lpt, ct = tm.prefill(torch.from_numpy(toks[:, :t_prompt]),
                         max_len=max_len)
    assert np.abs(lpt.numpy() - _np(lpj)).max() < TOL
    for i, (jl, tl) in enumerate(zip(_cache_layers(cj, cfg.n_layers), ct)):
        tl = _flat(tl)
        assert sorted(tl) == sorted(jl) == (
            ["rec.conv", "rec.h"] if cfg.mixer_kind(i) == "rglru"
            else ["kv.k", "kv.v"])
        for key in tl:
            assert tl[key].shape == np.asarray(jl[key]).shape
            assert np.abs(tl[key].numpy() - _np(jl[key])).max() < TOL

    for i in range(t_prompt, t_prompt + t_gen):
        gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(gt.numpy() - _np(gj)).max() < TOL
        # and decode continues the forward over the whole sequence
        assert np.abs(gt.numpy()[:, 0] - lt.numpy()[:, i]).max() < TOL


def test_decode_from_empty_cache_matches_forward():
    """Token-by-token decode from ``init_cache`` (the serve launcher's
    path) gives the forward's logits."""
    _, _, tm = _pair("h2o-danube-3-4b", seed=5)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 512, (1, 40)))
    full, _ = tm.forward(toks)
    cache = tm.init_cache(1, 64)
    assert cache[0]["kv"]["k"].shape[2] == 32          # the SWA ring
    for i in range(40):
        lg, cache = tm.decode_step(toks[:, i:i + 1], cache, i)
        assert (lg[:, 0] - full[:, i]).abs().max() < TOL


def test_hybrid_decode_from_empty_cache_matches_forward():
    """The same for recurrentgemma-2b: its RG-LRU layers start from a zero
    state and a zero conv history, its swa layers from empty rings."""
    _, _, tm = _pair("recurrentgemma-2b", seed=5)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 512, (1, 40)))
    full, _ = tm.forward(toks)
    cache = tm.init_cache(1, 64)
    assert [sorted(lc) for lc in cache] == [["rec"], ["rec"], ["kv"]] * 2 + [
        ["rec"]]
    assert all(lc["kv"]["k"].shape[2] == 32 for lc in cache if "kv" in lc)
    for i in range(40):
        lg, cache = tm.decode_step(toks[:, i:i + 1], cache, i)
        assert (lg[:, 0] - full[:, i]).abs().max() < TOL


# ---------------------------------------------------------------------------
# serving factories and the launcher
# ---------------------------------------------------------------------------
def test_serving_steps_match_reference():
    _serving_steps_match_reference("mistral-nemo-12b")


@pytest.mark.parametrize("arch", MOE)
def test_moe_serving_steps_match_reference(arch):
    _serving_steps_match_reference(arch)


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_serving_steps_match_reference(arch):
    _serving_steps_match_reference(arch)


@pytest.mark.parametrize("arch", RWKV)
def test_rwkv6_serving_steps_match_reference(arch):
    """rwkv6-3b's cache holds no ``kv``: the decode step's slot check
    reads 0 slots and lets it through."""
    _serving_steps_match_reference(arch)


def _serving_steps_match_reference(arch):
    jm, params, tm = _pair(arch, seed=7)
    mesh = make_host_mesh(1)
    toks = np.random.RandomState(8).randint(0, 512, (2, 24))
    jstep, _ = jsteps.make_prefill_step(jm, mesh)
    with mesh:
        want = jstep(params, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 512)
    assert np.abs(got.numpy() - _np(want)).max() < TOL

    jdec, _ = jsteps.make_decode_step(jm, mesh, batch=2, max_len=32)
    tdec = tsteps.make_decode_step(tm, batch=2, max_len=32)
    with mesh:
        cj = jm.init_cache(2, 32)
    ct = tm.init_cache(2, 32)
    for i in range(5):
        with mesh:
            lj, cj = jdec(params, jnp.asarray(toks[:, i:i + 1]), cj,
                          jnp.asarray(i, jnp.int32))
        lt, ct = tdec(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(lt.numpy() - _np(lj)).max() < TOL
    with pytest.raises(ValueError):
        tdec(torch.from_numpy(toks[:1, :1]), ct, 5)


def test_serve_launcher_gives_greedy_tokens_of_forward(capsys):
    _serve_launcher_gives_greedy_tokens_of_forward("mistral-nemo-12b", capsys)


@pytest.mark.parametrize("arch", MOE)
def test_moe_serve_launcher_gives_greedy_tokens_of_forward(arch, capsys):
    _serve_launcher_gives_greedy_tokens_of_forward(arch, capsys)


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_serve_launcher_gives_greedy_tokens_of_forward(arch, capsys):
    _serve_launcher_gives_greedy_tokens_of_forward(arch, capsys)


@pytest.mark.parametrize("arch", RWKV)
def test_rwkv6_serve_launcher_gives_greedy_tokens_of_forward(arch, capsys):
    _serve_launcher_gives_greedy_tokens_of_forward(arch, capsys)


def _serve_launcher_gives_greedy_tokens_of_forward(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--requests", "3",
            "--batch-slots", "2", "--prompt-len", "5", "--max-new", "4",
            "--max-len", "32", "--device", CPU]
    outputs = tserve.main(argv)
    assert len(outputs) == 3
    assert "[serve] 3/3 requests" in capsys.readouterr().out
    cfg = TC.reduced(TC.ARCHS[arch])
    model = Model(cfg, device=CPU).init(0)           # the launcher's weights
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=5).tolist()
               for _ in range(3)]
    first_wave = prompts[-2:]           # the lanes start at position 0
    checked = 0
    for prompt, gen in outputs:
        assert len(gen) == 4 and all(0 <= t < cfg.vocab_size for t in gen)
        if prompt not in first_wave:
            continue
        seq = list(prompt)
        for _ in range(4):
            logits, _ = model.forward(torch.tensor([seq]))
            seq.append(int(logits[0, -1].argmax()))
        assert gen == seq[5:], (prompt, gen, seq[5:])
        checked += 1
    assert checked == 2


# ---------------------------------------------------------------------------
# init, scope and package rules
# ---------------------------------------------------------------------------
def test_init_draws_reference_rules_in_place():
    cfg = TC.reduced(TC.ARCHS["granite-20b"])
    m = Model(cfg, device=CPU)
    ptrs = {n: p.data_ptr() for n, p in m.named_parameters()}
    m.init(0)
    assert {n: p.data_ptr() for n, p in m.named_parameters()} == ptrs
    again = Model(cfg, device=CPU).init(0)
    for (n, p), q in zip(m.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    sd = dict(m.named_parameters())
    assert torch.equal(sd["decoder.0.norm_mixer.scale"], torch.ones(64))
    assert not sd["decoder.0.norm_mixer.bias"].any()
    w = sd["decoder.0.mlp.w_in"]
    assert abs(float(w.std()) - (2 / (64 + 128)) ** 0.5) < 0.01
    assert abs(float(sd["embed"].std()) - 64 ** -0.5) < 0.01
    assert all(not p.requires_grad for p in m.parameters())


def test_init_draws_the_rglru_rules():
    """The RG-LRU's leaves: the conv weights N(0, 0.01), the conv bias 0,
    Λ the reference's spread (``models.rglru.log_lambda_init``), the
    projections N(0, 2/(d_in+d_out))."""
    from repro_torch.models.rglru import log_lambda_init
    cfg = TC.reduced(TC.ARCHS["recurrentgemma-2b"])
    sd = dict(Model(cfg, device=CPU).init(0).named_parameters())
    assert abs(float(sd["decoder.0.rglru.conv_w"].std()) - 0.1) < 0.02
    assert not sd["decoder.0.rglru.conv_b"].any()
    assert torch.equal(sd["decoder.1.rglru.log_lambda"], log_lambda_init(64))
    w = sd["decoder.0.rglru.w_rec_gate"]
    assert abs(float(w.std()) - (2 / 128) ** 0.5) < 0.02
    assert "decoder.2.attn.wq" in sd and "decoder.2.rglru.w_x" not in sd


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(TC.reduced(TC.ARCHS[arch]), device=CPU)


def test_unported_options_raise():
    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["mistral-nemo-12b"]),
                              kv_quant="int8")
    m = Model(cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.init_cache(1, 8)
    x = torch.zeros(1, 4, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.attn_apply(m.decoder[0]["attn"], cfg, x, positions=None,
                         kv_override=(x, x))
    with pytest.raises(NotImplementedError):
        tserve.main(["--arch", "mistral-nemo-12b", "--reduced",
                     "--model-parallel", "2", "--device", CPU])


def test_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(TC.reduced(TC.ARCHS["mistral-nemo-12b"]))
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", "mistral-nemo-12b", "--reduced"])
    assert os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
