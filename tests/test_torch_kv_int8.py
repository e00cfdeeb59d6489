"""The port's int8 KV cache against the JAX package's, on the CPU.

``attention._quantize_slot`` is held bit for bit to the reference's on the
same inputs (float32 and bf16): the payload round(x / (absmax / 127)),
half to even, clamped to ±127, and the float32 scale, an all-zero slot
(scale 0, payload 0), exact .5 ties and each slot's extremes (±127)
included. ``cache_init`` with ``quant="int8"``: int8 k and v, float32
``k_scale`` and ``v_scale`` of (b, hkv, L, 1), and their bytes at
qwen2-vl-7b's full width. Decode from an empty int8 cache against the
reference's int8 decode on reduced mistral-nemo-12b and qwen2-vl-7b in
float32 (b 2, 16 tokens, as tests/test_prefill.py's int8 test), the
reference test's own claims on the port (against the forward: relative
max abs < 0.15, argmax equal at > 0.9 of positions), and a ring that wraps
under a window (reduced h2o-danube-3-4b, 48 tokens through 32 slots).

Tolerance: 1e-4 max abs on logits, as tests/test_torch_models.py
(measured <= 2.1e-6); the payloads within one step of the reference's and
the scales within 1e-6 relative, since a slot's inputs come from products
that round differently in torch and XLA (measured: equal on these inputs).
"""
import dataclasses

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
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_jax

CPU = "cpu"
TOL = 1e-4
REL = 0.15                 # tests/test_prefill.py::test_int8_kv_cache_decode
AGREE = 0.9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _slots(seed):
    """(3, 4, 1, 128) float32 slots: N(0, 25), an all-zero slot, a slot of
    exact .5 ties (its absmax 127, so its scale is 1), a slot whose absmax
    is negative and tiny ones."""
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(3, 4, 1, 128)) * 5).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1, 0] = 0.25
    x[0, 1, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -125.5]
    x[0, 2, 0, 3] = -50.0
    x[1, 0] *= 1e-30
    return x


# ---------------------------------------------------------------------------
# the slot's quantization and the cache's layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_slot_matches_reference_bit_for_bit(dtype):
    x = _slots(0)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    qt, st = TA._quantize_slot(xt)
    qj, sj = JA._quantize_slot(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert qt.shape == (3, 4, 1, 128) and st.shape == (3, 4, 1, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the edges: scale 0 and payload 0; ties half to even; the extremes
    assert st[0, 0].item() == 0.0 and not qt[0, 0].any()
    assert qt[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
    assert qt[0, 2, 0, 3].item() == -127
    assert int(qt.abs().max()) == 127


def test_cache_init_layout_and_bytes():
    spec = TA.CacheSpec(2, 32, 4, 16, torch.float32, quant="int8",
                        device=CPU)
    c = TA.cache_init(spec)
    j = JA.cache_init(JA.CacheSpec(2, 32, 4, 16, jnp.float32, quant="int8"))
    assert sorted(c) == sorted(j) == ["k", "k_scale", "v", "v_scale"]
    for name, t in c.items():
        assert t.shape == j[name].shape and not t.any()
        assert str(t.dtype).split(".")[-1] == str(j[name].dtype)
    with pytest.raises(ValueError, match="quantization"):
        TA.cache_init(dataclasses.replace(spec, quant="int4"))
    # qwen2-vl-7b's caches at full width, 8200 slots (no memory taken)
    cfg = TC.ARCHS["qwen2-vl-7b"]
    qcfg = dataclasses.replace(cfg, kv_quant="int8")

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for lc in cache
                   for t in lc["kv"].values())
    q8 = tfm.stack_cache_init(qcfg, 1, 8200, cfg.param_dtype, device="meta")
    bf = tfm.stack_cache_init(cfg, 1, 8200, cfg.param_dtype, device="meta")
    assert nbytes(q8) == 28 * 2 * 4 * 8200 * (128 + 4) == 242_457_600
    assert nbytes(bf) == 28 * 2 * 4 * 8200 * 128 * 2 == 470_220_800


# ---------------------------------------------------------------------------
# decode from an empty int8 cache
# ---------------------------------------------------------------------------
def _pair(arch, seed=4):
    cfg_j = dataclasses.replace(JC.reduced(JC.ARCHS[arch]), kv_quant="int8")
    jm = JModel(cfg_j)
    params = JModel(JC.reduced(JC.ARCHS[arch])).init(jax.random.PRNGKey(seed))
    cfg_t = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), kv_quant="int8")
    tm = params_from_jax(cfg_t, jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _layers(jcache, n_layers):
    """The reference's cache as a per-layer list of its ``kv`` dicts."""
    out = [lc["kv"] for lc in jcache["head"]]
    if jcache["groups"] is not None:
        n_groups = np.asarray(jcache["groups"][0]["kv"]["k"]).shape[0]
        for g in range(n_groups):
            for unit in jcache["groups"]:
                out.append({k: np.asarray(v)[g]
                            for k, v in unit["kv"].items()})
    out += [lc["kv"] for lc in jcache["tail"]]
    assert len(out) == n_layers
    return out


def _decode(jm, params, tm, toks, max_len):
    """Both packages decode ``toks`` from empty int8 caches; returns the
    port's logits (b, t, V) and the largest logit difference."""
    b, t = toks.shape
    cj = jm.init_cache(b, max_len, dtype=jnp.float32)
    ct = tm.init_cache(b, max_len)
    outs, err = [], 0.0
    for i in range(t):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        err = max(err, float(np.abs(lt.numpy() - _np(lj)).max()))
        outs.append(lt[:, 0])
    for lj, lt in zip(_layers(cj, tm.cfg.n_layers), ct):
        for name in ("k", "v"):
            assert lt["kv"][name].dtype == torch.int8
            d = lt["kv"][name].int().numpy() - np.asarray(lj[name], np.int32)
            assert np.abs(d).max() <= 1
            np.testing.assert_allclose(lt["kv"][f"{name}_scale"].numpy(),
                                       np.asarray(lj[f"{name}_scale"]),
                                       rtol=1e-6)
    return torch.stack(outs, dim=1), err


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2-vl-7b"])
def test_int8_decode_matches_reference(arch):
    jm, params, tm = _pair(arch)
    toks = np.random.RandomState(0).randint(0, tm.cfg.vocab_size, (2, 16))
    cache = tm.init_cache(2, 32)
    assert all(lc["kv"]["k"].dtype == torch.int8 for lc in cache)
    _, err = _decode(jm, params, tm, toks, 32)
    assert err < TOL


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2-vl-7b"])
def test_int8_decode_claims_of_the_reference_test(arch):
    """tests/test_prefill.py::test_int8_kv_cache_decode's claims, on the
    port: int8 decode against the full-precision forward."""
    _, _, tm = _pair(arch)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tm.cfg.vocab_size, (2, 16)))
    full, _ = tm.forward(toks)
    cache = tm.init_cache(2, 32)
    outs = []
    for i in range(16):
        lg, cache = tm.decode_step(toks[:, i:i + 1], cache, i)
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    rel = float((got - full).abs().max() / (full.abs().max() + 1e-9))
    agree = float((got.argmax(-1) == full.argmax(-1)).double().mean())
    assert rel < REL, rel
    assert agree > AGREE, agree


def test_int8_ring_wraps_under_a_window():
    """48 tokens through a 32-slot ring (reduced h2o-danube-3-4b, window
    32): against the reference's int8 decode, and the forward's argmax."""
    jm, params, tm = _pair("h2o-danube-3-4b", seed=2)
    assert tm.cfg.window == 32
    toks = np.random.RandomState(1).randint(0, tm.cfg.vocab_size, (1, 48))
    assert tm.init_cache(1, 64)[0]["kv"]["k"].shape[2] == 32
    got, err = _decode(jm, params, tm, toks, 64)
    assert err < TOL
    full, _ = tm.forward(torch.from_numpy(toks))
    rel = float((got - full).abs().max() / full.abs().max())
    agree = float((got.argmax(-1) == full.argmax(-1)).double().mean())
    assert rel < REL and agree > AGREE, (rel, agree)
