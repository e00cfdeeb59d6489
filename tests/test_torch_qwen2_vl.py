"""The port's qwen2-vl-7b (M-RoPE and the stubbed vision embeddings)
against the JAX package's, on the CPU.

``layers.apply_mrope`` is held to the reference's at the full config's
head_dim 128 with sections (16, 24, 24) and at the reduced config's head
dim 16 with (4, 2, 2), in float32 and bf16, on distinct (t, h, w) streams;
with equal streams it gives ``apply_rope``'s result bit for bit, as the
reference says text tokens do. The reduced qwen2-vl-7b (2 layers, d 64,
4/2 heads of 16) carries the reference's weights across
(``models.params.params_from_jax``) and runs, on the same numpy inputs as
``repro.models.model.Model``: ``forward`` with the default (text) ids, with
an image's ids and with ``embeds`` (the stubbed front end's output);
``loss`` with ``positions`` and ``embeds``; ``prefill`` at an image's ids
and six decode steps. The reference's own claim (tests/test_models.py:
distinct streams move the logits) is held on the port. The serving steps
(the prefill step at an image's ids) and the serve launcher are in
tests/test_torch_models.py (``VLM``).

Tolerance: 1e-4 max abs on logits and the loss (|logits| <= ~5), as
tests/test_torch_models.py; M-RoPE in float32 1e-5 (as
``test_rope_matches_reference``); in bf16 one bf16 step of the largest
output (2^-7 x max |want|): the two packages' float32 angles and sines
differ in the last bits, which can move a bf16 rounding by one step.
Measured (CPU): <= 3e-6 on logits, <= 8.4e-7 on float32 M-RoPE, and bf16
M-RoPE bit for bit on these inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.layers as JL
import repro_torch.configs as TC
import repro_torch.models.layers as TL
from repro.models.model import Model as JModel
from repro_torch.models.params import params_from_jax
from test_torch_vlm_ids import image_ids

ARCH = "qwen2-vl-7b"
CPU = "cpu"
TOL = 1e-4
ROPE_TOL = 1e-5
# (head_dim, sections): the full config's and the reduced config's
ROPE_CASES = [(128, (16, 24, 24)), (16, (4, 2, 2))]


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small tensor ops: torch's intra-op threads would only contend
    with the other test workers' processes."""
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


def _streams(b, t, seed):
    """Distinct (t, h, w) streams, as positions up to a long prompt's."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 9000, (b, 3, t))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,sections", ROPE_CASES)
def test_mrope_matches_reference(head_dim, sections, dtype):
    rng = np.random.RandomState(head_dim)
    x = rng.normal(size=(2, 3, 40, head_dim)).astype(np.float32)
    pos = _streams(2, 40, 1)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = TL.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    want = _np(JL.apply_mrope(xj, jnp.asarray(pos), 1e6, sections))
    assert got.dtype == xt.dtype
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err < ROPE_TOL
    else:
        assert err <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,sections", ROPE_CASES)
def test_mrope_with_equal_streams_is_rope(head_dim, sections, dtype):
    rng = np.random.RandomState(head_dim + 1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 40, head_dim))
                         .astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.randint(0, 9000, (2, 40)))
    got = TL.apply_mrope(x, ids[:, None].expand(2, 3, 40), 1e6, sections)
    assert torch.equal(got, TL.apply_rope(x, ids, 1e6))


def test_mrope_refuses_sections_off_half_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(torch.zeros(1, 1, 2, 16), torch.zeros(
            1, 3, 2, dtype=torch.int64), 1e6, (4, 2, 1))


# ---------------------------------------------------------------------------
# the reduced model, the reference's weights carried across
# ---------------------------------------------------------------------------
def _inputs(cfg, b, t, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, t))
    embeds = (rng.normal(size=(b, t, cfg.d_model)) * 0.125).astype(
        np.float32)
    return toks, embeds


@pytest.mark.parametrize("ids", ["text", "image", "image+embeds"])
def test_forward_matches_reference(pair, ids):
    jm, params, tm = pair
    b, t = 2, 40
    toks, embeds = _inputs(tm.cfg, b, t, 4)
    kw_j, kw_t = {}, {}
    if ids != "text":
        pos = image_ids(b, t, 8, 4)
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    if ids == "image+embeds":
        kw_j["embeds"] = jnp.asarray(embeds)
        kw_t["embeds"] = torch.from_numpy(embeds)
    lj, _ = jm.forward(params, jnp.asarray(toks), **kw_j)
    lt, aux = tm.forward(torch.from_numpy(toks), **kw_t)
    assert lt.shape == (b, t, tm.cfg.vocab_size) and float(aux) == 0.0
    assert np.abs(lt.numpy() - _np(lj)).max() < TOL


def test_loss_with_positions_and_embeds_matches_reference(pair):
    jm, params, tm = pair
    b, t = 2, 24
    toks, embeds = _inputs(tm.cfg, b, t + 1, 5)
    pos = image_ids(b, t, 4, 4)
    batch = {"tokens": toks, "positions": pos, "embeds": embeds[:, :t]}
    lj, mj = jm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(lt) - float(lj)) < TOL
    assert abs(float(mt["ce"]) - float(mj["ce"])) < TOL
    # embeds stand in for the token embeddings: the loss moves with them
    text, _ = tm.loss({"tokens": torch.from_numpy(toks),
                       "positions": torch.from_numpy(pos)})
    assert abs(float(text) - float(lt)) > 1e-3


def test_prefill_and_decode_match_reference(pair):
    """prefill at an image's ids, then six decode steps (text ids (i, i,
    i)): logits and ring caches against the reference's, and decode
    against the forward over the whole sequence at the same ids."""
    jm, params, tm = pair
    b, t_prompt, t_gen, max_len = 2, 40, 6, 64
    toks, _ = _inputs(tm.cfg, b, t_prompt + t_gen, 6)
    pos = image_ids(b, t_prompt + t_gen, 8, 4)
    lt_full, _ = tm.forward(torch.from_numpy(toks),
                            positions=torch.from_numpy(pos))
    lpj, cj = jm.prefill(params, jnp.asarray(toks[:, :t_prompt]),
                         max_len=max_len,
                         positions=jnp.asarray(pos[:, :, :t_prompt]))
    lpt, ct = tm.prefill(torch.from_numpy(toks[:, :t_prompt]),
                         max_len=max_len,
                         positions=torch.from_numpy(pos[:, :, :t_prompt]))
    assert np.abs(lpt.numpy() - _np(lpj)).max() < TOL
    jl = [cj["head"], cj["tail"]]
    assert not jl[0] and not jl[1]            # one group: (attn,) x 2
    for g, lc in enumerate(ct):
        for name in ("k", "v"):
            want = _np(cj["groups"][0]["kv"][name])[g]
            assert np.abs(lc["kv"][name].numpy() - want).max() < TOL
    for i in range(t_prompt, t_prompt + t_gen):
        gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(gt.numpy() - _np(gj)).max() < TOL
        assert np.abs(gt.numpy()[:, 0] - lt_full.numpy()[:, i]).max() < TOL


def test_mrope_streams_move_the_logits(pair):
    """tests/test_models.py's claim on the port: vision-style ids with
    distinct streams give other logits than text ids."""
    _, _, tm = pair
    b, t = 1, 8
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tm.cfg.vocab_size, (b, t)))
    text = torch.arange(t)[None, None].expand(b, 3, t)
    vis = torch.stack([torch.zeros(b, t, dtype=torch.int64),
                       torch.arange(t).expand(b, t),
                       torch.arange(t).flip(0).expand(b, t)], dim=1)
    l1, _ = tm.forward(toks, positions=text)
    l2, _ = tm.forward(toks, positions=vis)
    assert float((l1 - l2).abs().max()) > 1e-6
    # and the default ids are the text ids
    l0, _ = tm.forward(toks)
    assert torch.equal(l0, l1)
