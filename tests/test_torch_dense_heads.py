"""granite-20b, internlm2-20b and h2o-danube-3-4b with their real head
layouts, the port against the JAX package on the CPU.

- Full width without allocating: the port's model on the meta device and
  the JAX package's ``init`` under ``jax.eval_shape`` have the same leaves
  (``models.params.reference_leaves`` maps each port parameter onto the
  reference's, a stacked group leaf one parameter a group), the same
  shapes, and the same total, which is each config's ``n_params()``.
  granite's learned table has 32768 rows of 6144.
- The real head layouts at narrow width (``test_torch_dense_layouts
  .narrow``): MQA 48/1 and 48/8 at head_dim 128, 32/8 at head_dim 120
  under a window; LayerNorm, tanh-gelu, learned positions and tied
  embeddings in granite. The reference's parameters are carried across
  (``params_from_jax``); ``forward``, ``prefill`` (logits and caches) and
  6 ``decode_step``s are held within ``TOL``, as
  tests/test_torch_models.py holds the reduced configs. danube's prompt of
  100 tokens wraps its 64-slot ring. This runs K3's plain version at GQA
  groups of 48, 6 and 4 and at d = 120 under a window against the
  reference's ``attention_ref``.
- The end of granite's learned table: 8 prompt tokens prefilled into a
  cache of 32768 slots, then decode at positions 32760..32767 in both
  packages from the reference's cache carried across, which reads the
  table's last 8 rows.

Tolerance: 1e-4 max abs on logits and caches, as tests/test_torch_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models.model import Model as JModel
from repro_torch.models.model import Model
from repro_torch.models.params import (leaf_map, params_from_jax,
                                       reference_leaves)
from test_torch_dense_layouts import DENSE_HEADS, narrow, prompt_len
from test_torch_models import _cache_layers, _flat, _np

CPU = "cpu"
TOL = 1e-4
N_PARAMS = {"granite-20b": 20_215_087_104, "internlm2-20b": 19_861_143_552,
            "h2o-danube-3-4b": 3_961_835_520}
TABLE_END = 32768
N_DECODE = 8


# ---------------------------------------------------------------------------
# full width, shapes only
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE_HEADS)
def test_full_width_leaves_match_reference(arch):
    cfg_t, cfg_j = TC.ARCHS[arch], JC.ARCHS[arch]
    meta = Model(cfg_t, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    abstract = jax.eval_shape(JModel(cfg_j).init, jax.random.PRNGKey(0))
    jleaves = [tuple(x.shape) for x in jax.tree.leaves(abstract)]
    leaves = reference_leaves(cfg_t)
    assert len(leaves) == len(jleaves)
    assert sorted(n for names in leaves for n in names) == sorted(shapes)
    offsets = leaf_map(cfg_t)
    for i, (names, jshape) in enumerate(zip(leaves, jleaves)):
        one = shapes[names[0]]
        assert all(shapes[n] == one for n in names)
        # a stacked leaf carries the groups on a leading axis
        assert jshape in (one, (len(names),) + one), (names[0], jshape, one)
        assert int(np.prod(jshape)) == len(names) * int(np.prod(one))
        size = int(np.prod(one))
        assert [offsets[n] for n in names] == [(i, g * size)
                                               for g in range(len(names))]
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert total == sum(int(np.prod(s)) for s in jleaves)
    assert cfg_t.n_params() == cfg_j.n_params() == N_PARAMS[arch]
    # n_params() counts each layer's two norm scales only: both models
    # also hold the final norm, and a LayerNorm's bias beside each scale
    d, layernorm = cfg_t.d_model, cfg_t.norm == "layernorm"
    left_out = d * (1 + (1 + 2 * cfg_t.n_layers if layernorm else 0))
    assert total == cfg_t.n_params() + left_out
    if cfg_t.pos_embed == "learned":
        assert shapes["pos_embed"] == (32768, cfg_t.d_model) == tuple(
            abstract["pos_embed"].shape)
    assert (meta.unembed is None) == cfg_t.tie_embeddings


# ---------------------------------------------------------------------------
# the real head layouts at narrow width, the reference's weights carried
# ---------------------------------------------------------------------------
def _narrow_pair(arch, seed=3):
    cfg_j = narrow(JC.ARCHS[arch])
    jm = JModel(cfg_j)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(narrow(TC.ARCHS[arch]),
                         jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _carried(jcache, n_layers):
    """The reference's decode cache as the port's per-layer caches."""
    return [{"kv": {k.split(".")[1]: torch.from_numpy(np.array(v))
                    for k, v in layer.items()}}
            for layer in _cache_layers(jcache, n_layers)]


@pytest.mark.parametrize("arch", DENSE_HEADS)
def test_narrow_head_layout_matches_reference(arch):
    jm, params, tm = _narrow_pair(arch)
    cfg = tm.cfg
    b, t_prompt, t_gen = 2, prompt_len(cfg), 6
    max_len = cfg.window or 64
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                            (b, t_prompt + t_gen))

    lj, _ = jm.forward(params, jnp.asarray(toks))
    lt, aux = tm.forward(torch.from_numpy(toks))
    assert float(aux) == 0.0
    assert lt.shape == (b, t_prompt + t_gen, cfg.vocab_size)
    assert np.abs(lt.numpy() - _np(lj)).max() < TOL

    lpj, cj = jm.prefill(params, jnp.asarray(toks[:, :t_prompt]),
                         max_len=max_len)
    lpt, ct = tm.prefill(torch.from_numpy(toks[:, :t_prompt]),
                         max_len=max_len)
    assert np.abs(lpt.numpy() - _np(lpj)).max() < TOL
    for jl, tl in zip(_cache_layers(cj, cfg.n_layers), ct):
        tl = _flat(tl)
        assert sorted(tl) == sorted(jl) == ["kv.k", "kv.v"]
        for key in tl:
            assert tl[key].shape == (b, cfg.n_kv_heads, max_len, cfg.head_dim)
            assert tl[key].shape == np.asarray(jl[key]).shape
            assert np.abs(tl[key].numpy() - _np(jl[key])).max() < TOL

    for i in range(t_prompt, t_prompt + t_gen):
        gj, cj = jm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(i))
        gt, ct = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), ct, i)
        assert np.abs(gt.numpy() - _np(gj)).max() < TOL
        assert np.abs(gt.numpy()[:, 0] - lt.numpy()[:, i]).max() < TOL


def test_learned_table_end_matches_reference():
    jm, params, tm = _narrow_pair("granite-20b", seed=5)
    cfg = tm.cfg
    assert cfg.max_position == TABLE_END
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                            (2, 8 + N_DECODE))
    lpj, cj = jm.prefill(params, jnp.asarray(toks[:, :8]), max_len=TABLE_END)
    lpt, ct = tm.prefill(torch.from_numpy(toks[:, :8]), max_len=TABLE_END)
    assert np.abs(lpt.numpy() - _np(lpj)).max() < TOL
    carried = _carried(cj, cfg.n_layers)
    for own, theirs in zip(ct, carried):
        for key in ("k", "v"):
            assert own["kv"][key].shape == (2, 1, TABLE_END, cfg.head_dim)
            assert float((own["kv"][key] - theirs["kv"][key]).abs().max()) < TOL
    for j, pos in enumerate(range(TABLE_END - N_DECODE, TABLE_END)):
        tok = toks[:, 8 + j:9 + j]
        gj, cj = jm.decode_step(params, jnp.asarray(tok), cj, jnp.asarray(pos))
        gt, carried = tm.decode_step(torch.from_numpy(tok), carried, pos)
        assert np.abs(gt.numpy() - _np(gj)).max() < TOL
