"""The port's mixture-of-experts layer (repro_torch.models.moe) against the
JAX package's (repro.models.moe), on the CPU, in float32, on the same numpy
inputs and weights.

The routing integers (each slot's expert, its position in the expert's
buffer, whether it is kept) are held bit for bit: the reference's are read
from its own calls (``jax.lax.top_k`` and the ``one_hot`` of the
positions), the port's from ``moe.route`` and ``moe.positions``. The
outputs are held to 1e-5 of their max |want| and aux to 1e-6 absolute
(float32; the two packages' products differ in the last bits only).

A route is an order of float32 probabilities, so a last-bit difference
between torch's and XLA's router products could swap two experts whose
probabilities tie to within that difference, and ``torch.topk`` and
``jax.lax.top_k`` may break an exact tie differently. Each case therefore
asserts that its inputs' top-k+1 probabilities are more than 1e-5 apart in
every token (computed in float64), so that no such swap can happen and a
differing route is a fault of the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.moe as jmoe
import repro_torch.configs as TC
from repro.models.model import Model as JModel
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import draw_
from repro_torch.models.model import Model
from repro_torch.models.params import reference_leaves

OUT_TOL = 1e-5          # of the output's max |want|
AUX_TOL = 1e-6
MARGIN = 1e-5
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]

# (name, config changes, capacity_factor, tokens (b, t)); the base is the
# reduced olmoe: d 64, 8 experts, top 2, d_ff 32, swiglu
CASES = [
    ("lossless", {}, None, (2, 16)),
    ("drops", {}, 1.25, (2, 12)),
    ("chunked", {"moe_dispatch_chunk": 8}, 1.25, (2, 16)),
    ("chunked_roomy", {"moe_dispatch_chunk": 8}, 4.0, (4, 8)),
    ("no_renorm", {"renorm_gates": False}, 1.25, (2, 16)),
    ("gelu", {"activation": "gelu"}, 1.25, (2, 16)),
    ("relu2", {"activation": "relu2"}, None, (2, 16)),
    ("geglu", {"activation": "geglu"}, 1.25, (2, 16)),
    ("shared2", {"n_shared_experts": 2}, 1.25, (2, 16)),
    ("top4_shared2", {"n_shared_experts": 2, "top_k": 4}, 2.0, (1, 40)),
]


def _cfgs(changes):
    cj = dataclasses.replace(JC.reduced(JC.ARCHS["olmoe-1b-7b"]), **changes)
    ct = dataclasses.replace(TC.reduced(TC.ARCHS["olmoe-1b-7b"]), **changes)
    return cj, ct


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _layer(changes, seed=0):
    """The reference's MoE parameters, the port's copy, and an input."""
    cj, ct = _cfgs(changes)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cj, jnp.float32)
    return cj, ct, jp, _torch_tree(jax.tree.map(np.asarray, jp))


def _assert_margins(x, router, k):
    """Every token's top k+1 probabilities more than MARGIN apart."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router.astype(
        np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    gaps = -np.diff(p[:, :k + 1], axis=-1)
    assert gaps.min() > MARGIN, gaps.min()


class _Recorder:
    """Records the reference's own routing: each ``top_k`` call's indices
    and each ``one_hot`` call's (input, classes), in call order."""

    def __init__(self, monkeypatch):
        self.top_k, self.one_hot = [], []
        top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

        def rec_top_k(x, k):
            out = top_k(x, k)
            self.top_k.append(np.asarray(out[1]))
            return out

        def rec_one_hot(x, n, **kw):
            self.one_hot.append((np.asarray(x), n))
            return one_hot(x, n, **kw)
        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)

    def routes(self):
        """Per dispatched block: (expert index, positions, keep). The third
        one_hot of a block is the positions' over the capacity."""
        calls = [self.one_hot[i:i + 4] for i in range(0, len(self.one_hot), 4)]
        out = []
        for idx, block in zip(self.top_k, calls):
            pos, cap = block[2]
            out.append((idx, pos, pos < cap))
        return out


@pytest.mark.parametrize("name,changes,cf,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_matches_reference(monkeypatch, name, changes, cf, shape):
    cj, ct, jp, tp = _layer(changes)
    x = np.random.RandomState(1).normal(size=shape + (ct.d_model,)).astype(
        np.float32)
    _assert_margins(x, np.asarray(jp["router"]), ct.top_k)

    rec = _Recorder(monkeypatch)
    with jax.disable_jit():         # the chunks' scan runs op by op
        want, want_aux = jmoe.moe_apply(jp, cj, jnp.asarray(x),
                                        capacity_factor=cf)
    monkeypatch.undo()
    got, got_aux = tmoe.moe_apply(tp, ct, torch.from_numpy(x),
                                  capacity_factor=cf)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= OUT_TOL * np.abs(want).max(), err
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL

    # the routing integers, block by block (one block, or one per chunk)
    n_tok = shape[0] * shape[1]
    blocks = rec.routes()
    chunk = ct.moe_dispatch_chunk
    size = chunk if (cf is not None and chunk and n_tok > chunk) else n_tok
    assert len(blocks) == n_tok // size
    tokens = torch.from_numpy(x).reshape(-1, size, ct.d_model)
    dropped = 0
    for block, (idx_j, pos_j, keep_j) in zip(tokens, blocks):
        _, _, idx = tmoe.route(tp, ct, block)
        pos, counts = tmoe.positions(idx, ct.n_experts)
        keep = pos < tmoe.capacity(ct, size, cf)
        assert np.array_equal(idx.numpy(), idx_j)
        assert np.array_equal(pos.numpy(), pos_j)
        assert np.array_equal(keep.numpy(), keep_j)
        assert np.array_equal(counts.numpy(),
                              np.bincount(idx_j.ravel(), minlength=8))
        dropped += int((~keep).sum())
    if name in ("drops", "chunked"):
        assert dropped > 0          # the case exercises a dropped slot
    if cf is None or name == "chunked_roomy":
        assert dropped == 0


def test_capacity_matches_reference_rule():
    _, ct = _cfgs({})
    for n_tok, cf, want in [(32, 1.25, 16), (32, None, 32), (3, 1.0, 1),
                            (2048, 1.25, 640), (100, 1.25, 32)]:
        assert tmoe.capacity(ct, n_tok, cf) == want
    full = TC.ARCHS["olmoe-1b-7b"]
    assert tmoe.capacity(full, 2048, 1.25) == 320


def test_chunked_equals_full_when_no_drops():
    """As tests/test_substrate.py holds the reference: with room for every
    slot, chunked dispatch gives the unchunked output; aux differs, being
    the mean of per-chunk losses."""
    _, ct, _, tp = _layer({"moe_capacity_factor": 8.0})
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(2, 16, ct.d_model)).astype(np.float32))
    full, _ = tmoe.moe_apply(tp, dataclasses.replace(
        ct, moe_dispatch_chunk=None), x)
    chunked, _ = tmoe.moe_apply(tp, dataclasses.replace(
        ct, moe_dispatch_chunk=8), x)
    assert float((full - chunked).abs().max()) < 1e-5


def test_moe_gradient_matches_reference():
    """The router's and the experts' gradients through drops and aux."""
    cj, ct, jp, tp = _layer({}, seed=4)
    x = np.random.RandomState(5).normal(size=(2, 16, ct.d_model)).astype(
        np.float32)
    _assert_margins(x, np.asarray(jp["router"]), ct.top_k)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, cj, x, capacity_factor=1.25)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape)))\
            + aux
    want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    for v in tp.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tp, ct, xt, capacity_factor=1.25)
    w = torch.cos(torch.arange(out.numel(), dtype=torch.float32)).view_as(out)
    ((out * w).sum() + aux).backward()
    for name, g in [*((n, tp[n].grad) for n in sorted(tp)), ("x", xt.grad)]:
        ref = np.asarray(want[1] if name == "x" else want[0][name])
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-5, (name, err)


def test_draw_gives_expert_weights_the_reference_scale():
    """Expert weights (E, d_in, d_out) are N(0, 2/(d_in + d_out)), as the
    reference's _expert_init, not 2/(E + d_in); the router is a float32
    (d, E) dense weight in a bf16 model."""
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(4, 256, 64)
    draw_("decoder.0.moe.w_in", w, gen, "rmsnorm")
    assert abs(float(w.std()) - (2 / (256 + 64)) ** 0.5) < 2e-3
    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["moonshot-v1-16b-a3b"]),
                              dtype="bfloat16")
    m = Model(cfg, device="cpu").init(0)
    sd = dict(m.named_parameters())
    assert sd["decoder.1.moe.router"].dtype == torch.float32
    assert sd["decoder.1.moe.w_in"].dtype == torch.bfloat16
    assert sd["decoder.1.moe.shared_0.w_in"].dtype == torch.bfloat16
    assert "decoder.0.mlp.w_in" in sd and "decoder.0.moe.router" not in sd
    jm = JModel(JC.reduced(JC.ARCHS["moonshot-v1-16b-a3b"]))
    jshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jshape))


def _path_names(path) -> tuple:
    """A reference leaf's dict keys below the decoder's layer lists."""
    keys = [k.key for k in path if isinstance(k, jax.tree_util.DictKey)]
    return tuple(keys[1:]) if keys[0] == "decoder" and len(keys) > 2 \
        else tuple(keys)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_map_names_shapes_dtypes_match_reference(arch, dtype):
    """``reference_leaves`` lists ``jax.tree.flatten``'s leaves of the
    reference's init tree in order (router, shared_*, w_gate, w_in, w_out
    in an MoE subtree): the same names below the layer index, each stacked
    leaf the groups' shapes stacked, the same dtypes (a float32 router in a
    bf16 model)."""
    cj = dataclasses.replace(JC.reduced(JC.ARCHS[arch]), dtype=dtype)
    ct = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype=dtype)
    tree = jax.eval_shape(JModel(cj).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref = reference_leaves(ct)
    assert len(ref) == len(leaves)
    params = dict(Model(ct, device="meta").named_parameters())
    seen_moe = []
    for (path, leaf), names in zip(leaves, ref):
        want = _path_names(path)
        if want[:1] in (("groups",), ("head",), ("tail",)):
            want = want[1:]
        for n in names:
            parts = n.split(".")
            got = tuple(parts[2:]) if parts[0] == "decoder" else tuple(parts)
            assert got == want, (n, path)
            assert str(params[n].dtype).split(".")[-1] == str(leaf.dtype)
        shape = tuple(params[names[0]].shape)
        stacked = len(names) > 1 or leaf.ndim == len(shape) + 1
        assert tuple(leaf.shape) == ((len(names),) + shape if stacked
                                     else shape)
        if "moe" in want:
            seen_moe.append(want[-1] if len(want) == 2 else want[-2])
    # jax.tree.flatten's sorted keys inside the MoE subtree
    order = [k for i, k in enumerate(seen_moe) if k not in seen_moe[:i]]
    assert order == sorted(order) and order[0] == "router"
