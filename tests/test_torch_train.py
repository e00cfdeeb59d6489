"""The port's LM training path (repro_torch.data, optim, train.abo_zo,
train.steps, launch.train, models.params' leaf map) against the JAX
package's, on the CPU, on the same numpy inputs.

The reduced configs carry the reference's weights across
(``models.params.params_from_jax``) and its AdamW state
(``opt_state_from_jax``). The two mixture-of-experts configs (olmoe,
moonshot) take the dense decoders' cases: their trees mix a float32 router
with experts in the model's dtype, and their loss adds ``0.01·aux``. The
hybrid recurrentgemma-2b's tree, whose stacked groups mix RG-LRU and
attention layers by position in the unit, takes the leaf map and the
perturbation cases. Bit for bit where the arithmetic is integer or
one rounding an operation: the data stream, the key arithmetic, ABO-ZO's
perturbation over a whole tree (stacked groups included), the AdamW update
against the reference's op-by-op (unjitted) update with clipping off, and
the port's own remat and resume. Tolerances elsewhere, pinned from
measurement (CPU, float32, reduced configs; ``python
tests/torch_parity_report.py --only training``):

  * the loss and ABO-ZO's candidate losses, port vs JAX: 2e-5 absolute
    (losses ~6.2; measured <= 1.43e-6 and <= 9.5e-7);
  * gradients, per tensor: 1e-4 of the tensor's max |want| (measured
    <= 2.83e-6);
  * AdamW steps through ``make_train_step`` against the reference's jitted
    step (lr 3e-4, 1-3 steps): at most 1e-3 of the parameters more than
    1e-6 apart (measured <= 5.0e-5), and none more than 2·lr (measured
    1.16e-5): where a gradient element is near 0, m̂/√v̂ is near ±1 and
    its last bits move the update by up to lr. The jitted update also
    contracts some multiply-adds into FMAs;
  * gnorm: 1e-5 relative (measured <= 9.1e-7 over whole steps: the
    summation order differs);
    the AdamW update with clipping on, whose scale carries gnorm's
    difference: elements within 1e-6 absolute.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.data.synthetic import BigramStream as JStream
from repro.data.synthetic import StreamConfig as JStreamConfig
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.train import abo_zo as jabo
from repro.train import steps as jsteps
from repro_torch.data.synthetic import BigramStream, StreamConfig
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.perturb.ops import abo_zo_perturb, signs_plain
from repro_torch.launch import train as ttrain
from repro_torch.models.params import (leaf_map, named_from_jax,
                                       opt_state_from_jax, params_from_jax,
                                       reference_leaves)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import abo_zo as tabo
from repro_torch.train import steps as tsteps

CPU = "cpu"
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-6
STEP_SHARE = 1e-3
DENSE = ["mistral-nemo-12b", "h2o-danube-3-4b", "granite-20b",
         "internlm2-20b"]
MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
HYBRID = ["recurrentgemma-2b"]
VLM = ["qwen2-vl-7b"]
RWKV = ["rwkv6-3b"]
AUDIO = ["whisper-small"]
RECURRENT = HYBRID + RWKV


def _cfgs(arch, dtype=None):
    cj, ct = JC.reduced(JC.ARCHS[arch]), TC.reduced(TC.ARCHS[arch])
    if dtype is not None:
        cj = dataclasses.replace(cj, dtype=dtype)
        ct = dataclasses.replace(ct, dtype=dtype)
    return cj, ct


def _pair(arch, dtype=None, seed=3):
    cj, ct = _cfgs(arch, dtype)
    jm = JModel(cj)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(ct, jax.tree.map(np.asarray, params), device=CPU)
    return jm, params, tm


def _bits(a) -> np.ndarray:
    """An array's bit patterns (bf16 as uint16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(np.uint16)
    return t.detach().numpy().view(np.uint32)


def _batch(cfg, b=2, t=24, seed=5):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, t + 1))
    return toks


def _frames(cfg, b=2, seed=6):
    """An encoder-decoder's stubbed frame embeddings (b, encoder_len, d),
    or None."""
    if not cfg.encoder_layers:
        return None
    return np.random.RandomState(seed).normal(
        size=(b, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks, frames):
    """The same batch for both packages: (JAX's, the port's)."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        jb["frames"], tb["frames"] = (jnp.asarray(frames),
                                      torch.from_numpy(frames))
    return jb, tb


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_bigram_stream_bits(seed):
    jc = JStreamConfig(vocab_size=512, seq_len=33, global_batch=4, seed=seed)
    tc = StreamConfig(vocab_size=512, seq_len=33, global_batch=4, seed=seed)
    js, ts = JStream(jc), BigramStream(tc)
    assert np.array_equal(js.next_tokens, ts.next_tokens)
    for cursor in (0, 1, 7, 123, 10**6 + 3):
        want = js.batch(cursor)
        assert np.array_equal(ts.batch(cursor), want)
        got = ts.torch_batch(cursor, CPU)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the leaf map and the reference's key arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + VLM)
def test_leaf_map_covers_the_reference_tree(arch):
    jm, params, tm = _pair(arch)
    leaves = jax.tree.leaves(params)
    ref = reference_leaves(tm.cfg)
    assert len(ref) == len(leaves)
    names = dict(tm.named_parameters())
    lm = leaf_map(tm.cfg)
    assert set(lm) == set(names)
    for i, (group, leaf) in enumerate(zip(ref, leaves)):
        sizes = [names[n].numel() for n in group]
        assert sum(sizes) == np.asarray(leaf).size
        off = 0
        for n, size in zip(group, sizes):
            assert lm[n] == (i, off)
            off += size
    # named_from_jax is the inverse of the stacking
    named = named_from_jax(tm.cfg, jax.tree.map(np.asarray, params))
    for n, p in names.items():
        assert np.array_equal(named[n], p.detach().numpy())


def test_key_arithmetic_matches_jax():
    for seed in (0, 1, 12345):
        assert tabo.prng_key(seed) == tuple(
            int(x) for x in np.asarray(jax.random.PRNGKey(seed)))
    key = jax.random.PRNGKey(1)
    for step in (0, 1, 17, 2**31 + 5):
        want = np.asarray(jax.random.fold_in(key, step))
        assert tabo.fold_in(tabo.prng_key(1), step) == tuple(int(x) for x in want)
    k = jax.random.fold_in(key, 3)
    splits = np.asarray(jax.random.split(k, 11))
    for i in range(11):
        assert tabo.split_key(tuple(int(x) for x in np.asarray(k)), i) == \
            tuple(int(x) for x in splits[i])
    assert np.array_equal(tabo.base_scales(9), np.asarray(jnp.linspace(-1.0, 1.0, 9)))


@pytest.mark.parametrize("offset", [0, 5, 1000])
def test_rademacher_signs_match_jax(offset):
    key = jax.random.PRNGKey(42)
    # JAX draws the whole leaf; compare the window [offset, offset + 64)
    want = np.asarray(jax.random.rademacher(key, (offset + 64,),
                                            jnp.int8))[offset:]
    got = signs_plain(tuple(int(x) for x in np.asarray(key)), offset, 64, CPU)
    assert np.array_equal(got.numpy(), want.astype(np.float32))


def test_rademacher_signs_high_counter_word():
    """A counter past 2^32 puts its high word into threefry's first input,
    as jax.random's iota_2x32_shape does for a leaf that large: checked
    against jax's threefry on the same (hi, lo) counter words."""
    from jax._src import prng as jprng
    key = (7, 99)
    c = np.arange(2**32 - 4, 2**32 + 4, dtype=np.uint64)
    hi, lo = (c >> 32).astype(np.uint32), (c & 0xFFFFFFFF).astype(np.uint32)
    x0, x1 = jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                 jnp.concatenate([hi, lo]).reshape(2, -1))
    bits = np.asarray(x0) ^ np.asarray(x1)
    want = np.where(bits >> 31, -1.0, 1.0).astype(np.float32)
    got = signs_plain(key, 2**32 - 4, 8, CPU)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ABO-ZO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perturb_bits_over_the_tree(arch, dtype):
    jm, params, tm = _pair(arch, dtype)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 5)
    scale = np.float32(0.75) * np.float32(0.0123)
    want = named_from_jax(tm.cfg, jax.tree.map(
        np.asarray, jabo._perturb(params, key, scale)))
    src = dict(tm.named_parameters())
    dst = {n: torch.empty_like(p) for n, p in src.items()}
    tabo.perturb_(dst, src, leaf_map(tm.cfg),
                  tuple(int(x) for x in np.asarray(key)), scale)
    for n in src:
        assert np.array_equal(_tbits(dst[n]), _bits(want[n])), n
    # in place gives the same bits
    tabo.perturb_(src, src, leaf_map(tm.cfg),
                  tuple(int(x) for x in np.asarray(key)), scale)
    for n in src:
        assert np.array_equal(_tbits(src[n]), _bits(want[n])), n


def test_perturb_wrapper_checks():
    src = torch.zeros(4)
    with pytest.raises(ValueError, match="does not match"):
        abo_zo_perturb(torch.zeros(5), src, (0, 1), 0, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        abo_zo_perturb(src.double(), src.double(), (0, 1), 0, 0.1)
    with pytest.raises(ValueError, match="uint32"):
        abo_zo_perturb(src, src, (0, 2**32), 0, 0.1)


def _ref_candidates(jm, params, batch, key, state, m):
    """The reference's incumbent and candidate losses, and its winner by
    make_step's strict-less rule."""
    loss = jax.jit(lambda p, b: jm.loss(p, b)[0])
    dir_key = jax.random.fold_in(key, state["step"])
    scales = jnp.linspace(-1.0, 1.0, m)
    fs = [float(loss(params, batch))]
    for i in range(m):
        fs.append(float(loss(jabo._perturb(params, dir_key,
                                           scales[i] * state["window"]),
                             batch)))
    best, win = fs[0], -1
    for i, f in enumerate(fs[1:]):
        if np.float32(f) < np.float32(best):
            best, win = f, i
    return fs, win


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-20b"] + MOE
                         + RECURRENT + AUDIO)
def test_abo_zo_step_matches_reference(arch):
    jm, params, tm = _pair(arch)
    cfg = jabo.ABOZOConfig(window=0.05)
    toks = _batch(tm.cfg)
    jbatch, tbatch = _batches(tm.cfg, toks, _frames(tm.cfg))
    key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    jstate = {"step": jnp.asarray(3, jnp.int32),
              "window": jnp.asarray(cfg.window, jnp.float32)}
    fs, win = _ref_candidates(jm, params, jbatch, key, jstate,
                              cfg.m_candidates)
    jstep = jax.jit(jabo.make_step(lambda p, b: jm.loss(p, b)[0], cfg))
    jparams, jnew, jm_ = jstep(params, jstate, jbatch, key)
    assert float(jm_["loss"]) == min(fs)

    tcfg = tabo.ABOZOConfig(window=0.05)
    # each candidate's loss, port vs reference
    names = dict(tm.named_parameters())
    probe = {n: torch.empty_like(p) for n, p in names.items()}
    tkey = tuple(int(x) for x in np.asarray(key))
    dir_key = tabo.fold_in(tkey, 3)
    with torch.no_grad():
        got = [float(tm.loss(tbatch)[0])]
        for i, s in enumerate(tabo.base_scales(cfg.m_candidates)):
            tabo.perturb_(probe, names, leaf_map(tm.cfg), dir_key,
                          s * np.float32(cfg.window))
            with tabo._swapped(names, probe):
                got.append(float(tm.loss(tbatch)[0]))
    assert np.abs(np.array(got) - np.array(fs)).max() < LOSS_TOL

    step = tsteps.make_train_step(tm, optimizer="abo_zo", abo_cfg=tcfg,
                                  remat=False)
    state = {"step": torch.tensor(3, dtype=torch.int32),
             "window": torch.tensor(cfg.window, dtype=torch.float32)}
    state, metrics = step(state, tbatch, tkey)
    assert int(state["step"]) == int(jnew["step"]) == 4
    assert np.float32(state["window"]) == np.float32(jnew["window"])
    assert abs(float(metrics["loss"]) - min(fs)) < LOSS_TOL
    assert metrics["fe"] == cfg.m_candidates + 1
    runner = sorted(fs)
    if runner[1] - runner[0] > 2 * LOSS_TOL:
        assert metrics["best"] == win
        want = named_from_jax(tm.cfg, jax.tree.map(np.asarray, jparams))
        for n, p in tm.named_parameters():
            assert np.array_equal(_tbits(p), _bits(want[n])), n


def test_abo_zo_window_floor_and_incumbent():
    cfg = tabo.ABOZOConfig(window=2e-5, shrink=0.5, min_window=1e-5)
    jcfg = jabo.ABOZOConfig(window=2e-5, shrink=0.5, min_window=1e-5)
    w, jw = torch.tensor(cfg.window), jnp.asarray(jcfg.window, jnp.float32)
    for _ in range(3):
        w = torch.tensor(max(np.float32(np.float32(w) * np.float32(cfg.shrink)),
                             np.float32(cfg.min_window)))
        jw = jnp.maximum(jw * jcfg.shrink, jcfg.min_window)
        assert np.float32(w) == np.float32(jw)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _grads(tree, rng, scale):
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                              * scale).astype(jnp.bfloat16), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_reference(dtype, clip):
    jm, params, tm = _pair("mistral-nemo-12b", dtype)
    cfg_j, cfg_t = jadamw.AdamWConfig(), tadamw.AdamWConfig()
    rng = np.random.RandomState(11)
    jstate = jadamw.init_state(params)
    # two updates: the second starts from moments that are not zero
    grads1 = _grads(params, rng, 1.0 if clip else 1e-3)
    grads2 = _grads(params, rng, 1.0 if clip else 1e-3)
    names = dict(tm.named_parameters())
    tstate = tadamw.init_state(names)
    want0 = opt_state_from_jax(tm.cfg, jax.tree.map(np.asarray, jstate))
    for part in ("master", "m", "v"):
        for n in names:
            assert torch.equal(tstate[part][n], want0[part][n])
    groups = reference_leaves(tm.cfg)
    for grads in (grads1, grads2):
        with jax.disable_jit():      # op by op: one rounding an operation
            params, jstate, jg = jadamw.apply_update(params, grads, jstate,
                                                     cfg_j)
        tg = {n: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
              for n, a in named_from_jax(
                  tm.cfg, jax.tree.map(np.asarray, grads)).items()}
        _, tstate, gnorm = tadamw.apply_update(names, tg, tstate, cfg_t,
                                               leaf_groups=groups)
        assert abs(float(gnorm) - float(jg)) <= 1e-5 * float(jg)
        assert (float(jg) > cfg_j.grad_clip) == clip
        want = opt_state_from_jax(tm.cfg, jax.tree.map(np.asarray, jstate))
        wp = named_from_jax(tm.cfg, jax.tree.map(np.asarray, params))
        assert int(tstate["step"]) == int(want["step"])
        for n in names:
            for part in ("master", "m", "v"):
                got, exp = tstate[part][n], want[part][n]
                if clip:
                    assert float((got - exp).abs().max()) <= 1e-6, (part, n)
                else:
                    assert torch.equal(got, exp), (part, n)
            if not clip:
                assert np.array_equal(_tbits(names[n]), _bits(wp[n])), n


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_loss_and_grads_match_reference(arch):
    jm, params, tm = _pair(arch)
    toks = _batch(tm.cfg)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True)(
            params)
    tm.requires_grad_(True)
    lt, mt = tm.loss({"tokens": torch.from_numpy(toks)})
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) < LOSS_TOL
    assert abs(float(mt["ce"].detach()) - float(mj["ce"])) < LOSS_TOL
    assert abs(float(mt["aux"].detach()) - float(mj["aux"])) <= 1e-6
    if tm.cfg.n_experts:        # the loss carries 0.01·aux
        assert float(mj["aux"]) > 0
    want = named_from_jax(tm.cfg, jax.tree.map(np.asarray, gj))
    for n, p in tm.named_parameters():
        w = want[n]
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err < GRAD_TOL, (n, err)


def test_attention_gradient_on_cpu_is_the_plain_versions():
    """On CPU tensors the op is the plain version, autograd and all, and
    ``flash_attention_bwd`` is that autograd (its plain version)."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .requires_grad_(True)
               for s in ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    dout = torch.from_numpy(rng.normal(size=(2, 4, 40, 16)).astype(np.float32))
    out = tops.flash_attention(q, k, v, causal=True, window=8)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = tops.flash_attention_bwd(q, k, v, out, dout, None, causal=True,
                                    window=8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the plain version's gradient is the reference's autodiff of
    # attention_ref (GQA through jnp.repeat)
    from repro.kernels.flash_attention.ops import flash_attention as jfa
    _, vjp = jax.vjp(lambda a, b, c: jfa(a, b, c, causal=True, window=8,
                                         impl="ref"),
                     *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(dout.numpy()))):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-5


# ---------------------------------------------------------------------------
# make_train_step against the reference's jitted step
# ---------------------------------------------------------------------------
def _adamw_runs(arch, *, remat, microbatches, steps):
    """``steps`` AdamW steps through both packages' ``make_train_step``
    from the same weights and batches (an encoder-decoder's with frames):
    the losses and gnorms, each parameter's |port - JAX| flattened, and
    the port's model."""
    jm, params, tm = _pair(arch)
    mesh = make_host_mesh(1)
    jstep, _ = jsteps.make_train_step(jm, mesh, optimizer="adamw",
                                      remat=remat, microbatches=microbatches)
    with mesh:
        jstate = jsteps.init_opt_state(jm, mesh, params)
    tstep = tsteps.make_train_step(tm, optimizer="adamw", remat=remat,
                                   microbatches=microbatches)
    tstate = tsteps.init_opt_state(tm)
    out = []
    for s in range(steps):
        toks = _batch(tm.cfg, b=4, seed=20 + s)
        jb, tb = _batches(tm.cfg, toks, _frames(tm.cfg, b=4, seed=40 + s))
        with mesh:
            params, jstate, jmet = jstep(params, jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    float(jmet["gnorm"]), float(tmet["gnorm"])))
    want = named_from_jax(tm.cfg, jax.tree.map(np.asarray, params))
    err = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                          for n, p in tm.named_parameters()])
    return out, err, tm


def _hold_steps(out, err):
    for lj, lt, gj, gt in out:
        assert abs(lj - lt) < LOSS_TOL
        assert abs(gj - gt) <= 1e-5 * gj
    assert (err > STEP_TOL).mean() <= STEP_SHARE
    assert err.max() <= 2 * tadamw.AdamWConfig().lr


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_train_step_matches_reference(remat, steps):
    _hold_steps(*_adamw_runs("mistral-nemo-12b", remat=remat, microbatches=1,
                             steps=steps)[:2])


@pytest.mark.parametrize("arch", MOE)
def test_moe_adamw_train_step_matches_reference(arch):
    """One AdamW step through a float32 router and the experts."""
    _hold_steps(*_adamw_runs(arch, remat=True, microbatches=1, steps=1)[:2])


@pytest.mark.parametrize("arch", RECURRENT + AUDIO)
def test_recurrent_adamw_train_step_matches_reference(arch):
    """One AdamW step with remat through S and S-bwd (recurrentgemma-2b's
    RG-LRU layers beside its local attention), W and W-bwd (rwkv6-3b's
    float32 leaves among its bf16-typed tree) and whisper-small's encoder,
    decoder and cross-attention with frames."""
    _hold_steps(*_adamw_runs(arch, remat=True, microbatches=1, steps=1)[:2])


def test_adamw_microbatches_match_reference():
    _hold_steps(*_adamw_runs("h2o-danube-3-4b", remat=True, microbatches=2,
                             steps=2)[:2])


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-20b"])
def test_remat_is_bit_identical(arch):
    """Remat recomputes the same forward, so the gradients and the updated
    parameters keep their bits."""
    runs = []
    for remat in (False, True):
        _, _, tm = _pair(arch)
        step = tsteps.make_train_step(tm, optimizer="adamw", remat=remat)
        state = tsteps.init_opt_state(tm)
        for s in range(2):
            state, met = step(state, {"tokens": torch.from_numpy(
                _batch(tm.cfg, b=4, seed=30 + s))})
        runs.append(({n: p.detach().clone() for n, p in tm.named_parameters()},
                     float(met["loss"]), float(met["gnorm"])))
    (pa, la, ga), (pb, lb, gb) = runs
    assert la == lb and ga == gb
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


def test_remat_modes():
    from repro_torch.models import transformer as ttfm
    assert ttfm._remat_wrap(abs, False) is abs
    with pytest.raises(ValueError, match="remat"):
        ttfm._remat_wrap(abs, "offload")
    f = ttfm._remat_wrap(lambda x: (x * 2, x.sum()), "save_collectives")
    x = torch.ones(3, requires_grad=True)
    y, s = f(x)
    (y.sum() + s).backward()
    assert torch.equal(x.grad, torch.full((3,), 3.0))


def test_prefill_after_the_adamw_route_builds_no_graph():
    """The AdamW route turns requires_grad on; the serving step still
    builds no autograd graph and gives the same bits as before."""
    _, _, tm = _pair("mistral-nemo-12b")
    batch = {"tokens": torch.from_numpy(_batch(tm.cfg, b=2, seed=50))}
    prefill = tsteps.make_prefill_step(tm)
    before = prefill(batch)
    tsteps.make_train_step(tm, optimizer="adamw")
    assert all(p.requires_grad for p in tm.parameters())
    after = prefill(batch)
    assert after.grad_fn is None and not after.requires_grad
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _train(tmp, steps, optimizer):
    return ttrain.main([
        "--arch", "mistral-nemo-12b", "--reduced", "--steps", str(steps),
        "--seq-len", "32", "--batch", "4", "--ckpt-dir", str(tmp),
        "--ckpt-every", "4", "--log-every", "100", "--optimizer", optimizer,
        "--device", CPU])


def _ckpt_leaves(directory, step):
    d = directory / f"step_{step:012d}"
    return [np.load(f) for f in sorted(d.glob("leaf_*.npy"))]


@pytest.mark.parametrize("optimizer", ["adamw", "abo_zo"])
def test_train_resume_determinism(tmp_path, optimizer):
    """launch/train.py resumes from its checkpoint and matches the
    uninterrupted run bit for bit: parameters, optimizer state, loss."""
    loss_full = _train(tmp_path / "a", 8, optimizer)
    _train(tmp_path / "b", 4, optimizer)
    loss_resumed = _train(tmp_path / "b", 8, optimizer)
    assert loss_full == loss_resumed
    a, b = _ckpt_leaves(tmp_path / "a", 8), _ckpt_leaves(tmp_path / "b", 8)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_train_launcher_runs_as_a_module():
    """``python -m repro_torch.launch.train`` trains, as the reference's
    docstring runs it (its example is olmoe-1b-7b)."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--reduced", "--steps", "2", "--seq-len", "16",
         "--batch", "2", "--device", CPU], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": src,
                          "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    assert "[train] done: 2 steps" in out.stdout, out.stdout


def test_train_launcher_model_parallel_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        ttrain.main(["--arch", "mistral-nemo-12b", "--reduced",
                     "--model-parallel", "2", "--device", CPU])


def test_train_launcher_abo_zo_loss_never_rises(capsys):
    """ABO-ZO's incumbent is among its candidates, so the step's loss is at
    most the incumbent's on the step's batch."""
    _, _, tm = _pair("mistral-nemo-12b")
    step = tsteps.make_train_step(tm, optimizer="abo_zo")
    state = tsteps.init_opt_state(tm, "abo_zo")
    batch = {"tokens": torch.from_numpy(_batch(tm.cfg, b=4, seed=40))}
    with torch.no_grad():
        f0 = float(tm.loss(batch)[0])
    state, met = step(state, batch, tabo.fold_in(tabo.prng_key(1), 0))
    assert float(met["loss"]) <= f0
    with torch.no_grad():
        assert float(tm.loss(batch)[0]) == float(met["loss"])
