"""The port's AdamW update, loss and gradients, and AdamW steps through
``train.steps.make_train_step`` against the JAX package's on the CPU, on
the same numpy inputs: the update op by op (clipping off and on), the loss
and every gradient on the reduced configs, the attention's gradient on CPU
tensors (the plain version, the reference's autodiff), whole steps against
the reference's jitted step with remat on and off, microbatches, and the
port's remat bit for bit. The helpers and tolerances are
``test_torch_train``'s (its docstring says where they come from).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.models.params import (named_from_jax, opt_state_from_jax,
                                       reference_leaves)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as tsteps
from test_torch_train import (AUDIO, DENSE, GRAD_TOL, LOSS_TOL, MOE, RECURRENT,
                              STEP_SHARE, STEP_TOL, _batch, _batches, _bits,
                              _frames, _pair, _tbits)


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
