"""The port's ABO-ZO step (``train.abo_zo`` through ``train.steps``)
against the JAX package's on the CPU, on the same numpy inputs: the
candidate losses, the winner, the window and the perturbed parameters, on
the reduced configs (dense, MoE, recurrent, whisper-small). The helpers and
tolerances are ``test_torch_train``'s (its docstring says where they come
from); the data, key arithmetic and perturbation cases stay there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import abo_zo as jabo
from repro_torch.models.params import leaf_map, named_from_jax
from repro_torch.train import abo_zo as tabo
from repro_torch.train import steps as tsteps
from test_torch_train import (AUDIO, LOSS_TOL, MOE, RECURRENT, _batch,
                              _batches, _bits, _frames, _pair, _tbits)


# ---------------------------------------------------------------------------
# ABO-ZO
# ---------------------------------------------------------------------------
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
