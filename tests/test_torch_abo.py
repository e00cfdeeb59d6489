"""The port's solver (repro_torch.core.abo) against the JAX package's, on
the CPU: config validation, the pass schedule, seeded starts (bit-exact for
float32), the candidate grid, one pass continued from a JAX state, whole
solves to the quality thresholds of tests/test_abo.py, and the package's
rules (no JAX import, the card by default).

The JAX side stays at n <= 1000: its n=10,000 solve costs minutes here.
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

import repro.core.abo as JA
import repro.objectives as J
import repro_torch.core.abo as TA
import repro_torch.objectives as T
from repro_torch.device import resolve_device

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"


# ---------------------------------------------------------------------------
# config, schedule, seeded starts, grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(samples_per_pass=2), dict(n_passes=0), dict(block_size=0),
    dict(span_coords=0), dict(block_size=64, span_coords=100)])
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ej:
        JA.ABOConfig(**kw)
    with pytest.raises(ValueError) as et:
        TA.ABOConfig(**kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("n", [2, 128, 129, 5000])
def test_effective_config_matches_reference(n):
    for kw in (dict(), dict(block_size=256, span_coords=512),
               dict(block_size=64, span_coords=10_240)):
        cj = JA.effective_config(JA.ABOConfig(**kw), n)
        ct = TA.effective_config(TA.ABOConfig(**kw), n)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


@pytest.mark.parametrize("kw", [dict(), dict(coupling_schedule="none"),
                                dict(n_passes=1), dict(shrink=0.3, n_passes=7),
                                dict(samples_per_pass=7, safety=1.5)])
def test_pass_schedule_tables_match_reference(kw):
    cj, ct = JA.ABOConfig(**kw), TA.ABOConfig(**kw)
    for p in range(cj.n_passes + 2):          # past the end: clipped
        hj, lj = JA.pass_schedule(cj, jnp.int32(p), jnp.float32)
        ht, lt = TA.pass_schedule(ct, p, torch.float32, device=CPU)
        assert ht.dtype == lt.dtype == torch.float32
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 + 5])
def test_seeded_start_bit_exact_float32(seed):
    n = 20_000
    want = np.asarray(JA.seeded_start(seed, n, jnp.float32, -600.0, 600.0))
    got = TA.seeded_start(seed, n, torch.float32, -600.0, 600.0,
                          chunk=1 << 12, device=CPU).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    idx = np.array([0, 5, 4095, 2**31 + 3, 2**32 - 1], np.uint32)
    want = np.asarray(JA.seeded_at(seed, jnp.asarray(idx), jnp.float32,
                                   -5.12, 5.12))
    got = TA.seeded_at(seed, torch.from_numpy(idx.astype(np.int64)),
                       torch.float32, -5.12, 5.12).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_seeded_start_float64_not_ported_yet():
    with pytest.raises(NotImplementedError):
        TA.seeded_start(0, 16, torch.float64, -1.0, 1.0, device=CPU)


@pytest.mark.parametrize("m", [3, 16, 50, 64, 129])
@pytest.mark.parametrize("first", [True, False])
def test_candidate_grid_bit_exact(m, first):
    # the reference's grid as its compiled solver computes it
    x = np.random.RandomState(m).uniform(-600, 600, 512).astype(np.float32)
    grid = jax.jit(lambda x: JA._candidate_grid(x, -600.0, 600.0,
                                                jnp.float32(0.0417), m, first))
    want = np.asarray(grid(jnp.asarray(x)))
    got = TA._candidate_grid(torch.from_numpy(x), -600.0, 600.0,
                             torch.tensor(0.0417), m, first).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tree_sum_order():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0])
    # ((1e8 + -1e8) + (1 + 1)) + 3, the reference's halving tree
    assert float(TA.tree_sum(x)) == float(JA.tree_sum(jnp.asarray(x.numpy())))


# ---------------------------------------------------------------------------
# one pass continued from a JAX state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,n", [("griewank", 5000), ("rastrigin", 700),
                                    ("shifted_sphere", 3000)])
def test_pass_step_continues_a_jax_state(name, n):
    oj, ot = J.OBJECTIVES[name], T.OBJECTIVES[name]
    cj = JA.ABOConfig(block_size=512)
    sj, cfg_j, _ = JA.abo_init(oj, n, config=cj, seed=3)
    step = jax.jit(lambda s: JA.abo_pass_step(oj, s, config=cfg_j))
    sj = step(sj)                                   # into pass 1
    st = TA.abo_state_from_numpy(np.asarray(sj.x), np.asarray(sj.aggs),
                                 np.asarray(sj.hist), np.asarray(sj.pass_idx),
                                 np.asarray(sj.n_valid), device=CPU)
    assert st.x.dtype == torch.float32 and st.pass_idx.dtype == torch.int32
    cfg_t = TA.effective_config(TA.ABOConfig(block_size=512), n)
    nj = step(sj)
    nt = TA.abo_pass_step(ot, st, config=cfg_t)
    xj, xt = np.asarray(nj.x), nt.x.numpy()
    assert (xj == xt).mean() >= 0.999
    aj, at = np.asarray(nj.aggs, np.float64), nt.aggs.numpy()
    # relative 1e-5; Griewank's L to 1e-3·(1 + |L|) (log|cos| rounding)
    tol = 1e-5 * np.abs(aj)
    if name == "griewank":
        tol[1] = 1e-3 * (1 + abs(aj[1]))
    assert (np.abs(at - aj) <= tol).all(), (at, aj)
    np.testing.assert_allclose(nt.hist.numpy(), np.asarray(nj.hist),
                               rtol=1e-5, atol=1e-6)
    assert int(nt.pass_idx) == int(nj.pass_idx) == 2
    assert int(nt.n_valid) == n


def test_pass_step_updates_x_in_place():
    st, cfg, _ = TA.abo_init(T.SPHERE, 1000, device=CPU)
    x = st.x
    nxt = TA.abo_pass_step(T.SPHERE, st, config=cfg)
    assert nxt.x is x and int(nxt.pass_idx) == 1 and int(st.pass_idx) == 0


# ---------------------------------------------------------------------------
# whole solves: the quality thresholds of tests/test_abo.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 10, 100, 1000])
def test_griewank_solve_matches_reference(n):
    rj = JA.abo_minimize(J.GRIEWANK, n)
    rt = TA.abo_minimize(T.GRIEWANK, n, device=CPU)
    assert rt.fun < 1e-6 and rj.fun < 1e-6, (rt.fun, rj.fun)
    assert rt.fe == rj.fe == 250 * n
    assert rt.x.shape == (n,) and rt.history.shape == (5,)
    assert (rt.x.numpy() == np.asarray(rj.x)).mean() >= 0.999


@pytest.mark.parametrize("name,tol", [("sphere", 1e-6), ("rastrigin", 1e-6),
                                      ("schwefel_2_22", 1e-6),
                                      ("shifted_sphere", 1e-4)])
def test_suite_solve_matches_reference(name, tol):
    rj = JA.abo_minimize(J.OBJECTIVES[name], 500)
    rt = TA.abo_minimize(T.OBJECTIVES[name], 500, device=CPU)
    assert rt.fun < tol and rj.fun < tol, (rt.fun, rj.fun)


def test_random_init_solves_match_reference():
    for seed in range(3):
        rj = JA.abo_minimize(J.GRIEWANK, 200, seed=seed)
        rt = TA.abo_minimize(T.GRIEWANK, 200, seed=seed, device=CPU)
        assert rt.fun < 1e-5 and rj.fun < 1e-5, (seed, rt.fun, rj.fun)


def test_monotone_history_and_exact_final_value():
    rt = TA.abo_minimize(T.GRIEWANK, 1000, seed=7, device=CPU)
    hist = rt.history.numpy()
    assert hist[-1] <= hist[-2] + 1e-6
    f = float(T.griewank(rt.x))
    np.testing.assert_allclose(rt.fun, f, rtol=1e-5, atol=1e-7)


def test_paper_pure_mode_and_bounds():
    rt = TA.abo_minimize(T.GRIEWANK, 100,
                         config=TA.ABOConfig(coupling_schedule="none"),
                         device=CPU)
    assert rt.fun < 0.5
    rt = TA.abo_minimize(T.SHIFTED_SPHERE, 300, seed=3, device=CPU)
    x = rt.x.numpy()
    assert (x >= T.SHIFTED_SPHERE.lower).all()
    assert (x <= T.SHIFTED_SPHERE.upper).all()


def test_per_coordinate_bounds_match_reference():
    # paper Eq. 6 worst case: each variable has its own parameter space
    n = 300
    shift = 3.0 * np.sin(np.arange(n) + 1.0)
    lo = (shift - 1.7).astype(np.float32)
    hi = (shift + 0.9).astype(np.float32)
    rj = JA.abo_minimize(J.SHIFTED_SPHERE, n, bounds=(jnp.asarray(lo),
                                                      jnp.asarray(hi)))
    rt = TA.abo_minimize(T.SHIFTED_SPHERE, n, bounds=(lo, hi), device=CPU)
    assert rt.fun < 1e-4 and rj.fun < 1e-4, (rt.fun, rj.fun)
    x = rt.x.numpy()
    assert (x >= lo).all() and (x <= hi).all()


def test_span_coords_solve_matches_reference():
    cfg = dict(block_size=256, span_coords=512)
    rj = JA.abo_minimize(J.GRIEWANK, 1000, config=JA.ABOConfig(**cfg))
    rt = TA.abo_minimize(T.GRIEWANK, 1000, config=TA.ABOConfig(**cfg),
                         device=CPU)
    assert rt.fun < 1e-6 and rj.fun < 1e-6
    assert (rt.x.numpy() == np.asarray(rj.x)).mean() >= 0.999


def test_blackbox_rosenbrock_matches_reference():
    def rosen_j(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def rosen_t(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1.0 - x[:-1]) ** 2)

    rj = JA.abo_minimize_blackbox(rosen_j, 4, -5.0, 10.0,
                                  config=JA.ABOConfig(n_passes=8, block_size=1))
    rt = TA.abo_minimize_blackbox(rosen_t, 4, -5.0, 10.0,
                                  config=TA.ABOConfig(n_passes=8, block_size=1),
                                  device=CPU)
    assert rt.fe == rj.fe == 8 * 50 * 4
    assert rt.fun < 3.0 and rj.fun < 3.0, (rt.fun, rj.fun)
    assert (np.diff(rt.history.numpy()) <= 0).all()


@pytest.mark.parametrize("kw", [dict(objective="sphere"), dict(bounds=True),
                                dict(span_coords=8192)])
def test_use_kernel_rejects_what_the_reference_rejects(kw):
    obj = T.OBJECTIVES[kw.get("objective", "griewank")]
    n = 20_000
    bounds = (np.zeros(n), np.ones(n)) if kw.get("bounds") else None
    cfg = TA.ABOConfig(use_kernel=True,
                       span_coords=kw.get("span_coords"))
    with pytest.raises(NotImplementedError):
        TA.abo_minimize(obj, n, config=cfg, bounds=bounds, device=CPU)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------
def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        TA.abo_minimize(T.GRIEWANK, 10)
    with pytest.raises(RuntimeError):
        TA.seeded_start(0, 8, torch.float32, -1.0, 1.0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (SRC / "repro_torch").rglob("*.py"))
    assert "repro_torch.kernels.coord_sweep.ops" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
