"""Float64 solves carry float64 aggregates, as the JAX package's do under
x64.

The JAX package keeps its aggregates in float64 whenever x64 is on
(``repro.objectives.base._default_agg_dtype``). The port has no global
switch: a ``dtype=torch.float64`` solve is the reference under x64, a
float32 one the reference without it, and ``agg_dtype=torch.float64`` with
float32 ``x`` is the reference under x64 with ``dtype=jnp.float32``.

Each case runs the same solve through the JAX package under
``jax.enable_x64(True)`` and through the port on the CPU, at sizes where
float32 aggregates miss (Griewank at n = 1e6 from seed 0 ended at 15046.28
with them, Rastrigin at n = 2e5 from the golden start at 1.5). Held: fun
below the objective's threshold of tests/test_abo.py in both packages, and
every history entry of the port within 1e-6 of the JAX package's
(relative above 1). The engine's float64 jobs equal the port's
``abo_minimize`` bit for bit, history included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.abo as JA
import repro.objectives as J
import repro_torch.core.abo as TA
import repro_torch.objectives as T
from repro_torch.engine import JobSpec, SolveEngine

CPU = torch.device("cpu")

# (objective, n, seed, threshold): the thresholds of tests/test_abo.py
CASES = [("griewank", 10**6, 0, 1e-6),
         ("rastrigin", 200_000, None, 1e-6),
         ("sphere", 200_000, 0, 1e-6),
         ("schwefel_2_22", 500, None, 1e-6),
         ("shifted_sphere", 20_000, None, 1e-4)]


def _jax_x64(name, n, seed, dtype):
    with jax.enable_x64(True):
        r = JA.abo_minimize(J.OBJECTIVES[name], n, dtype=dtype, seed=seed)
        return float(r.fun), np.asarray(r.history), np.asarray(r.x).dtype


def _hold(got_hist, want_hist):
    got = got_hist.numpy()
    assert np.all(np.abs(got - want_hist)
                  <= 1e-6 * np.maximum(1.0, np.abs(want_hist))), \
        (got.tolist(), want_hist.tolist())


@pytest.mark.parametrize("name,n,seed,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_float64_solve_matches_jax_x64(name, n, seed, tol):
    fun_j, hist_j, _ = _jax_x64(name, n, seed, jnp.float64)
    r = TA.abo_minimize(T.OBJECTIVES[name], n, dtype=torch.float64,
                        seed=seed, device=CPU)
    assert r.x.dtype == torch.float64 and r.history.dtype == torch.float64
    assert hist_j.dtype == np.float64
    assert fun_j < tol and r.fun < tol, (fun_j, r.fun)
    _hold(r.history, hist_j)


@pytest.mark.parametrize("name,seed", [("rastrigin", None), ("griewank", 0)])
def test_float32_x_with_float64_aggregates_matches_jax_x64(name, seed):
    n = 200_000
    fun_j, hist_j, x_dt = _jax_x64(name, n, seed, jnp.float32)
    r = TA.abo_minimize(T.OBJECTIVES[name], n, dtype=torch.float32,
                        agg_dtype=torch.float64, seed=seed, device=CPU)
    assert x_dt == np.float32 and hist_j.dtype == np.float64
    assert r.x.dtype == torch.float32 and r.history.dtype == torch.float64
    assert fun_j < 1e-6 and r.fun < 1e-6, (fun_j, r.fun)
    _hold(r.history, hist_j)
    st, _, _ = TA.abo_init(T.OBJECTIVES[name], 1000, agg_dtype=torch.float64,
                           device=CPU)
    assert st.x.dtype == torch.float32 and st.aggs.dtype == torch.float64


def test_float32_keeps_float32_aggregates():
    """The default follows dtype: float32 stays float32 everywhere, the
    reference without x64."""
    st, _, _ = TA.abo_init(T.SPHERE, 1000, device=CPU)
    assert st.aggs.dtype == st.hist.dtype == torch.float32
    r = TA.abo_minimize(T.RASTRIGIN, 200_000, device=CPU)
    assert r.history.dtype == torch.float32
    assert r.fun == 1.5                       # float32 aggregates miss here


def test_engine_float64_job_equals_abo_minimize():
    cfg = TA.ABOConfig(samples_per_pass=12, n_passes=3, block_size=256)
    specs = [JobSpec("griewank", 3000, cfg, seed=3),
             JobSpec("rastrigin", 1500, cfg),
             JobSpec("sphere", 700, cfg, seed=5)]
    eng = SolveEngine(lanes=2, dtype=torch.float64, device=CPU)
    ids = eng.submit_many(specs)
    eng.run()
    for spec, jid in zip(specs, ids):
        got = eng.result(jid)
        want = TA.abo_minimize(T.OBJECTIVES[spec.objective], spec.n,
                               config=cfg, seed=spec.seed,
                               dtype=torch.float64, device=CPU)
        assert got.history.dtype == got.x.dtype == torch.float64
        assert got.fun == want.fun
        assert torch.equal(got.x, want.x)
        assert torch.equal(got.history, want.history)
    pool = next(iter(eng.pools.values()))
    assert pool.state.aggs.dtype == pool.state.hist.dtype == torch.float64
