"""The port's Nelder-Mead (repro_torch.optim.nelder_mead) against the JAX
package's (repro.optim.nelder_mead), on the CPU.

Held:
  * ``simplex_bytes`` equal for float32 and float64, and the
    ``MemoryError`` raised before any allocation, with the reference's
    message;
  * in float64 (the reference under ``jax.enable_x64(True)``, as in
    tests/test_torch_abo_x64.py), ``max_fe = n + 1 + 2k`` for k = 1..K on
    sphere and Griewank from seeded starts: fe and iterations equal, x and
    fun within 1e-11 (measured: <= 2.4e-13 on x, <= 2.2e-14 on fun over
    k <= 40 at n = 6; the two packages sum in different orders);
  * the three claims of tests/test_abo.py on the port (sphere at n = 2;
    ABO below Nelder-Mead at equal FE at n = 200; the MemoryError at
    n = 1e5);
  * the chunked loop equal, bit for bit, to one iteration a host read.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.objectives as JO
import repro.optim as JN
import repro_torch.objectives as TO
import repro_torch.optim as TN
from repro_torch.core import abo_minimize

CPU = torch.device("cpu")
X64_TOL = 1e-11
K = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small tensor ops: torch's intra-op threads
    would only contend for them with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_j(x):
    return jnp.sum(x * x)


def _sphere_t(x):
    return torch.sum(x * x)


def _griewank_j(x):
    return JO.griewank(x)


def _griewank_t64(x):
    # the reference under x64 carries float64 aggregates
    return TO.griewank(x, agg_dtype=torch.float64)


FUNS = {"sphere": (_sphere_j, _sphere_t),
        "griewank": (_griewank_j, _griewank_t64)}


@pytest.mark.parametrize("n", [1, 7, 1000, 100_000])
def test_simplex_bytes_matches_reference(n):
    for jd, td in ((jnp.float32, torch.float32), (np.float64, torch.float64)):
        assert TN.simplex_bytes(n, td) == JN.simplex_bytes(n, jd)
    assert TN.simplex_bytes(n) == JN.simplex_bytes(n)


def test_memory_error_before_any_allocation(monkeypatch):
    budget = 8 << 30
    with pytest.raises(MemoryError) as want:
        JN.nelder_mead(_griewank_j, jnp.zeros(100_000),
                       memory_budget_bytes=budget)
    calls = []
    monkeypatch.setattr(torch.func, "vmap",
                        lambda *a, **k: calls.append(a) or (lambda x: x))
    with pytest.raises(MemoryError) as got:
        TN.nelder_mead(_sphere_t, torch.zeros(100_000),
                       memory_budget_bytes=budget)
    assert str(got.value) == str(want.value)
    assert "paper's NM crash regime" in str(got.value)
    assert calls == []           # raised before the simplex was built


@pytest.mark.parametrize("fun", sorted(FUNS))
@pytest.mark.parametrize("n", [3, 8])
def test_first_iterations_match_reference_x64(fun, n):
    fj, ft = FUNS[fun]
    x0 = np.random.RandomState(n).uniform(-10.0, 10.0, n)
    x0[1] = 0.0                       # the h = 0.00025 vertex
    for k in range(1, K + 1):
        max_fe = n + 1 + 2 * k
        with jax.enable_x64(True):
            rj = JN.nelder_mead(fj, jnp.asarray(x0), max_fe=max_fe)
            xj = np.asarray(rj.x)
        rt = TN.nelder_mead(ft, torch.from_numpy(x0), max_fe=max_fe)
        assert rt.x.dtype == torch.float64
        assert (rt.fe, rt.iterations, rt.converged) == \
            (rj.fe, rj.iterations, rj.converged), (k, rt, rj)
        np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=X64_TOL)
        assert abs(rt.fun - rj.fun) <= X64_TOL * max(1.0, abs(rj.fun))


def test_fe_counts_in_int64_under_float64_only(monkeypatch):
    """The reference's fe is int64 under x64; the port follows x0's
    dtype."""
    mod = importlib.import_module("repro_torch.optim.nelder_mead")
    seen, orig = [], mod._iteration

    def spy(*a):
        out = orig(*a)
        seen.append(out[2].dtype)
        return out
    monkeypatch.setattr(mod, "_iteration", spy)
    monkeypatch.setattr(mod, "CHUNK", 1)
    TN.nelder_mead(_sphere_t, torch.ones(2, dtype=torch.float64), max_fe=9)
    assert set(seen) == {torch.int64}
    seen.clear()
    TN.nelder_mead(_sphere_t, torch.ones(2), max_fe=9)
    assert set(seen) == {torch.int32}


# ---------------------------------------------------------------------------
# the paper's head-to-head (tests/test_abo.py), on the port
# ---------------------------------------------------------------------------
def test_nm_converges_small():
    x0 = torch.full((2,), 5.0)
    r = TN.nelder_mead(_sphere_t, x0, max_fe=2000)
    assert r.fun < 1e-6 and r.converged
    rj = JN.nelder_mead(_sphere_j, jnp.full((2,), 5.0), max_fe=2000)
    assert (r.fe, r.iterations) == (rj.fe, rj.iterations)


def test_abo_beats_nm_at_scale():
    """griewank_naive, not the tile form: the tile form pads each of the
    201 vertices to a 4096-coordinate tile, ~30x the work at n = 200
    (13 ms an iteration here, 25,000 iterations)."""
    n = 200
    abo = abo_minimize(TO.GRIEWANK, n, device=CPU)
    x0 = torch.full((n,), 141.6)
    x = torch.linspace(-5.0, 5.0, n)
    assert abs(float(TO.griewank_naive(x) - TO.griewank(x))) < 1e-5
    nm = TN.nelder_mead(TO.griewank_naive, x0, max_fe=abo.fe)
    assert abo.fun < nm.fun, (abo.fun, nm.fun)   # better optimum
    assert abo.fe <= nm.fe + 1                    # at equal FE budget
    assert not nm.converged


def test_nm_memory_is_quadratic_abo_linear():
    assert TN.simplex_bytes(100_000) > 100 * TN.simplex_bytes(10_000) * 0.9
    with pytest.raises(MemoryError):
        TN.nelder_mead(TO.griewank, torch.zeros(100_000),
                       memory_budget_bytes=8 << 30)


# ---------------------------------------------------------------------------
# the chunked loop
# ---------------------------------------------------------------------------
H0 = 0.00025        # the start's step where x0 == 0


def _crate_t(x):
    """An egg crate with a minimum at every multiple of H0: from x0 = 0
    the reflection and the contraction both land on crests, so the first
    iteration shrinks."""
    return -torch.cos((2 * np.pi / H0) * x).sum()


def _crate_j(x):
    return -jnp.cos((2 * np.pi / H0) * x).sum()


CHUNK_CASES = {                       # fun, x0, max_fe, converged
    "sphere_tol": (_sphere_t, (2, 5.0), 2000, True),
    "griewank_max_fe": (TO.griewank_naive, (6, 141.6), 301, False),
    "crate_tol": ("crate", (3, 0.0), 400, True),
    "crate_max_fe": ("crate", (3, 0.0), 30, False),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_gating_equals_one_iteration_a_read(case):
    """Stopping on the tolerances and on max_fe, with shrinks (fe += n + 2)
    mixed in on the egg crate, one carrying fe past max_fe."""
    fun, (n, x_start), max_fe, converged = CHUNK_CASES[case]
    fun = _crate_t if fun == "crate" else fun
    x0 = torch.full((n,), x_start)
    mod = importlib.import_module("repro_torch.optim.nelder_mead")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "CHUNK", 1)
        one = TN.nelder_mead(fun, x0, max_fe=max_fe)
    for chunk in (7, 64):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "CHUNK", chunk)
            r = TN.nelder_mead(fun, x0, max_fe=max_fe)
        assert torch.equal(r.x, one.x)
        assert (r.fun, r.fe, r.iterations, r.converged) == \
            (one.fun, one.fe, one.iterations, one.converged)
    assert one.converged == converged
    assert (one.fe < max_fe) == converged
    if case.startswith("crate"):
        assert one.fe - (n + 1) > 2 * one.iterations      # shrinks ran
    if case == "crate_max_fe":
        assert one.fe > max_fe


@pytest.mark.parametrize("n", [1, 3])
def test_shrink_counts_n_evaluations(n):
    """fe after the first iteration is (n + 1) + 2 + n, as in the
    reference; then the runs agree while shrinks and other steps mix."""
    x0 = np.zeros(n)
    for max_fe in (n + 2, 4 * n + 20):
        with jax.enable_x64(True):
            rj = JN.nelder_mead(_crate_j, jnp.asarray(x0), max_fe=max_fe)
            xj = np.asarray(rj.x)
        rt = TN.nelder_mead(_crate_t, torch.from_numpy(x0), max_fe=max_fe)
        assert (rt.fe, rt.iterations) == (rj.fe, rj.iterations)
        np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=X64_TOL)
        if max_fe == n + 2:
            assert (rt.fe, rt.iterations) == (2 * n + 3, 1)


def test_runs_on_x0s_device_else_the_card(monkeypatch):
    r = TN.nelder_mead(_sphere_t, torch.ones(2), max_fe=9)
    assert r.x.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.nelder_mead(_sphere_t, [1.0, 2.0], max_fe=9)


def test_the_loops_host_reads_are_declared_syncs():
    """The file is a hot path: without its allows, the port's lint shows
    the one read a chunk and the end-of-solve reads; with them it is
    clean."""
    from pathlib import Path
    from repro_torch.analysis import lint as tlint
    rel = "src/repro_torch/optim/nelder_mead.py"
    src = Path(rel).read_text()
    assert tlint.lint_file(rel, src) == []
    bare = src.replace("# repro: " + "allow[RPR001]", "# allow removed")
    found = tlint.lint_file(rel, bare)
    assert found and {f.rule for f in found} == {"RPR001"}
