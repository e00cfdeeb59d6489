"""The port's separable objectives (repro_torch.objectives) against the JAX
package's, on the same numpy inputs: terms, aggregates, combine and
term_delta for all five objectives.

Tolerances, from measurement on these inputs:
  * relative 1e-5 everywhere, except
  * Griewank's log|cos| plane (L), held to absolute 1e-3·(1 + |value|):
    torch and XLA:CPU round log|cos| differently (measured up to 1.6e-4 of
    1 + |term|, 2.3e-6 relative on the aggregate).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.objectives as J
import repro_torch.objectives as T
from repro_torch.objectives.base import REDUCE_TILE

NAMES = ["griewank", "sphere", "rastrigin", "schwefel_2_22", "shifted_sphere"]
SIZES = [100, 4096, 10_000, 3 * 4096 + 5]
RTOL = 1e-5
L_ATOL = 1e-3      # times (1 + |value|), Griewank's L plane only


def _close(obj_name, got, want, scale=None):
    """Assert got ≈ want plane by plane (last axis = aggregate planes),
    relative to ``scale`` (default |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else scale
    assert got.shape == want.shape
    for a in range(want.shape[-1]):
        with np.errstate(invalid="ignore"):   # equal infinities are equal
            err = np.where(got[..., a] == want[..., a], 0.0,
                           np.abs(got[..., a] - want[..., a]))
        if obj_name == "griewank" and a == 1:
            tol = L_ATOL * (1 + np.abs(want[..., a]))
        else:
            tol = RTOL * scale[..., a] + 1e-30
        assert (err <= tol).all(), (obj_name, a, err.max(), tol.min())


def _jax_aggregates(obj, x, n_valid):
    """The reference's aggregates of x, with the tail tile padded by ones.

    XLA:CPU flushes subnormals, so the reference's float32 log clamp at
    1e-38 is log(0) = -inf on its own zero-padded tail, and the masked
    -inf · 0 makes Schwefel 2.22's L NaN at every ragged length. Its sums
    depend only on the masked content (fixed-origin tiles), so padding the
    tail with a finite value gives the reference's true aggregates."""
    pad = -len(x) % REDUCE_TILE
    xp = np.concatenate([x, np.ones(pad, x.dtype)])
    return np.asarray(obj.aggregates(jnp.asarray(xp), n_valid,
                                     agg_dtype=jnp.float32))


def _inputs(name, n, seed=0):
    obj = J.OBJECTIVES[name]
    rng = np.random.RandomState(seed)
    return rng.uniform(obj.lower, obj.upper, n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_terms_match_reference(name, n):
    x = _inputs(name, n)
    want = J.OBJECTIVES[name].terms(jnp.arange(n), jnp.asarray(x))
    got = T.OBJECTIVES[name].terms(torch.arange(n), torch.from_numpy(x))
    # a term is held to its plane's scale: Rastrigin's x² − 10·cos(2πx)
    # cancels to ~0 where the two parts are large
    want = np.asarray(want)
    _close(name, got.numpy(), want,
           scale=np.abs(want).max(axis=0, keepdims=True))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_aggregates_and_combine_match_reference(name, n):
    x = _inputs(name, n, seed=1)
    oj, ot = J.OBJECTIVES[name], T.OBJECTIVES[name]
    for n_valid in (n, n - 3):
        want = _jax_aggregates(oj, x, n_valid)
        got = ot.aggregates(torch.from_numpy(x), n_valid).numpy()
        assert got.dtype == np.float32
        _close(name, got, want)
        # combine of the same aggregates
        _close(name, ot.combine(torch.tensor(want)).numpy()[None],
               np.asarray(oj.combine(jnp.asarray(want)))[None])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_term_delta_matches_reference(name, n):
    obj_j, obj_t = J.OBJECTIVES[name], T.OBJECTIVES[name]
    rng = np.random.RandomState(2)
    b = min(n, 257)
    idx = np.sort(rng.choice(n, b, replace=False)).astype(np.int32)
    old = rng.uniform(obj_j.lower, obj_j.upper, b).astype(np.float32)
    new = rng.uniform(obj_j.lower, obj_j.upper, (b, 7)).astype(np.float32)
    want = np.asarray(obj_j.term_delta(jnp.asarray(idx), jnp.asarray(old),
                                       jnp.asarray(new)))
    got = obj_t.term_delta(torch.from_numpy(idx).long(), torch.from_numpy(old),
                           torch.from_numpy(new)).numpy()
    # a difference of two terms is held to the scale of its operands
    t_new = np.abs(np.asarray(obj_j.terms(
        jnp.broadcast_to(jnp.asarray(idx)[:, None], new.shape),
        jnp.asarray(new))))
    t_old = np.abs(np.asarray(obj_j.terms(jnp.asarray(idx), jnp.asarray(old))))
    _close(name, got, want,
           scale=t_new.max(axis=(0, 1)) + t_old.max(axis=0))


@pytest.mark.parametrize("name", NAMES)
def test_probe_equals_full_reevaluation(name):
    # the O(1) probe of one coordinate change == the O(n) recomputation
    obj = T.OBJECTIVES[name]
    x = torch.from_numpy(_inputs(name, 300, seed=3)).double()
    aggs = obj.aggregates(x, agg_dtype=torch.float64)
    cand = torch.tensor([[obj.lower * 0.3, obj.upper * 0.7]], dtype=torch.float64)
    f_probe = obj.probe(aggs, torch.tensor([17]), x[17:18], cand)[0]
    for j in range(2):
        y = x.clone()
        y[17] = cand[0, j]
        f_full = obj.value(y, agg_dtype=torch.float64)
        np.testing.assert_allclose(float(f_probe[j]), float(f_full), rtol=1e-9)


@pytest.mark.parametrize("n", [1, 4095, 4096, 3 * 4096 + 5])
def test_tile_partials_fold_to_aggregates_bitwise(n):
    # the fixed-origin reduction contract: folding per-tile partials in
    # index order gives aggregates' bits, whatever the physical length
    obj = T.GRIEWANK
    x = torch.from_numpy(_inputs("griewank", n, seed=4))
    n_tiles = -(-n // REDUCE_TILE)
    xp = torch.zeros(n_tiles * REDUCE_TILE)
    xp[:n] = x
    parts = torch.stack([obj.tile_partial(xp[t * REDUCE_TILE:(t + 1) * REDUCE_TILE],
                                          t, n) for t in range(n_tiles)])
    parts = torch.cat([parts, torch.full((2, 3), 7.0)])   # rows past n_tiles
    folded = obj.fold_tile_partials(parts, n_tiles)
    assert torch.equal(folded, obj.aggregates(x, n))
    assert torch.equal(obj.aggregates(xp, n), obj.aggregates(x, n))


def test_schwefel_log_flushes_like_reference():
    # The reference's log(max(|x|, 1e-38)) runs where float32 subnormals
    # flush to zero: log|x| is -inf at 0 and at subnormal |x|, finite above.
    x = np.array([0.0, 1e-39, 2e-38, 0.5, -3.0], np.float32)
    want = np.asarray(J.SCHWEFEL_222.terms(jnp.arange(5), jnp.asarray(x)))
    got = T.SCHWEFEL_222.terms(torch.arange(5), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got[:, 1]), [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(np.isneginf(got[:, 1]),
                                  np.isneginf(want[:, 1]))
    np.testing.assert_allclose(got[2:, 1], want[2:, 1], rtol=1e-6)
    # float64 keeps the clamp: 1e-38 is a normal float64
    got64 = T.SCHWEFEL_222.terms(torch.arange(1),
                                 torch.zeros(1, dtype=torch.float64))
    assert float(got64[0, 1]) == pytest.approx(np.log(1e-38))


def test_aggregates_stream_without_an_n_by_aggs_intermediate(monkeypatch):
    # zero-RAM: no (n, n_aggs) terms tensor is ever built
    from repro_torch.objectives import base
    monkeypatch.setattr(base, "STREAM_TILES", 2)
    seen = []
    obj = T.GRIEWANK
    terms = obj.terms

    def spy(idx, x):
        seen.append(x.numel())
        return terms(idx, x)

    spied = base.SeparableObjective(obj.name, obj.n_aggs, spy, obj.combine,
                                    obj.lower, obj.upper, obj.combine_relaxed)
    x = torch.from_numpy(_inputs("griewank", 5 * REDUCE_TILE + 9, seed=5))
    got = spied.aggregates(x)
    assert max(seen) <= 2 * REDUCE_TILE
    assert torch.equal(got, obj.aggregates(x))


def test_registry_matches_reference():
    assert sorted(T.OBJECTIVES) == sorted(J.OBJECTIVES)
    for name, oj in J.OBJECTIVES.items():
        ot = T.OBJECTIVES[name]
        assert (ot.n_aggs, ot.lower, ot.upper) == (oj.n_aggs, oj.lower, oj.upper)
        assert (ot.combine_relaxed is None) == (oj.combine_relaxed is None)


def test_griewank_forms_agree():
    x = torch.from_numpy(_inputs("griewank", 64, seed=6)).double()
    np.testing.assert_allclose(float(T.griewank(x, agg_dtype=torch.float64)),
                               float(T.griewank_naive(x)), rtol=1e-12)
    assert float(T.griewank(torch.zeros(4096))) == 0.0
