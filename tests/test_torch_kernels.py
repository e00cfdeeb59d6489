"""The port's kernels on the CPU: plain versions against the JAX package's
oracles, and the wrappers' contracts. The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_gpu.py.

Tolerances for one sweep pass, from measurement at these shapes:
  * x identical on >= 99.9% of coordinates (100% measured: a different
    pick needs two candidates within rounding of each other);
  * aggregates within 1e-3·(1 + |a_in|) per component (L measured up to
    0.033 at |L| ~ 160: torch and XLA:CPU round log|cos| differently, and
    the kernel sums in another order);
  * padding frozen, exactly.
Griewank aggregates: relative 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ABOConfig as JConfig
from repro.kernels.coord_sweep.ops import abo_minimize_kernel as j_abo_kernel
from repro.kernels.coord_sweep.ops import pack_aggs as j_pack_aggs
from repro.kernels.coord_sweep.ref import sweep_pass_ref as j_sweep_ref
from repro.kernels.griewank.ops import griewank_eval as j_griewank_eval
from repro.kernels.griewank.ref import griewank_aggregates_ref as j_aggs_ref
from repro.objectives import GRIEWANK as J_GRIEWANK
from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.kernels.coord_sweep.ops import abo_minimize_kernel, sweep_pass
from repro_torch.kernels.coord_sweep.ref import (AGG_LANES,
                                                 abo_minimize_kernel_ref,
                                                 sweep_pass_ref)
from repro_torch.kernels.griewank.ops import (griewank_aggregates,
                                              griewank_eval)
from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
from repro_torch.objectives import GRIEWANK

SHAPES = [(1, 128, 16), (4, 256, 64), (3, 512, 128), (2, 128, 33)]
CASES = [(0.0, True), (0.5, False), (1.0, False)]
X_SAME = 0.999
AGG_TOL = 1e-3     # times (1 + |a_in|)


def _sweep_inputs(n_blocks, block, seed):
    rng = np.random.RandomState(seed)
    x2d = rng.uniform(-600, 600, (n_blocks, block)).astype(np.float32)
    n = n_blocks * block - 17              # force padding coords
    aggs = np.asarray(j_pack_aggs(J_GRIEWANK.aggregates(
        jnp.asarray(x2d.reshape(-1)), n, agg_dtype=jnp.float32)))
    return x2d, aggs, n


def _check_pass(x_in, n, a_in, x_got, a_got, x_want, a_want):
    x_got, x_want = np.asarray(x_got), np.asarray(x_want)
    assert (x_got == x_want).mean() >= X_SAME
    a_in = np.asarray(a_in, np.float64)[0, :3]
    err = np.abs(np.asarray(a_got, np.float64)[0, :3]
                 - np.asarray(a_want, np.float64)[0, :3])
    assert (err <= AGG_TOL * (1 + np.abs(a_in))).all(), (err, a_in)
    np.testing.assert_array_equal(x_got.reshape(-1)[n:],
                                  np.asarray(x_in).reshape(-1)[n:])
    assert not np.asarray(a_got)[0, 3:].any()


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_blocks,block,m", SHAPES)
@pytest.mark.parametrize("lam,is_first", CASES)
def test_sweep_pass_ref_matches_reference(n_blocks, block, m, lam, is_first):
    x2d, aggs, n = _sweep_inputs(n_blocks, block, seed=block + m)
    kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam, is_first=is_first)
    xj, aj = j_sweep_ref(jnp.asarray(x2d), jnp.asarray(aggs), lower=-600.0,
                         upper=600.0, **kw)
    xt, at = sweep_pass_ref(torch.from_numpy(x2d.copy()),
                            torch.from_numpy(aggs.copy()), lower=-600.0,
                            upper=600.0, **kw)
    _check_pass(x2d, n, aggs, xt.numpy(), at.numpy(), xj, aj)


def test_sweep_pass_wrapper_on_cpu_is_the_plain_version_in_place():
    x2d, aggs, n = _sweep_inputs(2, 128, seed=1)
    kw = dict(m=16, n_valid=n, half_width=50.0, lam=1.0, is_first=False)
    x = torch.from_numpy(x2d.copy())
    before = sweep_pass.launches
    xo, ao = sweep_pass(x, torch.from_numpy(aggs.copy()), **kw)
    assert xo is x and sweep_pass.launches == before   # no kernel launched
    xr, ar = sweep_pass_ref(torch.from_numpy(x2d.copy()),
                            torch.from_numpy(aggs.copy()), lower=-600.0,
                            upper=600.0, **kw)
    assert torch.equal(xo, xr) and torch.equal(ao, ar)


@pytest.mark.parametrize("bad", ["float64", "strided", "aggs_shape", "m"])
def test_sweep_pass_wrapper_rejects_bad_input(bad):
    x = torch.zeros((2, 128))
    aggs = torch.zeros((1, AGG_LANES))
    m = 16
    if bad == "float64":
        x = x.double()
    elif bad == "strided":
        x = torch.zeros((128, 2)).t()
    elif bad == "aggs_shape":
        aggs = torch.zeros((1, 3))
    else:
        m = 2
    with pytest.raises(ValueError):
        sweep_pass(x, aggs, m=m, n_valid=200, half_width=1.0, lam=1.0,
                   is_first=False)


@pytest.mark.parametrize("n_blocks,chunk,n_valid", [(4, 256, 1000),
                                                    (1, 4096, 4096),
                                                    (3, 4096, 3 * 4096 - 5)])
def test_griewank_aggregates_ref_matches_reference(n_blocks, chunk, n_valid):
    rng = np.random.RandomState(chunk + n_valid)
    x2d = rng.uniform(-600, 600, (n_blocks, chunk)).astype(np.float32)
    want = np.asarray(j_aggs_ref(jnp.asarray(x2d), n_valid=n_valid))
    got = griewank_aggregates_ref(torch.from_numpy(x2d), n_valid=n_valid)
    assert got.shape == (1, AGG_LANES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[0, :3], want[0, :3], rtol=1e-5)
    assert not got.numpy()[0, 3:].any()
    # the wrapper on a CPU tensor is the plain version
    wrapped = griewank_aggregates(torch.from_numpy(x2d.reshape(-1)), n_valid)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("n,chunk", [(100, 128), (4096, 512), (5000, 1024)])
def test_griewank_eval_matches_reference(n, chunk):
    x = np.random.RandomState(n).uniform(-600, 600, n).astype(np.float32)
    want = float(j_griewank_eval(jnp.asarray(x), chunk=chunk, interpret=True))
    got = float(griewank_eval(torch.from_numpy(x)))   # REDUCE_TILE tiles
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_griewank_aggregates_wrapper_rejects_bad_input():
    for x in (torch.zeros(8, dtype=torch.float64), torch.zeros(2, 4),
              torch.zeros(8)[::2], torch.zeros(0)):
        with pytest.raises(ValueError):
            griewank_aggregates(x)


def test_kernel_path_solve_matches_reference():
    rj = j_abo_kernel(4096, config=JConfig(block_size=512,
                                           samples_per_pass=64),
                      interpret=True)
    rt = abo_minimize_kernel(4096, config=ABOConfig(block_size=512,
                                                    samples_per_pass=64),
                             device="cpu")
    assert rt.fun < 1e-6 and abs(rt.fun - rj.fun) <= 1e-6, (rt.fun, rj.fun)
    assert (rt.x.numpy() == np.asarray(rj.x)).mean() >= X_SAME
    assert rt.fe == rj.fe and rt.history.shape == (5,)
    # the same route through the entry point, with x0 (seed is dropped)
    x0 = np.random.RandomState(0).uniform(-600, 600, 4096).astype(np.float32)
    cfg = ABOConfig(block_size=512, samples_per_pass=64, use_kernel=True)
    ra = abo_minimize(GRIEWANK, 4096, config=cfg, x0=x0, seed=5, device="cpu")
    rb = abo_minimize_kernel(4096, config=cfg, x0=x0, device="cpu")
    assert torch.equal(ra.x, rb.x) and ra.fun == rb.fun


@pytest.mark.parametrize("x0_seed", [None, 3])
def test_kernel_path_plain_version_is_the_cpu_route(x0_seed):
    cfg = ABOConfig(block_size=512, samples_per_pass=16)
    x0 = (None if x0_seed is None else np.random.RandomState(x0_seed)
          .uniform(-600, 600, 1000).astype(np.float32))
    ra = abo_minimize_kernel(1000, config=cfg, x0=x0, device="cpu")
    rb = abo_minimize_kernel_ref(1000, config=cfg, x0=x0, device="cpu")
    assert torch.equal(ra.x, rb.x) and ra.fun == rb.fun and ra.fe == rb.fe
    assert torch.equal(ra.history, rb.history)
