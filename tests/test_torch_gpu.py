"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports torch and the port only (no JAX), so it runs where the card is:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are those the plain versions are held to against the JAX
package on the CPU (tests/test_torch_kernels.py): one sweep pass gives x
identical on >= 99.9% of coordinates, aggregates within 1e-3·(1 + |a_in|)
and padding frozen; the Griewank aggregates agree to relative 1e-5.
"""
import pytest
import torch

from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.kernels.coord_sweep.ops import pack_aggs, sweep_pass
from repro_torch.kernels.coord_sweep.ref import (abo_minimize_kernel_ref,
                                                 sweep_pass_ref)
from repro_torch.kernels.griewank.ops import griewank_aggregates
from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
from repro_torch.objectives import GRIEWANK

SHAPES = [(1, 128, 16), (4, 256, 64), (3, 512, 128), (2, 128, 33),
          (8, 4096, 50)]
CASES = [(0.0, True), (0.5, False), (1.0, False)]
X_SAME = 0.999
AGG_TOL = 1e-3     # times (1 + |a_in|)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _uniform(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) * 1200 - 600


@pytest.mark.parametrize("n", [1, 100, 4096, 4097, 3 * 4096 + 5, 10**6 + 3])
def test_griewank_aggregates_kernel_matches_plain(cuda, n):
    x = _uniform(n, n, cuda)
    before = griewank_aggregates.launches
    for n_valid in (n, max(n - 3, 0)):
        got = griewank_aggregates(x, n_valid)
        want = griewank_aggregates_ref(x, n_valid=n_valid)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert griewank_aggregates.launches == before + 2
    # no atomics: the same bits on every run
    assert torch.equal(griewank_aggregates(x), griewank_aggregates(x))


@pytest.mark.parametrize("n_blocks,block,m", SHAPES)
@pytest.mark.parametrize("lam,is_first", CASES)
def test_sweep_pass_kernel_matches_plain(cuda, n_blocks, block, m, lam,
                                         is_first):
    x_in = _uniform((n_blocks, block), block + m, cuda)
    n = n_blocks * block - 17              # padding coordinates
    aggs = griewank_aggregates_ref(x_in, n_valid=n)
    kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam, is_first=is_first)
    xk = x_in.clone()
    before = sweep_pass.launches
    xo, ak = sweep_pass(xk, aggs, **kw)
    torch.cuda.synchronize()
    assert xo is xk and sweep_pass.launches == before + 1
    xr, ar = sweep_pass_ref(x_in.clone(), aggs, lower=-600.0, upper=600.0,
                            **kw)
    assert (xo == xr).double().mean() >= X_SAME
    a_in = aggs[0, :3].double()
    err = (ak - ar)[0, :3].double().abs()
    assert bool((err <= AGG_TOL * (1 + a_in.abs())).all()), (err, a_in)
    assert torch.equal(xo.view(-1)[n:], x_in.view(-1)[n:])
    assert not ak[0, 3:].any()


def test_kernel_route_on_the_card_matches_cpu(cuda):
    cfg = ABOConfig(block_size=512, samples_per_pass=64, use_kernel=True)
    k1, k2 = sweep_pass.launches, griewank_aggregates.launches
    rk = abo_minimize(GRIEWANK, 4096, config=cfg, device=cuda)
    assert (sweep_pass.launches - k1, griewank_aggregates.launches - k2) \
        == (5, 2)
    rc = abo_minimize(GRIEWANK, 4096, config=cfg, device="cpu")
    assert rk.fun < 1e-6 and abs(rk.fun - rc.fun) <= 1e-6
    assert (rk.x.cpu() == rc.x).double().mean() >= X_SAME


def test_kernel_route_matches_its_plain_version_on_the_card(cuda):
    cfg = ABOConfig(block_size=4096, samples_per_pass=50, use_kernel=True)
    n = 10**5 + 3
    k1, k2 = sweep_pass.launches, griewank_aggregates.launches
    rp = abo_minimize_kernel_ref(n, config=cfg, device=cuda)
    assert (sweep_pass.launches, griewank_aggregates.launches) == (k1, k2)
    rk = abo_minimize(GRIEWANK, n, config=cfg, device=cuda)
    assert rk.fun < 1e-6 and abs(rk.fun - rp.fun) <= 1e-6
    assert (rk.x == rp.x).double().mean() >= X_SAME


def test_plain_route_on_the_card_matches_cpu(cuda):
    rk = abo_minimize(GRIEWANK, 5000, device=cuda, seed=1)
    rc = abo_minimize(GRIEWANK, 5000, device="cpu", seed=1)
    assert rk.fun < 1e-6 and rc.fun < 1e-6
    assert (rk.x.cpu() == rc.x).double().mean() >= X_SAME


def test_wrappers_raise_on_cuda_float64(cuda):
    with pytest.raises(ValueError):
        griewank_aggregates(torch.zeros(8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        sweep_pass(torch.zeros((1, 128), dtype=torch.float64, device=cuda),
                   pack_aggs(torch.zeros(3, device=cuda)), m=8, n_valid=128,
                   half_width=1.0, lam=1.0, is_first=False)
