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
                                              griewank_eval,
                                              griewank_shortcut_mismatches)
from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
from repro_torch.objectives import GRIEWANK
from repro_torch.objectives.base import tree_sum

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


# ---------------------------------------------------------------------------
# K1's cluster split (csrc/sweep_pass.cu), emulated in numpy: the residue
# classes of the 1024-leaf tree and the lanes' argmin merge give the bits of
# the single-CTA kernel at every cluster size.
# ---------------------------------------------------------------------------
def _tree(leaves):
    """The fixed-shape float32 tree: w = len/2 ... 1, red[t] += red[t + w]."""
    red = np.array(leaves, dtype=np.float32)
    w = len(red) // 2
    while w:
        red[:w] = red[:w] + red[w:2 * w]
        w //= 2
    return red[0]


def _virtual_partials(deltas):
    """Virtual thread t sums its coordinates t, t + 1024, ... in order."""
    part = np.zeros(1024, np.float32)
    for i, d in enumerate(deltas):
        part[i % 1024] = np.float32(part[i % 1024] + d)
    return part


def _cluster_sum(deltas, c):
    """What the kernel does with a cluster of c CTAs: CTA r walks its local
    slots s = k * (1024 / c) + j (coordinate k * 1024 + r + c * j) for
    virtual thread j, folds its 1024/c leaves, and the c partials are folded
    with levels c/2 ... 1."""
    v = 1024 // c
    n_k = -(-len(deltas) // 1024)
    partials = []
    for r in range(c):
        leaves = np.zeros(v, np.float32)
        for j in range(v):
            for k in range(n_k):
                i = k * 1024 + r + c * j
                if i < len(deltas):
                    leaves[j] = np.float32(leaves[j] + deltas[i])
        partials.append(_tree(leaves))
    return _tree(partials)


@pytest.mark.parametrize("block", [4096, 4097, 1000])
@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_cluster_split_sums_in_the_tree_order(block, c):
    rng = np.random.RandomState(block + c)
    # deltas of mixed sign and magnitude, so that another order would round
    # differently
    deltas = (rng.standard_normal(block)
              * 10.0 ** rng.uniform(-3, 4, block)).astype(np.float32)
    want = _tree(_virtual_partials(deltas))
    got = _cluster_sum(deltas, c)
    assert got.tobytes() == want.tobytes()


def test_cluster_split_by_contiguous_ranges_would_change_the_bits():
    """CTA r owning the contiguous virtual threads [64 r, 64 r + 64) would
    fold other pairs first: with 2^24 at t = 0, 1 at t = 1 and -2^24 at
    t = 512, the tree cancels 2^24 first and keeps the 1, a contiguous
    split rounds 2^24 + 1 first and loses it. The residue classes keep the
    tree's pairs."""
    deltas = np.zeros(1024, np.float32)
    deltas[0], deltas[1], deltas[512] = 2.0 ** 24, 1.0, -(2.0 ** 24)
    part = _virtual_partials(deltas)
    contiguous = _tree([_tree(part[64 * r:64 * (r + 1)]) for r in range(16)])
    assert contiguous.tobytes() != _tree(part).tobytes()
    assert _cluster_sum(deltas, 16).tobytes() == _tree(part).tobytes()


# ---------------------------------------------------------------------------
# K2's in-tile order (csrc/griewank_aggregates.cu), emulated in numpy: thread
# t of 256 holds coordinates t + 256·j of a 4096 tile in 16 registers; levels
# 2048..256 add register j and j + 8, + 4, + 2, + 1 in each thread; levels
# 128, 64 and 32 add warp w and w + 4, + 2, + 1 lane by lane; levels 16..1
# are warp 0's shuffles down. That is tree_sum's halving tree, add for add.
# ---------------------------------------------------------------------------
def _k2_tile_sum(leaves):
    v = np.array(leaves, dtype=np.float32).reshape(16, 256)  # v[j, t]
    for w in (8, 4, 2, 1):
        v[:w] = v[:w] + v[w:2 * w]
    warps = v[0].reshape(8, 32).copy()                       # warps[w, lane]
    for h in (4, 2, 1):
        warps[:h] = warps[:h] + warps[h:2 * h]
    lanes = warps[0].copy()
    for off in (16, 8, 4, 2, 1):
        # __shfl_down_sync: lane l reads lane l + off (its own value past
        # lane 31; lane 0's chain never reads those)
        lanes = lanes + np.concatenate([lanes[off:], lanes[32 - off:]])
    return lanes[0]


def _thread_order_tile_sum(leaves):
    """Another order a CTA could take: thread t sums t, t + 256, ... in
    index order from 0, then the CTA folds its 256 threads by a tree."""
    part = np.zeros(256, np.float32)
    for j in range(16):
        part = part + np.asarray(leaves, np.float32)[256 * j:256 * (j + 1)]
    return _tree(part)


def _mixed_tile(rng, n_valid=4096):
    """A 4096 tile of mixed sign and magnitude, zero-selected past n_valid
    as the plain version selects the ragged tail."""
    t = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-4, 6, 4096))
    return np.where(np.arange(4096) < n_valid, t, 0.0).astype(np.float32)


@pytest.mark.parametrize("n_valid", [4096, 4095, 2049, 100, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_k2_tile_order_is_tree_sum(n_valid, seed):
    leaves = _mixed_tile(np.random.RandomState(seed * 7919 + n_valid),
                         n_valid)
    want = tree_sum(torch.from_numpy(leaves)).numpy()
    assert _k2_tile_sum(leaves).tobytes() == want.tobytes()


@pytest.mark.parametrize("tile,ragged", [(0, 0), (7, 0), (244140, 0),
                                         (3, 5), (3, 4091), (244140, 2048)])
def test_k2_tile_order_gives_the_plain_tile_sums(tile, ragged):
    """Griewank's own term planes of one tile, the tail from ``ragged`` on
    selected away: the model's three sums are ``_tile_sums``' bits."""
    rng = np.random.RandomState(tile + ragged)
    x = torch.from_numpy(rng.uniform(-600, 600, 4096).astype(np.float32))
    n_valid = tile * 4096 + (4096 - ragged if ragged else 4096)
    want = GRIEWANK._tile_sums(x.view(1, 4096), tile, n_valid,
                               torch.float32)[0]
    idx = tile * 4096 + torch.arange(4096)
    planes = torch.where((idx < n_valid)[:, None], GRIEWANK.terms(idx, x),
                         0.0).numpy()
    got = np.array([_k2_tile_sum(planes[:, a]) for a in range(3)])
    assert got.tobytes() == want.numpy().tobytes()


def test_k2_in_order_thread_sums_would_change_the_bits():
    """With 2^24 at coordinate 0, 1 at 256 and -2^24 at 2048, the tree
    cancels 2^24 first (level 2048) and keeps the 1; summing each thread's
    coordinates in index order rounds 2^24 + 1 first and loses it."""
    leaves = np.zeros(4096, np.float32)
    leaves[0], leaves[256], leaves[2048] = 2.0 ** 24, 1.0, -(2.0 ** 24)
    want = tree_sum(torch.from_numpy(leaves)).numpy()
    assert _k2_tile_sum(leaves).tobytes() == want.tobytes() \
        == np.float32(1.0).tobytes()
    assert _thread_order_tile_sum(leaves).tobytes() != want.tobytes()


def test_griewank_shortcut_checks_refuse_the_cpu():
    with pytest.raises(ValueError):
        griewank_shortcut_mismatches("cpu")


def _argmin_sequential(f):
    """The single-CTA kernel's running argmin: jnp.argmin's rule."""
    best = 0
    for j in range(1, len(f)):
        if not np.isnan(f[best]) and (np.isnan(f[j]) or f[j] < f[best]):
            best = j
    return best


def _argmin_lanes(f, lanes):
    """Lane l runs the same rule over j = l, l + lanes, ...; the lanes'
    (value, index) pairs are merged by an xor butterfly, NaNs first, then
    smaller values, ties to the lower index."""
    def precedes(a, b):
        (fa, ja), (fb, jb) = a, b
        if np.isnan(fb):
            return np.isnan(fa) and ja < jb
        return np.isnan(fa) or fa < fb or (fa == fb and ja < jb)
    best = []
    for lane in range(lanes):
        js = list(range(lane, len(f), lanes))
        if js:
            j = js[_argmin_sequential(f[js])]
            best.append((f[j], j))
        else:
            best.append(None)
    o = lanes // 2
    while o:
        nxt = []
        for lane in range(lanes):
            mine, other = best[lane], best[lane ^ o]
            if other is not None and (mine is None or precedes(other, mine)):
                mine = other
            nxt.append(mine)
        best = nxt
        o //= 2
    assert all(b == best[0] for b in best)
    return best[0][1]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("m", [3, 16, 50])
def test_lane_split_argmin_is_jnp_argmin(lanes, m):
    rng = np.random.RandomState(m * 31 + lanes)
    for trial in range(200):
        f = rng.randint(0, 4, m).astype(np.float32) - 1.5   # many ties
        if trial % 3 == 0:
            f[rng.randint(0, m, 2)] = np.nan
        if trial % 5 == 0:
            f[rng.randint(0, m)] = -0.0
            f[rng.randint(0, m)] = 0.0
        want = int(jnp.argmin(jnp.asarray(f)))
        assert _argmin_sequential(f) == want
        assert _argmin_lanes(f, lanes) == want


@pytest.mark.parametrize("cluster", [0, 3, 32])
def test_sweep_pass_wrapper_rejects_bad_cluster(cluster):
    with pytest.raises(ValueError):
        sweep_pass(torch.zeros((2, 128)), torch.zeros((1, AGG_LANES)), m=16,
                   n_valid=200, half_width=1.0, lam=1.0, is_first=False,
                   cluster=cluster)
