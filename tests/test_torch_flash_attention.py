"""The port's attention op (repro_torch.kernels.flash_attention) against the
JAX package's, on the CPU: the plain version that the K3 wrapper runs on a
CPU tensor against JAX ``flash_attention(impl="interpret")`` (the Pallas
kernel, interpreted) and ``impl="ref"``, on the same numpy inputs.

Tolerances: 2e-3 (float32) and 2e-2 (bfloat16) max abs against the
interpreted kernel, as tests/test_kernels.py holds the kernel to its
oracle; 1e-5 (float32) and 2e-2 (bfloat16: one bf16 rounding of an O(1)
output) against the JAX plain version. Measured on the CPU
(tests/torch_parity_report.py): float32 <= 6.0e-7 against the plain version
and <= 7.2e-7 against the interpreted kernel; bfloat16 <= 0.0156 (two bf16
ulps at |x| in [1, 2)) against either.

No shape here has a query row without a valid key: there the reference's
versions disagree with each other (ROADMAP, K3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)

# (b, hq, hkv, sq, d, window, causal), as tests/test_kernels.py sweeps
SHAPE_SWEEP = [
    (2, 4, 4, 256, 64, None, True),
    (1, 8, 2, 384, 128, None, True),      # GQA
    (2, 4, 1, 256, 64, None, True),       # MQA
    (2, 4, 4, 256, 64, 128, True),        # SWA
    (1, 2, 2, 128, 64, None, False),      # encoder (non-causal)
]
TOL = {np.float32: 2e-3, "bfloat16": 2e-2}


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _port(arrs, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrs)
    return ops.flash_attention(q, k, v, **kw).float().numpy()


def _jax(arrs, impl, dtype=jnp.float32, **kw):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrs)
    return np.asarray(jax_flash(q, k, v, impl=impl, **kw).astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,d,win,causal", SHAPE_SWEEP)
def test_plain_matches_reference_shape_sweep(b, hq, hkv, sq, d, win, causal):
    arrs = _qkv(sq + d, b, hq, hkv, sq, sq, d)
    got = _port(arrs, causal=causal, window=win)
    assert got.shape == (b, hq, sq, d)
    kern = _jax(arrs, "interpret", causal=causal, window=win)
    ref = _jax(arrs, "ref", causal=causal, window=win)
    assert np.abs(got - kern).max() < TOL[np.float32]
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("shape", [(1, 2, 2, 128, 64), (1, 8, 2, 200, 128),
                                   (2, 4, 1, 96, 120)])
def test_plain_matches_reference_bf16(shape):
    b, hq, hkv, sq, d = shape
    arrs = _qkv(7, b, hq, hkv, sq, sq, d)
    got = _port(arrs, torch.bfloat16)
    kern = _jax(arrs, "interpret", jnp.bfloat16)
    ref = _jax(arrs, "ref", jnp.bfloat16)
    assert np.abs(got - kern).max() < TOL["bfloat16"]
    assert np.abs(got - ref).max() < TOL["bfloat16"]


@pytest.mark.parametrize("win", [None, 48])
def test_plain_matches_reference_non_divisible_seq(win):
    arrs = _qkv(3, 1, 2, 2, 200, 200, 64)
    got = _port(arrs, window=win)
    assert np.abs(got - _jax(arrs, "interpret", window=win)).max() < 2e-3
    assert np.abs(got - _jax(arrs, "ref", window=win)).max() < 1e-5


@pytest.mark.parametrize("causal,win", [(True, None), (True, 300),
                                        (False, None)])
def test_plain_chunked_path_matches_reference(causal, win):
    """sk > 2048 takes the chunked online softmax in both packages."""
    arrs = _qkv(11, 1, 4, 2, 2100, 2100, 32)
    got = _port(arrs, causal=causal, window=win)
    ref = _jax(arrs, "ref", causal=causal, window=win)
    assert np.abs(got - ref).max() < 1e-5
    # and the chunked version agrees with the port's dense one
    q, k, v = (torch.from_numpy(a) for a in arrs)
    k, v = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    dense = attention_ref(q, k, v, causal=causal, window=win).numpy()
    assert np.abs(got - dense).max() < 1e-5


def test_chunked_matches_dense_ragged_blocks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 2, 150, 150, 32))
    for win in (None, 20):
        a = attention_ref(q, k, v, window=win)
        c = attention_ref_chunked(q, k, v, window=win, block_k=64)
        assert (a - c).abs().max() < 1e-5


def test_cpu_tensor_runs_plain_and_counts_no_launch():
    arrs = _qkv(1, 1, 4, 2, 64, 64, 16)
    before = ops.flash_attention.launches
    got = _port(arrs)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    want = ops.flash_attention_plain(q, k, v).numpy()
    np.testing.assert_array_equal(got, want)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["heads", "dtype", "rank", "window", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "heads":
        k = v = torch.zeros(1, 3, 8, 16)
    elif bad == "dtype":
        k = k.double()
    elif bad == "rank":
        q = q[0]
    elif bad == "window":
        kw = dict(window=0)
    elif bad == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _routing_cases():
    """(name, q, k, v, kernel that ``choose_kernel`` must name)."""
    sm90, mma = "flash_attention_sm90", "flash_attention_mma"
    cases = []
    for d in (120, 128):
        cases.append((f"bf16 d={d}", _bf16(1, 4, 64, d), _bf16(1, 2, 64, d),
                      _bf16(1, 2, 64, d), sm90))
        # the model's (b, t, h, d) projections read as (b, h, t, d) views
        q = _bf16(2, 50, 4, d).transpose(1, 2)
        k = _bf16(2, 50, 2, d).transpose(1, 2)
        cases.append((f"bf16 d={d} transposed", q, k, k, sm90))
    for d in (16, 64, 112):
        cases.append((f"bf16 d={d}", _bf16(1, 4, 64, d), _bf16(1, 2, 64, d),
                      _bf16(1, 2, 64, d), mma))
    f = torch.zeros(1, 4, 64, 128)
    cases.append(("float32 d=128", f, f[:, :2], f[:, :2], mma))
    h = torch.zeros(1, 4, 64, 128, dtype=torch.float16)
    cases.append(("float16 d=128", h, h, h, mma))
    buf = _bf16(4 * 64 * 128 + 1)
    off = buf[1:].view(1, 4, 64, 128)          # 2-byte-aligned base pointer
    cases.append(("bf16 d=128 unaligned pointer", off, _bf16(1, 2, 64, 128),
                  _bf16(1, 2, 64, 128), mma))
    wide = _bf16(1, 4, 64, 132)[..., :128]     # row stride 132: 264 bytes
    cases.append(("bf16 d=128 stride 132", wide, _bf16(1, 2, 64, 128),
                  _bf16(1, 2, 64, 128), mma))
    # an extent-1 dimension's stride addresses nothing and does not count
    one = _bf16(1, 1, 64, 128).as_strided((1, 1, 64, 128), (3, 5, 128, 1))
    cases.append(("bf16 d=128 odd strides of extent-1 dims", one,
                  _bf16(1, 1, 64, 128), _bf16(1, 1, 64, 128), sm90))
    cases.append(("bf16 d=128 sk=0", _bf16(1, 2, 8, 128), _bf16(1, 2, 0, 128),
                  _bf16(1, 2, 0, 128), mma))
    # head_dim 256: the Hopper kernel of its own for aligned bf16; nothing
    # else has a kernel there (mma.sync refuses it at launch)
    d256 = "flash_attention_sm90_d256"
    cases.append(("bf16 d=256 MQA", _bf16(1, 10, 64, 256),
                  _bf16(1, 1, 64, 256), _bf16(1, 1, 64, 256), d256))
    q = _bf16(1, 50, 10, 256).transpose(1, 2)
    k = _bf16(1, 50, 1, 256).transpose(1, 2)
    cases.append(("bf16 d=256 transposed", q, k, k, d256))
    f = torch.zeros(1, 2, 64, 256)
    cases.append(("float32 d=256", f, f, f, mma))
    off = _bf16(2 * 64 * 256 + 1)[1:].view(1, 2, 64, 256)
    cases.append(("bf16 d=256 unaligned pointer", off, _bf16(1, 2, 64, 256),
                  _bf16(1, 2, 64, 256), mma))
    for d in (192, 240):
        cases.append((f"bf16 d={d}", _bf16(1, 2, 64, d), _bf16(1, 2, 64, d),
                      _bf16(1, 2, 64, d), mma))
    return cases


@pytest.mark.parametrize("case", _routing_cases(), ids=lambda c: c[0])
def test_choose_kernel_routes_by_dtype_head_dim_and_alignment(case):
    _, q, k, v, want = case
    assert ops.choose_kernel(q, k, v) == want


def test_kernel_wrappers_refuse_cpu_tensors():
    for fn, d in ((ops.flash_attention_sm90, 128),
                  (ops.flash_attention_sm90_d256, 256),
                  (ops.flash_attention_mma, 128)):
        q = _bf16(1, 2, 8, d)
        before = fn.launches
        with pytest.raises(ValueError):
            fn(q, q, q)
        assert fn.launches == before


def test_d256_forward_has_no_gradient_kernel():
    """A gradient through K3 at head_dim 256 is refused on the card before
    any launch (no backward kernel takes it); without grad the forward is
    the Hopper kernel's."""
    q = _bf16(1, 2, 8, 256)
    with pytest.raises(ValueError, match="backward kernel"):
        ops.check_bwd(q)


# d256_plan: (b, hq, hkv, sq, clusters the card holds of 1 and of 2 CTAs)
# -> (CTAs a cluster, CTAs in the grid)
H100_SLOTS = {1: 132, 2: 66}
D256_PLANS = [
    # recurrentgemma-2b's layer: 64 query blocks x 5 pairs = 320 shared
    # tiles, walked by the 66 clusters the card holds
    ((1, 10, 1, 8192, H100_SLOTS), (2, 132)),
    # MHA: no two heads share a kv head, 64 solo tiles
    ((1, 8, 8, 1024, H100_SLOTS), (1, 64)),
    # 5/1: 47 blocks x 3 batches x 2 pairs shared, x 1 lone head solo
    ((3, 5, 1, 6000, H100_SLOTS), (2, 132)),
    # GQA in pairs at batch 2: 40 shared tiles, 80 CTAs, no walk
    ((2, 8, 2, 640, H100_SLOTS), (2, 80)),
    # one tile
    ((1, 2, 1, 77, H100_SLOTS), (2, 2)),
    # 3/1 at one block: a shared tile and a solo one, one cluster
    ((1, 3, 1, 100, H100_SLOTS), (2, 2)),
    # MHA with more solo tiles than CTAs the card holds
    ((2, 8, 8, 8192, H100_SLOTS), (1, 132)),
    # a card holding fewer clusters of two (a smaller part, another
    # kernel's neighbours): the grid follows it
    ((1, 10, 1, 8192, {1: 114, 2: 57}), (2, 114)),
]


@pytest.mark.parametrize("args,want", D256_PLANS,
                         ids=[str(a[:4]) for a, _ in D256_PLANS])
def test_d256_plan(args, want):
    assert ops.d256_plan(*args) == want


@pytest.mark.parametrize("args", [a for a, _ in D256_PLANS]
                         + [(2, 6, 2, 300, {1: 5, 2: 3}),
                            (1, 7, 1, 1000, {1: 3, 2: 1})],
                         ids=lambda a: str(a[:4]))
def test_d256_tiles_count_every_head_once(args):
    """Each (query block, batch, query head) is in one tile: a shared tile
    holds two heads of one kv head, a solo tile one; clusters of two only
    where a kv head serves two or more heads, and then only an odd group's
    last head is solo. The grid ``d256_plan`` gives has no cluster without
    a tile and no more than the card holds."""
    b, hq, hkv, sq, slots = args
    cluster, n_shared, n_solo = ops.d256_tiles(b, hq, hkv, sq)
    n_qb = -(-sq // ops.D256_BLOCK_Q)
    group = hq // hkv
    assert 2 * n_shared + n_solo == n_qb * b * hq
    assert cluster == (2 if group >= 2 else 1)
    assert n_solo == n_qb * b * hkv * (group % 2 if cluster == 2 else group)
    plan_cluster, ctas = ops.d256_plan(*args)
    assert plan_cluster == cluster and ctas % cluster == 0
    clusters = ctas // cluster
    assert 1 <= clusters <= slots[cluster]
    assert clusters <= max(n_shared, -(-n_solo // cluster), 1)


# a consumer step of the head_dim 256 kernel as cuobjdump prints it: S and
# P·V issued, the wait for S, K's release, the wait for P·V, V's release
_D256_STEP = [
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R152, gdesc[UR20], R152, gsb0",
    "HGMMA.64x256x16.F32.BF16 R24, R196, gdesc[UR20].tnspB, R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "@P0 SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR22], RZ",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "@!P0 SYNCS.ARRIVE.TRANS64.ART0 RZ, [UR12+0x30020], R7",
]


def _sass(functions):
    """A cuobjdump -sass listing of ``{function name: [instructions]}``."""
    lines = []
    for name, body in functions.items():
        lines.append(f"\t\tFunction : {name}")
        lines += [f"        /*{16 * k:04x}*/   {ins} ;   /* 0x0 */"
                  for k, ins in enumerate(body)]
    return "\n".join(lines)


@pytest.mark.parametrize("body,other,early", [
    (_D256_STEP, [], []),
    # K released before the wait for S: the planted fault's order
    (_D256_STEP[:3] + [_D256_STEP[4], _D256_STEP[3]] + _D256_STEP[5:], [],
     ["0x30"]),
    # another kernel's order is not read
    (_D256_STEP, _D256_STEP[:3] + _D256_STEP[4:5], []),
], ids=["shipped", "release_before_wait", "other_kernel"])
def test_d256_release_order_reads_the_sass(body, other, early):
    """``benchmarks_torch.k3_sass.releases``, which the smoke and the fault
    check run on the card's build: an mbarrier arrival after a product
    with no wait since is early; one after a wait is not."""
    from benchmarks_torch.k3_sass import KERNEL, releases
    sass = _sass({f"_ZN4anon{KERNEL}E4Geom": body,
                  "_ZN4anon20flash_attn_sm90E4Geom": other})
    got = releases(sass)
    assert got == {"arrivals": 2, "products": 2, "early": early}


def _bwd_routing_cases():
    """(name, q, k, v, out, dout, backward kernel that
    ``choose_bwd_kernel`` must name)."""
    sm90, mma = "flash_attention_bwd_sm90", "flash_attention_bwd_mma"
    cases = []
    for d in (120, 128):
        q, kv = _bf16(1, 4, 64, d), _bf16(1, 2, 64, d)
        cases.append((f"bf16 d={d}", q, kv, kv, _bf16(1, 4, 64, d),
                      _bf16(1, 4, 64, d), sm90))
        # the model's layout: (b, t, h, d) buffers read as (b, h, t, d)
        q = _bf16(2, 50, 4, d).transpose(1, 2)
        kv = _bf16(2, 50, 2, d).transpose(1, 2)
        cases.append((f"bf16 d={d} transposed", q, kv, kv,
                      _bf16(2, 50, 4, d).transpose(1, 2),
                      _bf16(2, 50, 4, d).transpose(1, 2), sm90))
    q, kv = _bf16(1, 4, 64, 64), _bf16(1, 2, 64, 64)
    cases.append(("bf16 d=64", q, kv, kv, q, q, mma))
    f, fkv = torch.zeros(1, 4, 64, 128), torch.zeros(1, 2, 64, 128)
    cases.append(("float32 d=128", f, fkv, fkv, f, f, mma))
    q, kv = _bf16(1, 4, 64, 128), _bf16(1, 2, 64, 128)
    off = _bf16(4 * 64 * 128 + 1)[1:].view(1, 4, 64, 128)
    cases.append(("bf16 d=128 unaligned q", off, kv, kv, q, q, mma))
    wide = _bf16(1, 4, 64, 132)[..., :128]     # row stride 132: 264 bytes
    cases.append(("bf16 d=128 dout stride 132", q, kv, kv, q, wide, mma))
    cases.append(("bf16 d=128 unaligned dout", q, kv, kv, q, off, mma))
    cases.append(("bf16 d=128 unaligned out", q, kv, kv, off, q, mma))
    cases.append(("bf16 d=128 float32 dout", q, kv, kv, q,
                  torch.zeros(1, 4, 64, 128), mma))
    cases.append(("bf16 d=128 sk=0", q, _bf16(1, 2, 0, 128),
                  _bf16(1, 2, 0, 128), q, q, mma))
    return cases


@pytest.mark.parametrize("case", _bwd_routing_cases(), ids=lambda c: c[0])
def test_choose_bwd_kernel_routes_by_dtype_head_dim_and_alignment(case):
    _, q, k, v, out, dout, want = case
    assert ops.choose_bwd_kernel(q, k, v, out, dout) == want


def test_bwd_kernel_wrappers_refuse_cpu_tensors():
    q, kv = _bf16(1, 4, 64, 128), _bf16(1, 2, 64, 128)
    lse = torch.zeros(1, 4, 64)
    for fn in (ops.flash_attention_bwd_sm90, ops.flash_attention_bwd_mma):
        before = fn.launches
        with pytest.raises(ValueError, match="runs on cuda"):
            fn(q, kv, kv, q, q, lse)
        assert fn.launches == before


def test_bwd_on_cpu_is_the_plain_version_and_launches_nothing():
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn(*s, generator=g) for s in (
        (1, 4, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16), (1, 4, 40, 16)))
    counts = [w.launches for w in (ops.flash_attention_bwd,
                                   ops.flash_attention_bwd_sm90,
                                   ops.flash_attention_bwd_mma)]
    got = ops.flash_attention_bwd(q, k, v, None, dout, None, causal=True,
                                  window=8)
    want = ops.flash_attention_bwd_plain(q, k, v, dout, causal=True,
                                         window=8)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert counts == [w.launches for w in (ops.flash_attention_bwd,
                                           ops.flash_attention_bwd_sm90,
                                           ops.flash_attention_bwd_mma)]
