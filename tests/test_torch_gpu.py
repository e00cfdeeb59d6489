"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports torch and the port only (no JAX), so it runs where the card is:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are those the plain versions are held to against the JAX
package on the CPU (tests/test_torch_kernels.py): one sweep pass gives x
identical on >= 99.9% of coordinates, aggregates within 1e-3·(1 + |a_in|)
and padding frozen; the Griewank aggregates agree to relative 1e-5 and,
since the kernel adds in the plain version's order, bit for bit. K3 is
held as chip_smoke.py holds it: max abs on N(0, 1) inputs, and per query
row, the row's max |got - want| over its max |want|, which stays sensitive
where long rows make every output small.

The solve engine runs no kernel; its contracts on the card are that a
tile's sum does not depend on the slab it is reduced in, that every job's
fun, x and history equal the port's ``abo_minimize`` bit for bit (float64
jobs too), that a steady-state step does not synchronise with the host,
and that a snapshot resumes to the uninterrupted run's bits, also with
``sanitize=True``; the checkpoint manager's host copy of a card tensor is
the value at the save, whatever the tensor holds after it. Over HTTP, an
in-process front door whose stepper runs the engine on its own thread
delivers the same bits.

The training path's kernels (port only): K3-bwd's dQ, dK and dV against
autograd through the plain attention, each held as max |got - want| over
the tensor's max |want| and per row (BWD_TOL, BWD_ROW_TOL), two runs giving
the same bits, each case through the backward kernel that
``choose_bwd_kernel`` names (for bf16 with 16-byte strides the Hopper one
of its head dim, 120/128, 64 or 256; the mma.sync one else), whisper's
three shapes among them; each Hopper backward's D held against float64
on values with a large common part, where D from the bf16-rounded output
misses by more than 3x, its bits twice and its refusals; a reduced bf16
model at
head_dim 128 taking an AdamW step through the Hopper K3-bwd in every
layer; K3's forward keeping its output bits when it also writes the
log-sum-exp; P (ABO-ZO's perturbation) equal to its plain version bit for
bit; and a gradient through ``Model.loss`` on the card that reaches q, k
and v (the attention's projections), equal to the plain attention's.

The mixture-of-experts layer (no kernel of its own) on the card against
its CPU run, lossless and with dropped slots: the same routes and
positions, outputs within 1e-5 of their max; K3 and K3-bwd at the MoE
models' MHA layout (16 query heads over 16 KV heads); the reduced MoE
models on the card against the CPU.

recurrentgemma-2b's kernels: K3's Hopper kernel at head_dim 256
(``flash_attention_sm90_d256``) against the plain attention at its layer
shape and edges, held as the other K3 kernels are, with the same bits on a
repeat and with the log-sum-exp on; S (``rglru_lru``, port only: the
RG-LRU's gates and recurrence in one kernel) equal to its plain version run
on the card bit for bit and on a repeat, in bf16 and float32, its two
shortcuts exact on every input they can see, and raising on what it does
not take (float32 included: channels in groups of 4, 16-byte aligned);
the reduced model on the card against the CPU.

whisper-small's K3 shapes (``WHISPER_SHAPES``): the encoder's
non-causal 1500 keys (a ragged last block), cross-attention with sq != sk,
and the decoder's causal self-attention, in bf16 through the Hopper kernel
at head_dim 64 (``flash_attention_sm90_d64``) and in float32 through the
mma.sync one, the bf16 kernel held to the plain version on float64 copies
of its inputs (the bf16 plain version rounds its scores, and is the less
exact of the two there); the Hopper d = 64 kernel at ``D64_SHAPES`` with
the same bits on a repeat, its log-sum-exp, the d = 64 backward on its
lse (the mma.sync one where dO is off 16 bytes), its refusals, and the mma.sync kernel still held at those shapes; the
reduced encoder-decoder on the card against the CPU. Nelder-Mead on the card: a
chunk replayed as a CUDA graph gives the eager chunks' bits.

granite-20b, internlm2-20b and h2o-danube-3-4b (no kernel of their own):
K3 at their layer shapes in ``ATTN_SHAPES`` and granite's AdamW shape in
``BWD_SHAPES``; their real head layouts at narrow width on the card
against the CPU, forward, prefill and decode.

qwen2-vl-7b (no kernel of its own; K3 at a GQA group of 7 in
``ATTN_SHAPES``): the reduced model on the card against the CPU with an
image's M-RoPE ids and stubbed embeddings, forward, prefill and decode. The
int8 KV cache: a slot's quantization on the card bit for bit the CPU's on
the same inputs, and decode from an empty int8 cache on the card against
the CPU's.

rwkv6-3b's kernel: W (``rwkv6_wkv``, port only: RWKV6's WKV recurrence)
against its plain version run on the card at ``WKV_SHAPES`` (the model's
layer shape cut to T = 1024, a T that is no multiple of a chunk, the
reduced config's float32 head of 16, a strong-decay draw), y and the last
state each within WKV_TOL of the plain version's max |value|, overall and
per head, the same bits on a repeat; raising on a head size other than 16
or 64, a stride and a start off 16 bytes (a gradient launches W-bwd);
the reduced model on the card against the CPU.

The recurrent families' training kernels (port only): S-bwd
(``rglru_lru_bwd``) and W-bwd (``rwkv6_wkv_bwd``) against their plain
versions run on the card at ``LRU_BWD_SHAPES`` and ``WKV_BWD_SHAPES`` (the
models' layer shapes, T no tile or chunk divides, float32 and bf16, a
strong-decay draw), each gradient within ``RTRAIN_TOL`` of its max |plain|
(bf16: the outputs round to bf16), the same bits on a repeat, the
gradient through each op launching its kernel; W-bwd also against its
chunked arithmetic (``wkv_bwd_chunked``) run on the card, at the path's
T = 4096 under the strong decay, and its scratch held to
``bwd_scratch_bytes``; K3-bwd at head_dim 256
(``D256_BWD_SHAPES``: recurrentgemma-2b's layer, T below its window, GQA,
a ragged T) on the Hopper d = 256 kernel under BWD_TOL and BWD_ROW_TOL;
the
reduced recurrentgemma-2b, rwkv6-3b and whisper-small's gradients on the
card against the CPU's.
"""
import pytest
import torch

from repro_torch.analysis.sanitize import HostSyncError, sync_guard
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.engine import JobSpec, SolveEngine
from repro_torch.kernels.coord_sweep.ops import (max_active_clusters,
                                                 pack_aggs, sweep_pass)
from repro_torch.kernels.coord_sweep.ref import (abo_minimize_kernel_ref,
                                                 sweep_pass_ref)
from repro_torch.kernels.flash_attention.ops import (choose_kernel,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_mma,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_bwd_sm90,
                                                     flash_attention_bwd_sm90_d64,
                                                     flash_attention_bwd_sm90_d256,
                                                     flash_attention_mma,
                                                     flash_attention_plain,
                                                     flash_attention_sm90,
                                                     flash_attention_sm90_d64,
                                                     flash_attention_sm90_d256)
from repro_torch.kernels.perturb.ops import (abo_zo_perturb,
                                             abo_zo_perturb_plain)
from repro_torch.kernels.griewank.ops import (griewank_aggregates,
                                              griewank_shortcut_mismatches)
from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
from repro_torch.kernels.rglru_scan.ops import (rglru_lru, rglru_lru_bwd,
                                                shortcut_mismatches)
from repro_torch.kernels.rglru_scan.ref import (rglru_lru_bwd_ref,
                                                rglru_lru_ref)
from repro_torch.kernels.rwkv6_wkv.ops import (bwd_scratch_bytes, rwkv6_wkv,
                                               rwkv6_wkv_bwd)
from repro_torch.kernels.rwkv6_wkv.ref import (wkv_bwd_chunked, wkv_bwd_ref,
                                               wkv_ref)
from repro_torch.models.model import Model
from repro_torch.objectives import GRIEWANK, OBJECTIVES
from test_torch_dense_layouts import DENSE_HEADS, narrow, prompt_len
from test_torch_vlm_ids import image_ids

SHAPES = [(1, 128, 16), (4, 256, 64), (3, 512, 128), (2, 128, 33),
          (8, 4096, 50)]
CASES = [(0.0, True), (0.5, False), (1.0, False)]
X_SAME = 0.999
# (b, hq, hkv, sq, sk, d, causal, window): the shapes chip_smoke.py checks
ATTN_SHAPES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 384, 384, 128, True, None),        # GQA
    (2, 4, 1, 256, 256, 64, True, None),         # MQA
    (2, 4, 4, 256, 256, 64, True, 128),          # window
    (1, 2, 2, 128, 128, 64, False, None),        # non-causal
    (1, 4, 2, 200, 200, 64, True, None),         # ragged
    (1, 32, 8, 333, 333, 120, True, 96),         # d = 120, ragged window
    (2, 4, 2, 100, 300, 16, False, None),        # sq != sk, d = 16
    (1, 32, 8, 8192, 8192, 128, True, None),     # the model's layer shape
    (1, 16, 16, 1024, 1024, 128, True, None),    # MHA: the MoE models'
    (1, 16, 16, 8192, 8192, 128, True, None),    # their layer shape
    # qwen2-vl-7b's GQA group of 7: its layer shape, a ragged batch of 2
    (1, 28, 4, 8192, 8192, 128, True, None),
    (2, 28, 4, 333, 333, 128, True, None),
    # the dense decoders' layer shapes: granite-20b's MQA (48 query heads
    # over 1), internlm2-20b's 48/8, h2o-danube-3-4b's 32/8 at head_dim 120
    # under its 4096 window (unmasked blocks between the window's edge and
    # the diagonal); and a ragged d = 120 case at batch 2 whose window
    # starts mid-block past block 0
    (1, 48, 1, 8192, 8192, 128, True, None),
    (1, 48, 8, 8192, 8192, 128, True, None),
    (1, 32, 8, 8192, 8192, 120, True, 4096),
    (2, 32, 8, 5000, 5000, 120, True, 4096),
]
# whisper-small's (the Hopper kernel at head_dim 64 in bf16, mma.sync in
# float32): the encoder's 1500 keys (11 blocks of 128 and a ragged 92; 7
# tiles of 192 query rows and a ragged 156), cross-attention (sq != sk, the
# same ragged keys, a key split), the decoder's causal self-attention
WHISPER_SHAPES = [
    (4, 12, 12, 1500, 1500, 64, False, None),
    (4, 12, 12, 448, 1500, 64, False, None),
    (4, 12, 12, 448, 448, 64, True, None),
]
# bf16 at head_dim 64 (the Hopper kernel's route): the d = 64 rows of
# ATTN_SHAPES, whisper's, and the kernel's own edges: MQA with a window;
# GQA with a 4-way key split, ragged sq and sk; a single tile; 5 query
# rows over 900 keys (two splits, 123 empty rows of the tile)
D64_SHAPES = ([s for s in ATTN_SHAPES if s[5] == 64] + WHISPER_SHAPES + [
    (2, 8, 1, 1000, 1000, 64, True, 300),
    (2, 8, 2, 300, 2000, 64, False, None),
    (1, 2, 2, 77, 77, 64, False, None),
    (3, 4, 4, 5, 900, 64, False, None),
])
# the shapes the Hopper kernel serves: bf16 with head_dim 120 or 128
SM90_SHAPES = [s for s in ATTN_SHAPES if s[5] in (120, 128)]
# those the mma.sync kernel is also held at (not the model's T = 8192)
MMA_AT_SM90_SHAPES = [s for s in SM90_SHAPES if s[3] < 8192]
# bf16 at head_dim 256 (the Hopper kernel's only route there): the shapes
# chip_smoke.py checks, recurrentgemma-2b's layer shape last
D256_SHAPES = [
    (1, 10, 1, 333, 333, 256, True, 96),         # ragged, window
    (1, 2, 2, 100, 300, 256, False, None),       # non-causal, sq != sk
    (1, 8, 8, 1024, 1024, 256, True, None),      # causal, no window
    # the clusters and the persistent walk: a 5/1 group (its last head has
    # no partner; shared and solo tiles both outnumber the grid), GQA in
    # pairs at batch 2, a single tile
    (3, 5, 1, 6000, 6000, 256, True, 1000),
    (2, 8, 2, 640, 640, 256, True, 300),
    (1, 2, 1, 77, 77, 256, True, None),
    (1, 10, 1, 8192, 8192, 256, True, 2048),     # the model's layer shape
]
# S at recurrentgemma-2b's (batch, T, lru_width), a ragged one, and edges
# (S takes channels in groups of 16 bytes: 8 bf16, 4 float32)
SCAN_SHAPES = [(1, 8192, 2560), (3, 1000, 2568), (2, 64, 4), (1, 1, 300),
               (2, 65, 260)]
LRU_SHAPES = [(1, 8192, 2560), (3, 1000, 2568), (2, 64, 8), (1, 1, 296),
              (2, 97, 264), (4, 50, 64)]
# W at rwkv6-3b's (b, T, H, hd) cut to T = 1024, a T no chunk divides, the
# reduced config's float32 head of 16, and a strong-decay draw (the decay
# base + 3: the fastest channels decay by e^-12 a step, where cumulative
# decays over a chunk overflow unless split) at a T no chunk divides; the
# last entry is that shift of the decay's log-log. Its limit: max |got -
# want| over max |want|, of y and of the last state, overall and per head
WKV_SHAPES = [(1, 1024, 40, 64, torch.bfloat16, 0.0),
              (2, 77, 40, 64, torch.bfloat16, 0.0),
              (3, 1000, 4, 16, torch.float32, 0.0),
              (1, 1000, 40, 64, torch.bfloat16, 3.0)]
WKV_TOL = 1e-5     # chip_smoke.py's: 1.9e-6 at most measured (PERF.md)
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
ATTN_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
AGG_TOL = 1e-3     # times (1 + |a_in|)
# K3-bwd: the shapes chip_smoke.py checks (the AdamW training shape, the
# reduced config's at 512 and at the resume's 128 tokens, a ragged sq and a
# window, the Hopper kernel's edges, and a Hopper-eligible shape whose dO
# rows are 132 elements apart, the last element: the mma.sync kernel takes
# it), and its limits: max |got - want| over the tensor's max |want|,
# overall and per row (PERF.md has the readings)
BWD_SHAPES = [
    (8, 32, 8, 512, 512, 128, True, None, torch.bfloat16),
    (4, 4, 2, 512, 512, 16, True, None, torch.float32),
    (4, 4, 2, 128, 128, 16, True, None, torch.float32),
    (2, 4, 2, 200, 200, 64, True, None, torch.bfloat16),
    (2, 4, 2, 200, 200, 64, True, None, torch.float32),
    (2, 4, 4, 256, 256, 64, True, 96, torch.bfloat16),
    (2, 4, 4, 256, 256, 64, True, 96, torch.float32),
    (1, 16, 16, 1024, 1024, 128, True, None, torch.bfloat16),   # MHA
    (8, 16, 16, 512, 512, 128, True, None, torch.bfloat16),  # olmoe's AdamW
    (2, 4, 2, 200, 200, 128, True, None, torch.bfloat16),    # ragged sq
    (1, 32, 8, 333, 333, 120, True, 96, torch.bfloat16),     # d = 120
    (2, 4, 2, 100, 300, 128, False, None, torch.bfloat16),   # sq != sk
    (1, 48, 1, 256, 256, 128, True, None, torch.bfloat16),   # MQA
    (8, 48, 1, 512, 512, 128, True, None, torch.bfloat16),   # granite's AdamW
    (2, 4, 2, 200, 200, 128, True, None, torch.bfloat16, 132),  # dO stride
    # whisper-small's three (bf16, head_dim 64): the encoder, cross- and
    # decoder self-attention, and a d = 64 dO row stride off 16 bytes
    (4, 12, 12, 1500, 1500, 64, False, None, torch.bfloat16),
    (4, 12, 12, 448, 1500, 64, False, None, torch.bfloat16),
    (4, 12, 12, 448, 448, 64, True, None, torch.bfloat16),
    (2, 4, 2, 200, 200, 64, True, None, torch.bfloat16, 68),
]
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_ROW_TOL = {torch.bfloat16: 1e-1, torch.float32: 1e-3}
# K3-bwd at head_dim 256 (the Hopper kernel, bf16): recurrentgemma-2b's
# layer at train_4k's T, T below the window, GQA in pairs, a ragged T
D256_BWD_SHAPES = [(1, 10, 1, 4096, 4096, 256, True, 2048, torch.bfloat16),
                   (1, 10, 1, 1000, 1000, 256, True, 2048, torch.bfloat16),
                   (2, 8, 2, 640, 640, 256, True, 300, torch.bfloat16),
                   (1, 2, 1, 77, 77, 256, True, None, torch.bfloat16)]
# S-bwd at recurrentgemma-2b's (1, 4096, 2560), a T no tile of 64 divides,
# and edges; W-bwd at rwkv6-3b's (1, 4096, 40, 64), a T no chunk of 16
# divides in float32, the reduced head of 16, a strong-decay draw. Each
# gradient held as max |got - want| over max |want| (float32 outputs:
# the two sum in other orders over up to 4096 steps; bf16 outputs round to
# bf16, one spacing 2^-8 of the value)
LRU_BWD_SHAPES = [(1, 4096, 2560), (3, 1000, 2568), (2, 65, 264),
                  (1, 1, 296)]
WKV_BWD_SHAPES = [(1, 4096, 40, 64, torch.bfloat16, 0.0),
                  (2, 77, 40, 64, torch.float32, 0.0),
                  (3, 100, 4, 16, torch.float32, 0.0),
                  (1, 1000, 40, 64, torch.float32, 3.0)]
RTRAIN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_ROW_FLOOR = 5e-2      # see _grad_row_err
# a model's gradients with K3 and K3-bwd against the plain attention's, per
# tensor, max |diff| over max |plain| (bf16: the plain attention rounds
# Q·Kᵀ to bf16, the kernels keep it float32)
MODEL_GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}

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
        # the kernel adds in the plain version's order: the same bits
        assert torch.equal(got, want)
    assert griewank_aggregates.launches == before + 2
    # no atomics: the same bits on every run
    assert torch.equal(griewank_aggregates(x), griewank_aggregates(x))


@pytest.mark.parametrize("n", [4097, 3 * 4096 + 5, 10**6 + 3])
def test_griewank_aggregates_kernel_selects_away_inf_and_nan(cuda, n):
    """inf and NaN past n_valid: the plain version selects zeros there
    (a where, not a multiply by the mask), and so does the kernel."""
    x = _uniform(n, n + 1, cuda)
    x[n - 7:n - 4] = torch.tensor([float("inf"), float("nan"),
                                   -float("inf")], device=cuda)
    got = griewank_aggregates(x, n - 7)
    want = griewank_aggregates_ref(x, n_valid=n - 7)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_griewank_aggregates_shortcuts_match_the_library(cuda):
    """Each shortcut of the kernel gives the library call's bits on every
    input of its domain (sin/cos on all 2^32 bit patterns)."""
    mismatches = griewank_shortcut_mismatches(cuda)
    assert set(mismatches) == {"sincos", "rsqrt_approx_ftz",
                               "int32_to_float", "log1p"}
    assert not any(mismatches.values()), mismatches


def test_griewank_aggregates_is_one_launch_with_the_same_bits(cuda):
    x = _uniform(10**7 + 11, 3, cuda)
    before = griewank_aggregates.launches
    first = griewank_aggregates(x, 10**7 + 5)
    assert griewank_aggregates.launches == before + 1
    for _ in range(3):
        assert torch.equal(griewank_aggregates(x, 10**7 + 5), first)


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


@pytest.mark.parametrize("n_blocks,block,m", [(64, 4096, 50), (6, 4097, 50),
                                              (5, 1000, 33)])
@pytest.mark.parametrize("lam,is_first", CASES)
def test_sweep_pass_cluster_keeps_the_bits(cuda, n_blocks, block, m, lam,
                                           is_first):
    """A cluster of 16 (and of 2, 4, 8) CTAs gives the single CTA's x and
    aggregates bit for bit, including blocks that are not a multiple of
    1024."""
    x_in = _uniform((n_blocks, block), block * 7 + m, cuda)
    n = n_blocks * block - 17
    aggs = griewank_aggregates_ref(x_in, n_valid=n)
    kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam, is_first=is_first)
    x1 = x_in.clone()
    _, a1 = sweep_pass(x1, aggs, cluster=1, **kw)
    for c in (16, 8, 4, 2):
        xc = x_in.clone()
        _, ac = sweep_pass(xc, aggs, cluster=c, **kw)
        torch.cuda.synchronize()
        assert torch.equal(xc, x1), c
        assert torch.equal(ac, a1), c


def test_sweep_pass_cluster_of_16_fits_on_the_card(cuda):
    assert max_active_clusters(4096, 16) >= 1


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


def _row_rel_err(got, want):
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _qkv(shape, dtype, dev, seed=0):
    b, hq, hkv, sq, sk, d = shape[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    assert err < ATTN_TOL[dtype], err
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[dtype]


@pytest.mark.parametrize("shape", WHISPER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_whisper_shapes(cuda, shape, dtype):
    """At long non-causal rows the bf16 plain version is the less exact of
    the two: it rounds the scores to bf16 before the softmax (as the
    reference's ``attention_ref`` does), which moves a row of 1500 small
    outputs by ~0.019 of its max, where the kernel, with float32 scores,
    is ~0.0056 from the plain version run on float64 copies of the same
    inputs (float32 scores; an H100). So the kernel is held to that run
    (max abs and per row within ATTN_TOL and ATTN_ROW_TOL), to the bf16
    plain version in max abs, and to be no further from that run per row
    than the bf16 plain version is; in float32, to the plain version as
    ATTN_SHAPES are."""
    causal = shape[6]
    q, k, v = _qkv(shape, dtype, cuda)
    kernel = (flash_attention_sm90_d64 if dtype == torch.bfloat16
              else flash_attention_mma)
    before = kernel.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    assert err < ATTN_TOL[dtype], err
    if dtype == torch.float32:
        assert _row_rel_err(got, want) < ATTN_ROW_TOL[dtype]
        return
    exact = flash_attention_plain(q.double(), k.double(), v.double(),
                                  causal=causal)
    assert float((got.double() - exact).abs().max()) < ATTN_TOL[dtype]
    row = _row_rel_err(got, exact)
    assert row < ATTN_ROW_TOL[dtype], row
    assert row <= _row_rel_err(want, exact)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_strided_and_unaligned(cuda, dtype):
    """The model's (b, t, h, d) projections read through transposed views,
    and rows that are not 16-byte aligned (the scalar-load path)."""
    b, t, hq, hkv, d = 2, 150, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, t, hq, d, generator=g, device=cuda).to(dtype)
    buf = torch.randn(2 * b * t * hkv * d + 4, generator=g,
                      device=cuda).to(dtype)
    k = buf[4:4 + b * t * hkv * d].view(b, t, hkv, d)
    v = buf[4 + b * t * hkv * d:].view(b, t, hkv, d)
    args = [x.transpose(1, 2) for x in (q, k, v)]
    got = flash_attention(*args, causal=True)
    want = flash_attention_plain(*args, causal=True)
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[dtype]


@pytest.mark.parametrize("shape", SM90_SHAPES)
def test_flash_attention_sm90_matches_plain(cuda, shape):
    """The Hopper kernel at the bf16 shapes it serves (d = 120 and 128,
    the windowed ragged d = 120 one included), through the op's routing;
    only its own launch count moves."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    assert choose_kernel(q, k, v) == "flash_attention_sm90"
    new, old = flash_attention_sm90.launches, flash_attention_mma.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_sm90.launches == new + 1
    assert flash_attention_mma.launches == old
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("d", [120, 128])
def test_flash_attention_sm90_strided_view(cuda, d):
    """(b, t, h, d) projections read through their (b, h, t, d) transposes,
    as the model passes them, with the tensor maps over the strided views."""
    b, t, hq, hkv = 2, 300, 8, 2
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = [torch.randn(b, t, h, d, generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv)]
    assert choose_kernel(q, k, v) == "flash_attention_sm90"
    before = flash_attention_sm90.launches
    got = flash_attention(q, k, v, causal=True, window=100)
    assert flash_attention_sm90.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, window=100)
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("shape", MMA_AT_SM90_SHAPES)
def test_flash_attention_mma_still_matches_plain_at_sm90_shapes(cuda, shape):
    """The mma.sync kernel, called directly, still agrees where the op now
    routes to the Hopper kernel (the smoke times the two there)."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    before = flash_attention_mma.launches
    got = flash_attention_mma(q, k, v, causal=causal, window=window)
    assert flash_attention_mma.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]


def test_flash_attention_sm90_refuses_what_it_does_not_serve(cuda):
    for q in (torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16, device=cuda),
              torch.zeros(1, 2, 8, 128, device=cuda)):
        with pytest.raises(ValueError):
            flash_attention_sm90(q, q, q)


def test_flash_attention_wrapper_rejects_on_cuda(cuda):
    q = torch.zeros(1, 2, 8, 136, device=cuda)             # d > 128
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 20, device=cuda)              # d % 8 != 0
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 16, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "h2o-danube-3-4b",
                                  "granite-20b", "internlm2-20b",
                                  "olmoe-1b-7b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b", "rwkv6-3b"])
def test_reduced_model_on_the_card_matches_cpu(cuda, arch):
    cfg = reduced(ARCHS[arch])
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 50),
                         generator=torch.Generator().manual_seed(2))
    kinds = [cfg.mixer_kind(i) for i in range(cfg.n_layers)]
    before, scans, wkvs = (flash_attention.launches, rglru_lru.launches,
                           rwkv6_wkv.launches)
    lg, _ = card.forward(toks.to(cuda))
    assert flash_attention.launches == before + sum(
        k in ("attn", "swa") for k in kinds)
    assert rglru_lru.launches == scans + kinds.count("rglru")
    assert rwkv6_wkv.launches == wkvs + kinds.count("rwkv6")
    want, _ = cpu.forward(toks)
    assert float((lg.cpu() - want).abs().max()) < 1e-4
    max_len = cfg.window or 64
    _, cache = card.prefill(toks[:, :44].to(cuda), max_len=max_len)
    for i in range(44, 50):
        lg, cache = card.decode_step(toks[:, i:i + 1].to(cuda), cache, i)
        assert float((lg[:, 0].cpu() - want[:, i]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", DENSE_HEADS)
def test_narrow_head_layout_on_the_card_matches_cpu(cuda, arch):
    """granite-20b's, internlm2-20b's and h2o-danube-3-4b's real head
    layouts at narrow width (``test_torch_dense_layouts.narrow``; float32,
    so K3's mma.sync kernel at GQA groups of 48, 6 and 4 and at d = 120
    under a window) on the card against the CPU: the forward, one K3 launch
    a layer, then prefill and 6 decode steps, danube's 64-slot ring
    wrapping, each within 1e-4."""
    cfg = narrow(ARCHS[arch])
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    t_prompt = prompt_len(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, t_prompt + 6),
                         generator=torch.Generator().manual_seed(2))
    before = flash_attention.launches
    lg, _ = card.forward(toks.to(cuda))
    assert flash_attention.launches == before + cfg.n_layers
    want, _ = cpu.forward(toks)
    assert float((lg.cpu() - want).abs().max()) < 1e-4
    _, cache = card.prefill(toks[:, :t_prompt].to(cuda),
                            max_len=cfg.window or 64)
    for i in range(t_prompt, t_prompt + 6):
        lg, cache = card.decode_step(toks[:, i:i + 1].to(cuda), cache, i)
        assert float((lg[:, 0].cpu() - want[:, i]).abs().max()) < 1e-4


def test_reduced_whisper_on_the_card_matches_cpu(cuda):
    """The encoder-decoder on the card against the CPU: the forward with
    frames (one K3 launch a layer, encoder, self and cross, all mma.sync at
    head_dim 16), then fill_cross_cache and decode."""
    cfg = reduced(ARCHS["whisper-small"])
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    frames = torch.randn(2, cfg.encoder_len, cfg.d_model, generator=g)
    before, mma = flash_attention.launches, flash_attention_mma.launches
    lg, _ = card.forward(toks.to(cuda), frames=frames.to(cuda))
    n_k3 = cfg.encoder_layers + 2 * cfg.n_layers
    assert flash_attention.launches == before + n_k3
    assert flash_attention_mma.launches == mma + n_k3
    want, _ = cpu.forward(toks, frames=frames)
    assert float((lg.cpu() - want).abs().max()) < 1e-4
    cache = card.fill_cross_cache(card.init_cache(2, 32), frames.to(cuda))
    for i in range(20):
        lg, cache = card.decode_step(toks[:, i:i + 1].to(cuda), cache, i)
        assert float((lg[:, 0].cpu() - want[:, i]).abs().max()) < 1e-4


def test_reduced_qwen2_vl_on_the_card_matches_cpu(cuda):
    """M-RoPE over an image's ids and the stubbed embeddings on the card
    against the CPU: the forward with ``embeds``, then prefill and decode
    (text ids past the prompt), each within 1e-4."""
    cfg = reduced(ARCHS["qwen2-vl-7b"])
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 50), generator=g)
    embeds = torch.randn(2, 50, cfg.d_model, generator=g) * 0.125
    pos = torch.from_numpy(image_ids(2, 50, 8, 4))
    before = flash_attention.launches
    lg, _ = card.forward(toks.to(cuda), positions=pos.to(cuda),
                         embeds=embeds.to(cuda))
    assert flash_attention.launches == before + cfg.n_layers
    want, _ = cpu.forward(toks, positions=pos, embeds=embeds)
    assert float((lg.cpu() - want).abs().max()) < 1e-4
    want, _ = cpu.forward(toks, positions=pos)
    _, cache = card.prefill(toks[:, :44].to(cuda), max_len=64,
                            positions=pos[:, :, :44].to(cuda))
    for i in range(44, 50):
        lg, cache = card.decode_step(toks[:, i:i + 1].to(cuda), cache, i)
        assert float((lg[:, 0].cpu() - want[:, i]).abs().max()) < 1e-4


def test_int8_kv_cache_on_the_card_matches_cpu(cuda):
    """A slot's int8 quantization on the card is the CPU's bit for bit on
    the same float32 inputs (an all-zero slot and exact .5 ties among
    them). Decode from an empty int8 cache on the card against the CPU's:
    logits within 1e-4, payloads within one step (the slot's inputs come
    from products that round differently on the two devices)."""
    import dataclasses
    from repro_torch.models.attention import _quantize_slot
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 4, 1, 128, generator=g) * 5
    x[0, 0] = 0.0
    x[0, 1, 0, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    x[0, 1, 0, 6:] = 0.25
    want_q, want_s = _quantize_slot(x)
    got_q, got_s = _quantize_slot(x.to(cuda))
    assert torch.equal(got_q.cpu(), want_q)
    assert torch.equal(got_s.cpu(), want_s)

    cfg = dataclasses.replace(reduced(ARCHS["mistral-nemo-12b"]),
                              kv_quant="int8")
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    c_cpu, c_card = cpu.init_cache(2, 32), card.init_cache(2, 32)
    for i in range(16):
        want, c_cpu = cpu.decode_step(toks[:, i:i + 1], c_cpu, i)
        got, c_card = card.decode_step(toks[:, i:i + 1].to(cuda), c_card, i)
        assert float((got.cpu() - want).abs().max()) < 1e-4
    for lc, lg in zip(c_cpu, c_card):
        for name in ("k", "v"):
            assert lg["kv"][name].dtype == torch.int8
            diff = lg["kv"][name].cpu().int() - lc["kv"][name].int()
            assert int(diff.abs().max()) <= 1
            assert torch.allclose(lg["kv"][f"{name}_scale"].cpu(),
                                  lc["kv"][f"{name}_scale"], rtol=1e-5)


def test_nelder_mead_on_the_card(cuda, monkeypatch):
    """Nelder-Mead on the card: a chunk replayed as a CUDA graph gives the
    eager chunks' bits (x, fun, fe, iterations), also one iteration a
    read; the sphere from 5.0 ends below 1e-6 with the CPU's fe and
    iterations."""
    import importlib
    from repro_torch.objectives import griewank_naive
    from repro_torch.optim import nelder_mead
    mod = importlib.import_module("repro_torch.optim.nelder_mead")
    x0 = torch.full((50,), 141.6, device=cuda)
    graphed = nelder_mead(griewank_naive, x0, max_fe=3001)
    monkeypatch.setattr(mod, "GRAPH_MAX_BYTES", 0)
    for chunk in (64, 1):
        monkeypatch.setattr(mod, "CHUNK", chunk)
        eager = nelder_mead(griewank_naive, x0, max_fe=3001)
        assert torch.equal(graphed.x, eager.x)
        assert (graphed.fun, graphed.fe, graphed.iterations) == \
            (eager.fun, eager.fe, eager.iterations)
    monkeypatch.undo()
    r = nelder_mead(lambda x: torch.sum(x * x),
                    torch.full((2,), 5.0, device=cuda), max_fe=2000)
    rc = nelder_mead(lambda x: torch.sum(x * x), torch.full((2,), 5.0),
                     max_fe=2000)
    assert r.fun < 1e-6 and r.x.device.type == "cuda"
    assert (r.fe, r.iterations) == (rc.fe, rc.iterations)


def _moe_margin(x, router, k) -> float:
    """The least gap between a token's top k+1 router probabilities
    (float64): a route the card and the CPU could order differently."""
    p = torch.softmax(x.reshape(-1, x.shape[-1]).double() @ router.double(),
                      -1).sort(-1, descending=True).values[:, :k + 1]
    return float((p[:, :-1] - p[:, 1:]).min())


@pytest.mark.parametrize("cf", [None, 1.25])
def test_moe_layer_on_the_card_matches_cpu(cuda, cf):
    """The MoE layer (float32, the reduced olmoe's widths) on the card
    against its CPU run: the same routes, drops and positions; outputs
    within 1e-5 of their max, aux within 1e-6. Lossless, and at capacity
    1.25 with dropped slots."""
    from repro_torch.models import moe
    cfg = reduced(ARCHS["olmoe-1b-7b"])
    cpu = Model(cfg, device="cpu").init(0).decoder[0]["moe"]
    card = {n: p.to(cuda) for n, p in cpu.items()}
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    assert _moe_margin(x, cpu["router"], cfg.top_k) > 1e-5
    want, want_aux = moe.moe_apply(cpu, cfg, x, capacity_factor=cf)
    got, got_aux = moe.moe_apply(card, cfg, x.to(cuda), capacity_factor=cf)
    assert float((got.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    tokens = x.reshape(-1, cfg.d_model)
    _, _, idx = moe.route(cpu, cfg, tokens)
    _, _, idx_card = moe.route(card, cfg, tokens.to(cuda))
    assert torch.equal(idx_card.cpu(), idx)
    pos, _ = moe.positions(idx, cfg.n_experts)
    pos_card, _ = moe.positions(idx_card, cfg.n_experts)
    assert torch.equal(pos_card.cpu(), pos)
    dropped = int((pos >= moe.capacity(cfg, tokens.shape[0], cf)).sum())
    assert (dropped > 0) == (cf is not None)


# ---------------------------------------------------------------------------
# the solve engine
# ---------------------------------------------------------------------------
ENGINE_CFG = ABOConfig(samples_per_pass=7, n_passes=4, block_size=256)


@pytest.mark.parametrize("rows", [1, 2, 3, 17, 256])
def test_tile_sum_does_not_depend_on_the_slab(cuda, rows):
    tile, t_idx, pos = GRIEWANK.REDUCE_TILE, 1000, rows // 2
    x = _uniform(tile, 7, cuda)
    want = GRIEWANK._tile_sums(x.view(1, tile), t_idx, 10**9,
                               torch.float32)[0]
    slab = _uniform((rows, tile), rows, cuda)
    slab[pos] = x
    got = GRIEWANK._tile_sums(slab, t_idx - pos, 10**9, torch.float32)[pos]
    assert torch.equal(got, want)


def test_row_aggregates_equal_aggregates_on_the_card(cuda):
    ns = [100, 3 * 4096 + 5, 2**20 + 4096 * 3 + 7]
    rows = torch.zeros((3, 2**20 + 4096 * 8), device=cuda)
    for i, n in enumerate(ns):
        rows[i, :n] = _uniform(n, n, cuda)
    got = GRIEWANK.row_aggregates(rows, torch.tensor(ns, device=cuda))
    for i, n in enumerate(ns):
        assert torch.equal(got[i], GRIEWANK.aggregates(rows[i, :n].clone(), n))


def _engine_specs():
    specs = [JobSpec(name, n, ENGINE_CFG, seed=i) for i, (name, n) in
             enumerate([("griewank", 3000), ("sphere", 1000),
                        ("rastrigin", 5000), ("shifted_sphere", 700),
                        ("griewank", 100), ("sphere", 4096 * 3 + 5),
                        ("rastrigin", 9000), ("griewank", 257)])]
    specs.append(JobSpec("sphere", 2**20 + 4096 * 60 + 13,
                         ABOConfig(samples_per_pass=7, n_passes=2), seed=10))
    specs.append(JobSpec("griewank", 600, ENGINE_CFG,
                         x0=tuple(float(v) for v in range(-300, 300))))
    return specs


def test_engine_matches_abo_minimize_bit_for_bit(cuda):
    specs = _engine_specs()
    eng = SolveEngine(lanes=3, device=cuda)
    ids = eng.submit_many(specs)
    assert eng.run() == len(specs)
    for spec, jid in zip(specs, ids):
        got = eng.result(jid)
        solo = abo_minimize(OBJECTIVES[spec.objective], spec.n,
                            config=spec.config, seed=spec.seed, x0=spec.x0,
                            device=cuda)
        assert got.fun == solo.fun, (spec, got.fun, solo.fun)
        assert torch.equal(got.x, solo.x.cpu())
        assert torch.equal(got.history, solo.history.cpu())


def test_sync_guard_catches_syncs_on_the_card(cuda):
    t = torch.ones(4, device=cuda)
    with pytest.raises(HostSyncError):
        with sync_guard():
            t.sum().item()
    with pytest.raises(RuntimeError):                # CUDA's own check
        with sync_guard():
            torch.nonzero(t)
    torch.nonzero(t)                                 # restored afterwards


def test_engine_steady_state_steps_do_not_sync(cuda):
    eng = SolveEngine(lanes=3, max_fuse=1, device=cuda)
    ids = eng.submit_many(_engine_specs()[:3])
    eng.step()                                       # refill, plan, pass 1
    with sync_guard():
        eng.step()                                   # passes 2 and 3: no
        eng.step()                                   # refill, no harvest
    assert eng.run() == 3
    sane = SolveEngine(lanes=3, sanitize=True, device=cuda)
    sane_ids = sane.submit_many(_engine_specs()[:3])
    assert sane.run() == 3                           # every step guarded
    for a, b in zip(ids, sane_ids):
        assert eng.result(a).fun == sane.result(b).fun


def test_engine_snapshot_resumes_bit_for_bit_sanitized(cuda, tmp_path):
    specs = _engine_specs()[:6]
    ref = SolveEngine(lanes=3, device=cuda)
    ref_ids = ref.submit_many(specs)
    ref.run()
    eng = SolveEngine(lanes=3, max_fuse=1, checkpoint_dir=tmp_path,
                      sanitize=True, device=cuda)
    ids = eng.submit_many(specs)
    eng.snapshot()
    eng.step()
    eng.step()                                       # snapshot at step 2
    del eng
    res = SolveEngine.resume(tmp_path, sanitize=True, device=cuda)
    assert res.pending() and res.sanitize
    res.run()
    for a, b in zip(ref_ids, ids):
        want, got = ref.result(a), res.result(b)
        assert got.fun == want.fun
        assert torch.equal(got.history, want.history)
        if res.jobs[b].x is not None:
            assert torch.equal(got.x, want.x)


def test_engine_float64_job_equals_abo_minimize(cuda):
    cfg = ABOConfig(samples_per_pass=12, n_passes=3, block_size=256)
    specs = [JobSpec("griewank", 3000, cfg, seed=3),
             JobSpec("rastrigin", 1500, cfg, seed=4)]
    eng = SolveEngine(lanes=2, dtype=torch.float64, device=cuda)
    ids = eng.submit_many(specs)
    eng.run()
    for spec, jid in zip(specs, ids):
        got = eng.result(jid)
        solo = abo_minimize(OBJECTIVES[spec.objective], spec.n, config=cfg,
                            seed=spec.seed, dtype=torch.float64, device=cuda)
        assert got.history.dtype == torch.float64
        assert got.fun == solo.fun
        assert torch.equal(got.x, solo.x.cpu())
        assert torch.equal(got.history, solo.history.cpu())


def test_checkpoint_host_copy_of_a_card_tensor(cuda, tmp_path):
    t = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    want = t.cpu().numpy().copy()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"t": t}, blocking=False)
    t.mul_(-1)                                       # in place, after the save
    mgr.wait()
    out = mgr.restore(1, {"t": t})["t"]
    assert out.device.type == "cpu"
    assert (out.numpy() == want).all()
    back = mgr.restore(1, {"t": t}, device=cuda)["t"]
    assert back.device.type == "cuda" and torch.equal(back.cpu(), out)


@pytest.mark.parametrize("sanitize", [False, True])
def test_http_front_door_on_the_card_equals_abo_minimize(cuda, sanitize):
    """An in-process Frontend over an engine on the card, its stepper on
    its own thread: three jobs over HTTP, each fun, x and history bit for
    bit abo_minimize on the card. Sanitized, CUDA's sync debug mode is
    process-wide while the stepper steps; the handlers' threads must not
    trip it."""
    import http.client
    import json
    import threading

    from repro_torch.engine import SolveService
    from repro_torch.serve.frontend import Frontend, FrontendConfig

    def req(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    cfg = {"samples_per_pass": 12, "n_passes": 3, "block_size": 256}
    plan = [("griewank", 3000, 0), ("sphere", 4096 * 3 + 5, 1),
            ("rastrigin", 700, 2)]
    fe = Frontend(SolveService(lanes=2, sanitize=sanitize, device=cuda), 0,
                  FrontendConfig(poll_s=0.005))
    server = threading.Thread(target=fe.httpd.serve_forever, daemon=True)
    server.start()
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    try:
        ids = []
        for name, n, seed in plan:
            st, out = req(port, "POST", "/submit", json.dumps(
                {"objective": name, "n": n, "seed": seed, "config": cfg}))
            assert st == 200, out
            ids.append(out["job_id"])
        for jid, (name, n, seed) in zip(ids, plan):
            st, out = req(port, "GET", f"/result?job_id={jid}&wait=60")
            assert st == 200 and out["status"] == "done", out
            solo = abo_minimize(OBJECTIVES[name], n, config=ABOConfig(**cfg),
                                seed=seed, device=cuda)
            assert out["fun"] == solo.fun
            assert out["history"] == solo.history.cpu().tolist()
            assert torch.equal(torch.tensor(out["x"], dtype=torch.float64),
                               solo.x.cpu().double())
    finally:
        fe.begin_shutdown("test done")
        fe.finalize()
        server.join(timeout=30)


# ---------------------------------------------------------------------------
# the training path: K3-bwd, K3's lse, P
# ---------------------------------------------------------------------------
def _model_layout(t):
    """t as a (b, h, s, d) view of a (b, s, h, d) buffer, the layout of the
    model's projections."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _grad_row_err(got, want):
    """Max over rows of the row's max |got - want| over the row's max
    |want|, floored at BWD_ROW_FLOOR of the tensor's max |want| (a
    gradient row can vanish: causal query row 0's dQ is exactly 0; and a
    small dQ row is a cancellation that bf16 rounds differently in the
    kernel and the plain version)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    w = want.float().abs()
    den = w.amax(-1).clamp_min(BWD_ROW_FLOOR * float(w.max()))
    return float((diff / den).max())


def _bwd_case(shape, dev, seed=0):
    """q, k, v (requiring grad, the model's layout), dO, causal, window and
    dO's row stride (None: contiguous)."""
    b, hq, hkv, sq, sk, d, causal, window, dtype = shape[:9]
    stride = shape[9] if len(shape) > 9 else None
    q, k, v = (_model_layout(t).requires_grad_(True)
               for t in _qkv((b, hq, hkv, sq, sk, d), dtype, dev, seed))
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    dout = torch.randn((b, hq, sq, stride or d), generator=g,
                       device=dev).to(dtype)[..., :d]
    return q, k, v, dout, causal, window, stride


BWD_WRAPPERS = (flash_attention_bwd_sm90, flash_attention_bwd_sm90_d64,
                flash_attention_bwd_sm90_d256, flash_attention_bwd_mma)


def _bwd_kernel_for(dtype, d, stride):
    """The backward wrapper a case must launch: for bf16 with 16-byte
    strides the Hopper one of its head dim (120 or 128, 64, 256), the
    mma.sync one else."""
    if dtype == torch.bfloat16 and (stride is None or stride % 8 == 0):
        for dims, w in (((120, 128), flash_attention_bwd_sm90),
                        ((64,), flash_attention_bwd_sm90_d64),
                        ((256,), flash_attention_bwd_sm90_d256)):
            if d in dims:
                return w
    return flash_attention_bwd_mma


def _bwd_grads(q, k, v, dout, causal, window, stride):
    """dQ, dK, dV through ``flash_attention``'s gradient, or, where dO has
    its own row stride, through ``flash_attention_bwd`` on the forward's O
    and lse (autograd hands the Function a dO of its choosing)."""
    if stride is None:
        return torch.autograd.grad(
            flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
    from repro_torch.kernels.flash_attention import ops
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.no_grad():
        o = ops._KERNELS[choose_kernel(q, k, v)](q, k, v, causal=causal,
                                                 window=window, lse=lse)
    return flash_attention_bwd(q, k, v, o, dout, lse, causal=causal,
                               window=window)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(cuda, shape):
    q, k, v, dout, causal, window, stride = _bwd_case(shape, cuda)
    dtype = shape[8]
    kernel = _bwd_kernel_for(dtype, q.shape[-1], stride)
    before = [w.launches for w in (flash_attention_bwd,) + BWD_WRAPPERS]
    got = _bwd_grads(q, k, v, dout, causal, window, stride)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(
        (flash_attention_bwd,) + BWD_WRAPPERS, before)] == [1] + [
            int(w is kernel) for w in BWD_WRAPPERS]
    want = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                     window=window)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and a.dtype == dtype
        assert bool(torch.isfinite(a).all())
        err = float((a.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err < BWD_TOL[dtype], (name, err)
        assert _grad_row_err(a, w) < BWD_ROW_TOL[dtype], name
    again = _bwd_grads(q, k, v, dout, causal, window, stride)
    for a, b in zip(got, again):
        assert torch.equal(a, b)           # no atomics: the same bits


@pytest.mark.parametrize("shape", [(8, 32, 8, 512, 512, 128, True, None),
                                   (1, 32, 8, 333, 333, 120, True, 96),
                                   (2, 4, 2, 100, 300, 128, False, None)])
def test_flash_attention_bwd_sm90_gives_the_same_bits_twice(cuda, shape):
    """The Hopper K3-bwd sums in a fixed order (no atomics): two calls on
    the same inputs give the same bits, one launch each."""
    q, k, v, dout, causal, window, _ = _bwd_case(
        shape + (torch.bfloat16,), cuda, seed=5)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    with torch.no_grad():
        o = flash_attention_sm90(q, k, v, causal=causal, window=window,
                                 lse=lse)
        before = flash_attention_bwd_sm90.launches
        first = flash_attention_bwd_sm90(q, k, v, o, dout, lse,
                                         causal=causal, window=window)
        second = flash_attention_bwd_sm90(q, k, v, o, dout, lse,
                                          causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_sm90.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("shape", [(4, 12, 12, 1500, 1500, 64, False, None),
                                   (4, 12, 12, 448, 448, 64, True, None),
                                   (2, 4, 2, 200, 200, 64, True, 96)])
def test_flash_attention_bwd_sm90_d64_gives_the_same_bits_twice(cuda, shape):
    """The Hopper K3-bwd at head_dim 64 sums in a fixed order: two calls
    on the same inputs give the same bits, one launch each."""
    q, k, v, dout, causal, window, _ = _bwd_case(
        shape + (torch.bfloat16,), cuda, seed=5)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    with torch.no_grad():
        o = flash_attention_sm90_d64(q, k, v, causal=causal, window=window,
                                     lse=lse)
        before = flash_attention_bwd_sm90_d64.launches
        first = flash_attention_bwd_sm90_d64(q, k, v, o, dout, lse,
                                             causal=causal, window=window)
        second = flash_attention_bwd_sm90_d64(q, k, v, o, dout, lse,
                                              causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_sm90_d64.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("shape", [(1, 10, 1, 4096, 4096, 256, True, 2048),
                                   (2, 8, 2, 640, 640, 256, True, 300)])
def test_flash_attention_bwd_sm90_d256_gives_the_same_bits_twice(cuda,
                                                                 shape):
    """The Hopper K3-bwd at head_dim 256 (its partials added in split
    order) gives the same bits on a repeat, one launch each."""
    q, k, v, dout, causal, window, _ = _bwd_case(
        shape + (torch.bfloat16,), cuda, seed=5)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    with torch.no_grad():
        o = flash_attention_sm90_d256(q, k, v, causal=causal, window=window,
                                      lse=lse)
        before = flash_attention_bwd_sm90_d256.launches
        first = flash_attention_bwd_sm90_d256(q, k, v, o, dout, lse,
                                              causal=causal, window=window)
        second = flash_attention_bwd_sm90_d256(q, k, v, o, dout, lse,
                                               causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_sm90_d256.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("wrapper,d", [(flash_attention_bwd_sm90_d64, 64),
                                       (flash_attention_bwd_sm90_d256, 256)])
def test_flash_attention_bwd_hopper_refuses_what_it_does_not_serve(
        cuda, wrapper, d):
    """The head_dim 64 and 256 Hopper backward wrappers raise on another
    head dim, on float32, and on a dO whose rows are off 16 bytes (the
    mma.sync kernel's inputs), launching nothing."""
    name = wrapper.__name__
    before = wrapper.launches
    q, k, v, dout, _, _, _ = _bwd_case(
        (1, 4, 2, 64, 64, 128, True, None, torch.bfloat16), cuda)
    lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match=f"{name} takes"):
        wrapper(q, k, v, dout, dout, lse)
    q, k, v, dout, _, _, _ = _bwd_case(
        (1, 4, 2, 64, 64, d, True, None, torch.float32), cuda)
    with pytest.raises(ValueError, match=f"{name} takes"):
        wrapper(q, k, v, dout, dout, lse)
    q, k, v, dout, _, _, _ = _bwd_case(
        (1, 4, 2, 64, 64, d, True, None, torch.bfloat16, d + 4), cuda)
    with pytest.raises(ValueError, match=f"{name} takes"):
        wrapper(q, k, v, q.detach(), dout, lse)
    assert wrapper.launches == before


def test_flash_attention_bwd_sm90_refuses_what_it_does_not_serve(cuda):
    q, k, v, dout, _, _, _ = _bwd_case(
        (1, 4, 2, 64, 64, 64, True, None, torch.bfloat16), cuda)
    lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="flash_attention_bwd_sm90 takes"):
        flash_attention_bwd_sm90(q, k, v, dout, dout, lse)
    q, k, v, dout, _, _, _ = _bwd_case(
        (1, 4, 2, 64, 64, 128, True, None, torch.bfloat16, 132), cuda)
    lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="flash_attention_bwd_sm90 takes"):
        flash_attention_bwd_sm90(q, k, v, q.detach(), dout, lse)


@pytest.mark.parametrize("shape", [(2, 8, 2, 256, 256, 128, True, None),
                                   (1, 4, 2, 200, 200, 64, True, None),
                                   (1, 32, 8, 333, 333, 120, True, 96),
                                   (2, 4, 2, 100, 300, 16, False, None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_lse_keeps_the_output_bits(cuda, shape, dtype):
    """Both forward kernels give the same output with the log-sum-exp on,
    and the lse is the plain logsumexp of the masked, scaled scores."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, dtype, cuda)
    kernel = globals()[choose_kernel(q, k, v)]
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    plain = kernel(q, k, v, causal=causal, window=window)
    with_lse = kernel(q, k, v, causal=causal, window=window, lse=lse)
    assert torch.equal(plain, with_lse)
    kk = k.float().repeat_interleave(q.shape[1] // k.shape[1], 1)
    s = q.float() @ kk.transpose(-1, -2) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[2], device=cuda)[:, None]
    kp = torch.arange(k.shape[2], device=cuda)[None]
    keep = torch.ones_like(s, dtype=torch.bool)
    if causal:
        keep &= qp >= kp
    if window:
        keep &= (qp - kp) < window
    want = torch.logsumexp(torch.where(keep, s, -torch.inf), -1)
    assert float((lse - want).abs().max()) < 1e-5


def test_flash_attention_grad_raises_where_the_backward_does_not_serve(cuda):
    q, k, v = (t.requires_grad_(True) for t in _qkv(
        (1, 2, 2, 64, 64, 136, True, None), torch.float32, cuda))
    with pytest.raises(ValueError, match="backward kernel"):
        flash_attention(q, k, v)
    q, k, v = (t.requires_grad_(True) for t in _qkv(
        (1, 2, 2, 64, 64, 64, True, None), torch.float16, cuda))
    with pytest.raises(ValueError, match="backward kernel"):
        flash_attention(q, k, v)
    with torch.no_grad():                    # no gradient: the forward only
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            flash_attention(q, k, v)


@pytest.mark.parametrize("n,offset,dtype", [
    (1_000_003, 0, torch.bfloat16),            # ragged
    (777_777, 3 * 2**31 + 5, torch.float32),   # a stacked leaf's offset
    (5 * 2**20 + 3, 2**32 - 1000, torch.bfloat16),   # the counter's high word
    (4096, 7 * 4096, torch.float32)])
def test_abo_zo_perturb_matches_plain(cuda, n, offset, dtype):
    g = torch.Generator(device=cuda).manual_seed(n)
    src = torch.randn(n, generator=g, device=cuda).to(dtype)
    key = (123456789, 987654321)
    before = abo_zo_perturb.launches
    got = abo_zo_perturb(torch.empty_like(src), src, key, offset, 0.0123)
    assert abo_zo_perturb.launches == before + 1
    want = abo_zo_perturb_plain(torch.empty_like(src), src, key, offset,
                                0.0123)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))
    abo_zo_perturb(src, src, key, offset, 0.0123)              # in place
    assert torch.equal(src.view(view), want.view(view))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_gradient_reaches_qkv_on_the_card(cuda, dtype):
    """The attention's gradient on the card is K3-bwd's: the projections'
    gradients are nonzero and equal to those with the plain attention
    (the silent zero that a forward-only kernel would leave)."""
    import dataclasses
    from repro_torch.models import attention
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    if dtype == "bfloat16":     # head_dim 128: the Hopper forward kernel
        cfg = dataclasses.replace(cfg, dtype="bfloat16", head_dim=128,
                                  d_model=256)
    model = Model(cfg, device=cuda).init(0).requires_grad_(True)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 129),
                                     generator=g, device=cuda)}

    def grads():
        for p in model.parameters():
            p.grad = None
        model.loss(batch, remat=True)[0].backward()
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    kernel = (flash_attention_bwd_sm90 if dtype == "bfloat16"
              else flash_attention_bwd_mma)
    before = (flash_attention_bwd.launches, kernel.launches)
    got = grads()
    assert (flash_attention_bwd.launches, kernel.launches) == (
        before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    saved = attention.flash_attention
    attention.flash_attention = flash_attention_plain
    try:
        want = grads()
    finally:
        attention.flash_attention = saved
    tol = MODEL_GRAD_TOL[dtype]
    for n in got:
        if n.split(".")[-1] in ("wq", "wk", "wv"):
            assert float(got[n].abs().max()) > 0, n
        err = float((got[n] - want[n]).abs().max() / want[n].abs().max())
        assert err < tol, (n, err)


def test_reduced_bf16_model_takes_an_adamw_step_through_the_hopper_bwd(cuda):
    """A reduced bf16 model at head_dim 128 takes one AdamW step on the
    card with its attention's gradient from the Hopper K3-bwd in every
    layer (the mma.sync one never), and the step moves every projection."""
    import dataclasses
    from repro_torch.train import steps
    cfg = dataclasses.replace(reduced(ARCHS["mistral-nemo-12b"]),
                              dtype="bfloat16", head_dim=128, d_model=256)
    model = Model(cfg, device=cuda).init(0).requires_grad_(True)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 129),
                                     generator=g, device=cuda)}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = steps.make_train_step(model, optimizer="adamw", remat=True)
    state = steps.init_opt_state(model)
    before = (flash_attention_bwd_sm90.launches,
              flash_attention_bwd_mma.launches, flash_attention_mma.launches)
    state, met = step(state, batch)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_sm90.launches,
            flash_attention_bwd_mma.launches,
            flash_attention_mma.launches) == (before[0] + cfg.n_layers,
                                              before[1], before[2])
    assert torch.isfinite(torch.as_tensor(float(met["loss"])))
    for n, p in model.named_parameters():
        if n.split(".")[-1] in ("wq", "wk", "wv"):
            assert not torch.equal(p.detach(), start[n]), n


# ---------------------------------------------------------------------------
# whisper-small: K3 at head_dim 64
# ---------------------------------------------------------------------------
def _d64_held(got, q, k, v, causal, window):
    """got against the plain version: max abs within ATTN_TOL; per row
    within ATTN_ROW_TOL of the bf16 plain version, or, where every row sees
    more than 1024 keys (non-causal, sk > 1024: the bf16 plain version's
    rounded scores move such rows by ~0.02 of their max), of the plain
    version on float64 copies of the inputs and no further from it than
    the bf16 plain version is."""
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    if causal or k.shape[2] <= 1024:
        assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]
        return
    exact = flash_attention_plain(q.double(), k.double(), v.double(),
                                  causal=causal, window=window)
    row = _row_rel_err(got, exact)
    assert row < ATTN_ROW_TOL[torch.bfloat16], row
    assert row <= _row_rel_err(want, exact)


@pytest.mark.parametrize("shape", D64_SHAPES)
def test_flash_attention_sm90_d64_matches_plain(cuda, shape):
    """The Hopper kernel at head_dim 64 through the op's routing; only its
    own launch count moves; two calls give the same bits (the key split's
    merge has a fixed order). The output's memory is left NaN beforehand,
    so a row never written shows."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    assert choose_kernel(q, k, v) == "flash_attention_sm90_d64"
    wrappers = (flash_attention_sm90_d64, flash_attention_sm90,
                flash_attention_sm90_d256, flash_attention_mma)
    counts = [w.launches for w in wrappers]
    torch.cuda.empty_cache()
    torch.full_like(q, float("nan"))     # freed at once, its block cached
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [counts[0] + 1] + counts[1:]
    _d64_held(got, q, k, v, causal, window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("shape", D64_SHAPES)
def test_flash_attention_mma_still_matches_plain_at_d64_shapes(cuda, shape):
    """The mma.sync kernel, called directly, still agrees at the bf16
    head_dim 64 shapes the op now sends to the Hopper kernel."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    before = flash_attention_mma.launches
    got = flash_attention_mma(q, k, v, causal=causal, window=window)
    assert flash_attention_mma.launches == before + 1
    _d64_held(got, q, k, v, causal, window)


@pytest.mark.parametrize("sq,sk,window", [(300, 300, 100), (300, 2000, None),
                                          (448, 1500, None)])
def test_flash_attention_sm90_d64_strided_view_and_lse(cuda, sq, sk, window):
    """(b, t, h, d) projections read through their (b, h, t, d) transposes,
    as the model passes them (causal with a window, and non-causal with a
    key split); the log-sum-exp moves no output bit and is the plain
    logsumexp of the masked, scaled scores."""
    b, hq, hkv, d = 2, 4, 2, 64
    causal = window is not None
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda)
    k, v = [torch.randn(b, sk, hkv, d, generator=g, device=cuda)
            for _ in range(2)]
    q, k, v = [t.to(torch.bfloat16).transpose(1, 2) for t in (q, k, v)]
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=cuda)
    got = flash_attention_sm90_d64(q, k, v, causal=causal, window=window)
    with_lse = flash_attention_sm90_d64(q, k, v, causal=causal,
                                        window=window, lse=lse)
    assert torch.equal(got, with_lse)
    _d64_held(got, q, k, v, causal, window)
    s = (q.float() @ k.float().repeat_interleave(hq // hkv, 1)
         .transpose(-1, -2) * d ** -0.5)
    qp = torch.arange(sq, device=cuda)[:, None]
    kp = torch.arange(sk, device=cuda)[None]
    keep = torch.ones_like(s, dtype=torch.bool)
    if causal:
        keep &= (qp >= kp) & ((qp - kp) < window)
    want_lse = torch.logsumexp(torch.where(keep, s, -torch.inf), -1)
    assert float((lse - want_lse).abs().max()) < 1e-5


@pytest.mark.parametrize("shape", [s for s in BWD_SHAPES
                                   if s[5] == 64 and s[8] == torch.bfloat16])
def test_flash_attention_d64_forward_feeds_the_mma_backward(cuda, shape):
    """A gradient through K3 in bf16 at head_dim 64: the forward is the
    Hopper d = 64 kernel, whose lse the Hopper d = 64 backward reads (the
    mma.sync backward did before it, hence the name), or, where dO's rows
    are off 16 bytes, the mma.sync backward; dQ, dK and dV within BWD_TOL
    and BWD_ROW_TOL of autograd through the plain attention."""
    q, k, v, dout, causal, window, stride = _bwd_case(shape, cuda)
    assert choose_kernel(q, k, v) == "flash_attention_sm90_d64"
    bwd = _bwd_kernel_for(torch.bfloat16, 64, stride)
    counted = (flash_attention_sm90_d64, flash_attention_mma) + BWD_WRAPPERS
    before = [w.launches for w in counted]
    got = _bwd_grads(q, k, v, dout, causal, window, stride)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(counted, before)] == [1, 0] + [
        int(w is bwd) for w in BWD_WRAPPERS]
    want = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                     window=window)
    for name, a, w in zip("qkv", got, want):
        assert bool(torch.isfinite(a).all())
        err = float((a.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err < BWD_TOL[torch.bfloat16], (name, err)
        assert _grad_row_err(a, w) < BWD_ROW_TOL[torch.bfloat16], name


def test_flash_attention_sm90_d64_refuses_what_it_does_not_serve(cuda):
    """float32 and unaligned bf16 at head_dim 64 go to the mma.sync kernel;
    the Hopper d = 64 wrapper raises on them and on other head dims."""
    f = torch.zeros(1, 2, 8, 64, device=cuda)
    off = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(1, 2, 8, 64)
    wide = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16, device=cuda)
    for q in (f, off):
        assert choose_kernel(q, q, q) == "flash_attention_mma"
    for q in (f, off, wide):
        with pytest.raises(ValueError,
                           match="flash_attention_sm90_d64 takes"):
            flash_attention_sm90_d64(q, q, q)


# ---------------------------------------------------------------------------
# recurrentgemma-2b: K3 at head_dim 256 and S
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", D256_SHAPES)
def test_flash_attention_sm90_d256_matches_plain(cuda, shape):
    """The Hopper kernel at head_dim 256 through the op's routing; only its
    own launch count moves; two calls give the same bits. The output's
    memory is left NaN beforehand, so a tile the walk skips shows."""
    causal, window = shape[6], shape[7]
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    assert choose_kernel(q, k, v) == "flash_attention_sm90_d256"
    counts = [w.launches for w in (flash_attention_sm90_d256,
                                   flash_attention_sm90, flash_attention_mma)]
    torch.cuda.empty_cache()
    torch.full_like(q, float("nan"))     # freed at once, its block cached
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert [w.launches for w in (flash_attention_sm90_d256,
                                 flash_attention_sm90, flash_attention_mma)] \
        == [counts[0] + 1, counts[1], counts[2]]
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]
    again = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_flash_attention_sm90_d256_strided_view_and_lse(cuda):
    """(b, t, h, d) projections read through their (b, h, t, d) transposes,
    as the model passes them; the log-sum-exp moves no output bit and is the
    plain logsumexp of the masked, scaled scores."""
    b, t, hq, hkv, d, window = 2, 300, 4, 1, 256, 100
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = [torch.randn(b, t, h, d, generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv)]
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=cuda)
    got = flash_attention_sm90_d256(q, k, v, causal=True, window=window)
    with_lse = flash_attention_sm90_d256(q, k, v, causal=True, window=window,
                                         lse=lse)
    assert torch.equal(got, with_lse)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert float((got.float() - want.float()).abs().max()) < \
        ATTN_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < ATTN_ROW_TOL[torch.bfloat16]
    s = q.float() @ k.float().transpose(-1, -2) * d ** -0.5
    qp = torch.arange(t, device=cuda)[:, None]
    kp = torch.arange(t, device=cuda)[None]
    keep = (qp >= kp) & ((qp - kp) < window)
    want_lse = torch.logsumexp(torch.where(keep, s, -torch.inf), -1)
    assert float((lse - want_lse).abs().max()) < 1e-5


def test_flash_attention_at_d256_refuses_what_no_kernel_serves(cuda):
    """float32 at head_dim 256 and unaligned bf16 there have no kernel: the
    op raises, with no fallback."""
    q = torch.zeros(1, 2, 8, 256, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    buf = torch.zeros(2 * 8 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    off = buf[1:].view(1, 2, 8, 256)              # 2-byte-aligned pointer
    assert choose_kernel(off, off, off) == "flash_attention_mma"
    with pytest.raises(ValueError):
        flash_attention(off, off, off)
    with pytest.raises(ValueError, match="flash_attention_sm90_d256 takes"):
        flash_attention_sm90_d256(off, off, off)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_rglru_scan_matches_plain_bit_for_bit(cuda, shape):
    """S's recurrence over long memory, float32: the recurrence gate's
    products held below -4, so that r is small and a lies near 1, and h
    carries each step far; the same bits as the plain version (h and the
    last h) and on a repeat; one launch a call."""
    u, xi, _, lam = _lru_inputs(shape, torch.float32, cuda, sum(shape))
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    xr = -4.0 - 2.0 * torch.rand(shape, generator=g, device=cuda)
    before = rglru_lru.launches
    got, last = rglru_lru(u, xi, xr, lam)
    again, last2 = rglru_lru(u, xi, xr, lam)
    torch.cuda.synchronize()
    assert rglru_lru.launches == before + 2
    want, want_last = rglru_lru_ref(u, xi, xr, lam)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(last.view(torch.int32), want_last.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(last.view(torch.int32), last2.view(torch.int32))


def _lru_inputs(shape, dtype, device, seed):
    """u, xi, xr at the model's scale (N(0, 1) rounded to dtype) and Λ from
    the model's init."""
    from repro_torch.models.rglru import log_lambda_init
    g = torch.Generator(device=device).manual_seed(seed)
    u, xi, xr = (torch.randn(shape, generator=g, device=device).to(dtype)
                 for _ in range(3))
    return u, xi, xr, log_lambda_init(shape[2], device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", LRU_SHAPES)
def test_rglru_lru_matches_plain_bit_for_bit(cuda, shape, dtype):
    """S computes the gates and the recurrence in its plain version's order
    with one rounding an operation: the same bits as the plain version's
    torch ops on the card (h and the last h), the same bits on a repeat;
    one launch a call."""
    u, xi, xr, lam = _lru_inputs(shape, dtype, cuda, sum(shape))
    before = rglru_lru.launches
    h, last = rglru_lru(u, xi, xr, lam)
    h2, last2 = rglru_lru(u, xi, xr, lam)
    torch.cuda.synchronize()
    assert rglru_lru.launches == before + 2
    want, want_last = rglru_lru_ref(u, xi, xr, lam)
    assert h.dtype == dtype and last.dtype == torch.float32
    assert torch.equal(h, want) and torch.equal(last, want_last)
    assert torch.equal(h, h2) and torch.equal(last, last2)
    assert bool(torch.isfinite(h).all())


def test_rglru_lru_shortcuts_hold_on_every_input(cuda):
    """S's bf16 sigmoid rule equals torch.sigmoid on all 65536 bf16 inputs
    and its square root __fsqrt_rn on every float in [1e-12, 1]."""
    assert shortcut_mismatches(cuda) == {"sigmoid_bf16": 0, "sqrt": 0}


def test_rglru_lru_refuses_what_it_does_not_serve(cuda):
    u, xi, xr, lam = _lru_inputs((1, 16, 16), torch.bfloat16, cuda, 1)
    before = rglru_lru_bwd.launches          # a gradient is S-bwd's now
    h, _ = rglru_lru(u, xi, xr, lam.clone().requires_grad_(True))
    h.float().sum().backward()
    assert rglru_lru_bwd.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        rglru_lru(*(x.transpose(1, 2) for x in (u, xi, xr)), lam)
    with pytest.raises(ValueError, match="one type"):
        rglru_lru(u.half(), xi.half(), xr.half(), lam)
    with pytest.raises(ValueError, match="one shape"):
        rglru_lru(u, xi, xr[:, 1:], lam)
    odd = _lru_inputs((1, 8, 12), torch.bfloat16, cuda, 2)   # 12 % 8 != 0
    with pytest.raises(ValueError, match="groups of 8"):
        rglru_lru(*odd)
    off = torch.zeros(16 * 16 + 4, dtype=torch.bfloat16,
                      device=cuda)[4:].view(1, 16, 16)   # 8-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        rglru_lru(off, xi, xr, lam)
    with pytest.raises(ValueError):
        rglru_lru(u, xi, xr, lam[1:])


def test_rglru_scan_refuses_what_it_does_not_serve(cuda):
    """float32 as bf16: no stride, channels in groups of 4 (16 bytes),
    16-byte aligned rows; no fallback. A gradient is S-bwd's."""
    u, xi, xr, lam = _lru_inputs((1, 8, 4), torch.float32, cuda, 4)
    before = rglru_lru_bwd.launches
    h, _ = rglru_lru(u.clone().requires_grad_(True), xi, xr, lam)
    h.sum().backward()
    assert rglru_lru_bwd.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        rglru_lru(*(x.transpose(1, 2) for x in (u, xi, xr)), lam[:1].expand(8))
    odd = _lru_inputs((2, 33, 10), torch.float32, cuda, 3)   # 10 % 4 != 0
    with pytest.raises(ValueError, match="groups of 4"):
        rglru_lru(*odd)
    off = torch.zeros(8 * 4 + 2, device=cuda)[2:].view(1, 8, 4)  # 8 bytes
    with pytest.raises(ValueError, match="aligned"):
        rglru_lru(off, xi, xr, lam)


def _wkv_inputs(shape, dtype, device, seed, shift=0.0):
    """r, k, v N(0, 1) in dtype; logw = -exp(lw) with lw spread over the
    channels as rwkv6's decay base (-6 to -0.5) plus ``shift`` plus N(0,
    0.25): decays from 0.37 to 0.9975 at shift 0, so that some heads carry
    S far; u N(0, 0.25)."""
    b, t, h, hd = shape
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((b, t, h, hd), generator=g, device=device).to(
        dtype) for _ in range(3))
    base = shift + torch.linspace(-6.0, -0.5, h * hd, device=device).view(
        h, hd)
    lw = base + 0.5 * torch.randn((b, t, h, hd), generator=g, device=device)
    u = 0.5 * torch.randn((h, hd), generator=g, device=device)
    return r, k, v, -torch.exp(lw), u


def _rel(got, want, dims):
    """max |got - want| over max |want|, over ``dims`` (a head's
    elements)."""
    return ((got - want).abs().amax(dims)
            / want.abs().amax(dims).clamp_min(1e-30))


@pytest.mark.parametrize("case", WKV_SHAPES)
def test_rwkv6_wkv_matches_plain(cuda, case):
    """W against its plain version on the card: y and the last state
    within WKV_TOL of the plain version's max |value|, overall and for
    each head; the same bits on a repeat; one launch a call."""
    *shape, dtype, shift = case
    r, k, v, logw, u = _wkv_inputs(tuple(shape), dtype, cuda, sum(shape),
                                   shift)
    before = rwkv6_wkv.launches
    y, S = rwkv6_wkv(r, k, v, logw, u)
    y2, S2 = rwkv6_wkv(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == before + 2
    assert y.dtype == S.dtype == torch.float32
    assert tuple(S.shape) == (shape[0], shape[2], shape[3], shape[3])
    assert torch.equal(y, y2) and torch.equal(S, S2)
    want_y, want_s = wkv_ref(r, k, v, logw, u)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    assert float(_rel(y, want_y, (0, 1, 2, 3))) <= WKV_TOL
    assert float(_rel(S, want_s, (0, 1, 2, 3))) <= WKV_TOL
    assert float(_rel(y, want_y, (0, 1, 3)).max()) <= WKV_TOL
    assert float(_rel(S, want_s, (0, 2, 3)).max()) <= WKV_TOL


def test_rwkv6_wkv_refuses_what_it_does_not_serve(cuda):
    """No head size but 16 and 64, no stride, no start off 16 bytes; no
    fallback. A gradient is W-bwd's."""
    r, k, v, logw, u = _wkv_inputs((1, 8, 2, 32), torch.bfloat16, cuda, 1)
    with pytest.raises(ValueError, match="head sizes"):
        rwkv6_wkv(r, k, v, logw, u)
    r, k, v, logw, u = _wkv_inputs((1, 8, 2, 64), torch.bfloat16, cuda, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_wkv(*(x.transpose(1, 2).contiguous().transpose(1, 2)
                    for x in (r, k, v, logw)), u)
    before = rwkv6_wkv_bwd.launches         # a gradient is W-bwd's now
    y, _ = rwkv6_wkv(r, k, v, logw, u.clone().requires_grad_(True))
    y.sum().backward()
    y, _ = rwkv6_wkv(r.float().requires_grad_(True), k.float(), v.float(),
                     logw, u)
    y.sum().backward()
    assert rwkv6_wkv_bwd.launches == before + 2
    y, S = rwkv6_wkv(r[:, :0], k[:, :0], v[:, :0], logw[:, :0], u)
    assert y.shape == (1, 0, 2, 64) and not S.any()
    off = torch.empty(r.numel() + 1, dtype=r.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16 bytes"):
        rwkv6_wkv(off.view(r.shape), k, v, logw, u)


# ---------------------------------------------------------------------------
# the recurrent families' training kernels
# ---------------------------------------------------------------------------
def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", LRU_BWD_SHAPES)
def test_rglru_lru_bwd_matches_plain(cuda, shape, dtype):
    """S-bwd against its plain version on the card (du, dxi, dxr and dΛ,
    with a gradient of the last h too), within RTRAIN_TOL; the same bits
    on a repeat; one launch a call."""
    u, xi, xr, lam = _lru_inputs(shape, dtype, cuda, sum(shape))
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 5)
    dh = torch.randn(shape, generator=g, device=cuda).to(dtype)
    dlast = torch.randn((shape[0], shape[2]), generator=g, device=cuda)
    before = rglru_lru_bwd.launches
    got = rglru_lru_bwd(u, xi, xr, lam, dh, dlast)
    again = rglru_lru_bwd(u, xi, xr, lam, dh, dlast)
    torch.cuda.synchronize()
    assert rglru_lru_bwd.launches == before + 2
    want = rglru_lru_bwd_ref(u, xi, xr, lam, dh, dlast)
    for name, a, w, b in zip(("du", "dxi", "dxr", "dlam"), got, want, again):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        tol = RTRAIN_TOL[dtype if name != "dlam" else torch.float32]
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", WKV_BWD_SHAPES)
def test_rwkv6_wkv_bwd_matches_plain(cuda, case):
    """W-bwd against its plain version on the card (dr, dk, dv, dlogw and
    du, with a gradient of the last state too), within RTRAIN_TOL overall
    and for dr, dk, dv per head; the same bits on a repeat."""
    *shape, dtype, shift = case
    r, k, v, logw, u = _wkv_inputs(tuple(shape), dtype, cuda, sum(shape),
                                   shift)
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 5)
    b, t, h, hd = shape
    dy = torch.randn((b, t, h, hd), generator=g, device=cuda)
    dS = torch.randn((b, h, hd, hd), generator=g, device=cuda)
    before = rwkv6_wkv_bwd.launches
    got = rwkv6_wkv_bwd(r, k, v, logw, u, dy, dS)
    again = rwkv6_wkv_bwd(r, k, v, logw, u, dy, dS)
    torch.cuda.synchronize()
    assert rwkv6_wkv_bwd.launches == before + 2
    want = wkv_bwd_ref(r, k, v, logw, u, dy, dS)
    for name, a, w, c in zip(("dr", "dk", "dv", "dlogw", "du"), got, want,
                             again):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        tol = RTRAIN_TOL[dtype if name in ("dr", "dk", "dv")
                         else torch.float32]
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))
        if name in ("dr", "dk", "dv"):
            assert float(_rel(a.float(), w.float(), (0, 1, 3)).max()) <= tol
        assert torch.equal(a, c), name


def _wkv_bwd_case(case, cuda):
    *shape, dtype, shift = case
    r, k, v, logw, u = _wkv_inputs(tuple(shape), dtype, cuda, sum(shape),
                                   shift)
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 5)
    b, t, h, hd = shape
    dy = torch.randn((b, t, h, hd), generator=g, device=cuda)
    dS = torch.randn((b, h, hd, hd), generator=g, device=cuda)
    return (r, k, v, logw, u, dy, dS), dtype


def _hold_wkv_bwd(got, want, dtype):
    for name, a, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        tol = RTRAIN_TOL[dtype if name in ("dr", "dk", "dv")
                         else torch.float32]
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))
        if name in ("dr", "dk", "dv"):
            assert float(_rel(a.float(), w.float(), (0, 1, 3)).max()) <= tol


@pytest.mark.parametrize("case", [(2, 77, 40, 64, torch.float32, 0.0),
                                  (3, 100, 4, 16, torch.bfloat16, 0.0),
                                  (1, 300, 8, 64, torch.float32, 3.0)])
def test_rwkv6_wkv_bwd_matches_its_chunked_arithmetic(cuda, case):
    """W-bwd against ``wkv_bwd_chunked`` (the kernel's arithmetic in plain
    PyTorch) run on the card on the same inputs, within RTRAIN_TOL overall
    and for dr, dk, dv per head: what differs is TF32 products and the
    order of sums, not the form."""
    args, dtype = _wkv_bwd_case(case, cuda)
    got = rwkv6_wkv_bwd(*args)
    torch.cuda.synchronize()
    _hold_wkv_bwd(got, wkv_bwd_chunked(*args), dtype)


def test_rwkv6_wkv_bwd_at_the_path_length_under_strong_decay(cuda):
    """W-bwd at rwkv6-3b's T = 4096 with the decay base shifted by 3 (the
    fastest channels decay by e^-12 a step): finite, within RTRAIN_TOL of
    the plain version overall and per head, the same bits on a repeat."""
    args, dtype = _wkv_bwd_case((1, 4096, 40, 64, torch.bfloat16, 3.0), cuda)
    got = rwkv6_wkv_bwd(*args)
    again = rwkv6_wkv_bwd(*args)
    torch.cuda.synchronize()
    _hold_wkv_bwd(got, wkv_bwd_ref(*args), dtype)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


def test_rwkv6_wkv_bwd_scratch_is_its_stated_size(cuda):
    """What a W-bwd call allocates beyond its outputs is at most
    ``bwd_scratch_bytes``: the chunk states' checkpoint and du's partial
    sums, no (slices, b, T, H, hd) dv partials (the step form's). The
    sizes are the allocator's own records of each request (its peak
    counts whole blocks, which may hold up to 1 MiB more than asked)."""
    args, dtype = _wkv_bwd_case((1, 1000, 40, 64, torch.bfloat16, 0.0), cuda)
    b, t, h, hd = args[0].shape
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=10000)
    try:
        out = rwkv6_wkv_bwd(*args)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    asked = sum(e["size"] for trace in snap["device_traces"] for e in trace
                if e["action"] == "alloc")
    outputs = sum(x.numel() * x.element_size() for x in out)
    assert asked - outputs <= bwd_scratch_bytes(b, t, h, hd), (
        asked, outputs, bwd_scratch_bytes(b, t, h, hd))


@pytest.mark.parametrize("shape", D256_BWD_SHAPES)
def test_flash_attention_bwd_d256_matches_plain(cuda, shape):
    """K3-bwd at head_dim 256: the forward is the d = 256 Hopper kernel
    (its lse), the backward the d = 256 Hopper kernel, held as the other
    K3-bwd cases; the same bits on a repeat."""
    q, k, v, dout, causal, window, _ = _bwd_case(shape, cuda)
    assert choose_kernel(q, k, v) == "flash_attention_sm90_d256"
    before = [w.launches for w in BWD_WRAPPERS]
    got = _bwd_grads(q, k, v, dout, causal, window, None)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(BWD_WRAPPERS, before)] == [
        int(w is flash_attention_bwd_sm90_d256) for w in BWD_WRAPPERS]
    want = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                     window=window)
    for name, a, w in zip("qkv", got, want):
        assert bool(torch.isfinite(a).all())
        err = float((a.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err < BWD_TOL[torch.bfloat16], (name, err)
        assert _grad_row_err(a, w) < BWD_ROW_TOL[torch.bfloat16], name
    again = _bwd_grads(q, k, v, dout, causal, window, None)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_flash_attention_bwd_mma_takes_d_from_p_not_the_rounded_output(
        cuda):
    """Values that share a large common part (as whisper-small's decoder's
    do at random weights) make dP - D small beside D = rowsum(dO ∘ O): D
    taken from O rounded to bf16 then moves dQ by several percent, as the
    float64 emulation of that rule shows. The mma.sync kernel's bf16 D is
    rowsum(P ∘ dP) and keeps dQ within BWD_TOL of the float64 gradient."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, t, d = 2, 4, 448, 64
    q, k = (torch.randn(b, h, t, d, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    v = (3.0 + 0.05 * torch.randn(b, h, t, d, generator=g,
                                  device=cuda)).bfloat16()
    dout = torch.randn(b, h, t, d, generator=g, device=cuda).bfloat16()
    lse = torch.empty(b, h, t, dtype=torch.float32, device=cuda)
    o = flash_attention_mma(q, k, v, causal=True, lse=lse)
    dq, dk, dv = flash_attention_bwd_mma(q, k, v, o, dout, lse, causal=True)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
    s = (q64 @ k64.transpose(-1, -2)) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=cuda).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    dp = do64 @ v64.transpose(-1, -2)
    want = (p * (dp - (p * dp).sum(-1, keepdim=True))) @ k64 * d ** -0.5
    rounded = ((p * (dp - (do64 * o.double()).sum(-1, keepdim=True)))
               @ k64 * d ** -0.5)
    err, err_rounded = _rel_err(dq, want), _rel_err(rounded, want)
    assert err < BWD_TOL[torch.bfloat16], err
    assert err_rounded > 3 * err, (err, err_rounded)


@pytest.mark.parametrize("d,kernel", [
    (128, "flash_attention_bwd_sm90"), (64, "flash_attention_bwd_sm90_d64"),
    (256, "flash_attention_bwd_sm90_d256")])
def test_flash_attention_bwd_hopper_takes_d_from_p_not_the_rounded_output(
        cuda, d, kernel):
    """The Hopper K3-bwd kernels on values that share a large common part
    (as in the mma.sync kernel's test above): each takes its inputs from
    the op's routing, keeps dQ within BWD_TOL of the float64 gradient, and
    D taken from O rounded to bf16 (emulated in float64) misses by more
    than 3x the kernel's error."""
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, t = 2, 4, 448
    q, k = (torch.randn(b, h, t, d, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    v = (3.0 + 0.05 * torch.randn(b, h, t, d, generator=g,
                                  device=cuda)).bfloat16()
    dout = torch.randn(b, h, t, d, generator=g, device=cuda).bfloat16()
    lse = torch.empty(b, h, t, dtype=torch.float32, device=cuda)
    o = ops._KERNELS[ops.choose_kernel(q, k, v)](q, k, v, causal=True,
                                                  lse=lse)
    assert ops.choose_bwd_kernel(q, k, v, o, dout) == kernel
    wrapper = getattr(ops, kernel)
    before = wrapper.launches
    dq, dk, dv = wrapper(q, k, v, o, dout, lse, causal=True)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
    s = (q64 @ k64.transpose(-1, -2)) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=cuda).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    dp = do64 @ v64.transpose(-1, -2)
    want = (p * (dp - (p * dp).sum(-1, keepdim=True))) @ k64 * d ** -0.5
    rounded = ((p * (dp - (do64 * o.double()).sum(-1, keepdim=True)))
               @ k64 * d ** -0.5)
    err, err_rounded = _rel_err(dq, want), _rel_err(rounded, want)
    assert err < BWD_TOL[torch.bfloat16], (err, err_rounded)
    assert err_rounded > 3 * err, (err, err_rounded)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b",
                                  "whisper-small"])
def test_reduced_recurrent_model_gradients_on_the_card_match_cpu(cuda, arch):
    """The reduced (float32) model's loss and every gradient on the card,
    through S-bwd, W-bwd and K3-bwd, against the same model's on the CPU
    (the plain versions), each within MODEL_GRAD_TOL of its max |cpu|."""
    cfg = reduced(ARCHS[arch])
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 41), generator=g)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(2, cfg.encoder_len, cfg.d_model,
                                      generator=g)
    cpu = Model(cfg, device="cpu").init(0)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    counts = (rglru_lru_bwd.launches, rwkv6_wkv_bwd.launches,
              flash_attention_bwd_mma.launches)
    out = {}
    for dev, model in (("cpu", cpu), (str(cuda), card)):
        model.requires_grad_(True)
        loss = model.loss({n: x.to(dev) for n, x in batch.items()},
                          remat=True)[0]
        loss.backward()
        out[str(dev)] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()})
    kinds = [cfg.mixer_kind(i) for i in range(cfg.n_layers)]
    moved = tuple(a - b for a, b in zip(
        (rglru_lru_bwd.launches, rwkv6_wkv_bwd.launches,
         flash_attention_bwd_mma.launches), counts))
    n_attn = sum(k in ("attn", "swa") for k in kinds) + (
        cfg.encoder_layers + cfg.n_layers if cfg.encoder_layers else 0)
    assert moved == (kinds.count("rglru"), kinds.count("rwkv6"), n_attn)
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    for n in gc:
        err = float((gg[n] - gc[n]).abs().max()
                    / gc[n].abs().max().clamp_min(1e-30))
        assert err < MODEL_GRAD_TOL["float32"], (n, err)
