#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:
  1. device: the card's name and power limit;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. K2 (Griewank aggregates) against its plain version, bit for bit,
     ragged tails with inf and NaN past n_valid included; its shortcuts
     against the library calls they replace over their whole domains;
     timed beside its bound;
  4. K1 (one whole ABO pass) against its plain version, and the cluster of
     16 CTAs against one CTA (the same bits), both timed;
  5. the main path, kernel route: ``abo_minimize(GRIEWANK, 1e8,
     use_kernel=True)``, with launch counts, peak device memory, and its
     fun beside the single-CTA kernel's;
  6. the plain tensor route: ``abo_minimize`` of Griewank and the sphere at
     n = 1e6;
  7. the solve engine (``repro_torch.engine``) through the port's
     ``solve_server`` batch mode: 24 jobs over 8 lanes at n = 1e5, 1e6 and
     4e6 (wall time, jobs/s, probes/s, row steps and launches per row step,
     swept-row waste, peak memory beside the pool bytes, every job's fun
     against its limit, the pools shrunk after the drain, no kernel
     launched); a second run of 3 jobs under ``--sanitize`` whose jobs are
     held bit for bit to ``abo_minimize`` on the card; and one 4096-wide
     tile summed inside slabs of 1, 2, 3, 17 and 256 rows;
  8. float64 solves: the plain route on Griewank in float64 at n = 1e7 from
     seed 0 (fun against its limit, wall, probes/s, ms per block, peak
     memory against the 8n solution bytes), then three float64 jobs through
     the engine, each bit for bit ``abo_minimize``'s;
  9. kill and resume at phase 7's size: the 24-job solve_server run in a
     child process, killed at the second snapshot write and, apart, at the
     13th journal append; fsck reports and repairs each directory; the
     engine resumes here, and every durable job ends DONE with phase 7's
     fun and history (and x, where the snapshot keeps it) bit for bit;
 10. the serving tier, each server in a child process on the card: (a)
     the port's ``solve_server --http`` takes phase 7's 24 jobs over
     ``/submit`` and delivers them over ``/result?wait=`` with phase 7's
     fun, history and x bit for bit (wall, jobs/s, submit latency, reply
     bytes and ms by n, ``/healthz`` latency while the steps run); (b) the
     router over 2 workers, worker 0 killed at its 2nd step with acked
     jobs pending: zero lost jobs, only deliberate 503s, w0 restarted
     (time to recover printed), and every fun and history bit for bit
     (w1's phase 7's, w0's ``abo_minimize``'s);
 11. K3 (flash attention, four kernels) against its plain version in bf16
     and float32 at the shapes of ``ATTN_SHAPES`` (max abs and per row),
     each shape through the kernel that ``choose_kernel`` gives it (bf16
     at head_dim 256 through ``flash_attention_sm90_d256``, float32 there
     must be refused; bf16 at head_dim 64 through
     ``flash_attention_sm90_d64``, the mma.sync kernel also called
     directly there); both Hopper d = 256 and d = 64 kernels' stage
     releases read in their SASS; the
     Hopper kernel (``flash_attention_sm90``), the mma.sync kernel
     (``flash_attention_mma``) and ``scaled_dot_product_attention`` timed in
     turns at the model's layer shape (T = 8192) and at T = 32768, beside
     the plain version and the bound;
 12. the LM serving path at full width: ``mistral-nemo-12b``'s prefill step
     on one T = 8192 request (40 launches, all of the Hopper kernel; wall
     time, tokens/s, peak memory); the forward against the same forward with
     the plain attention, K3 held per row on every layer's own q, k, v and
     the logits at every position; prefill + 8 decode steps against the
     forward;
 13. the serve launcher at full width (8 requests, 4 slots);
 14. the mma.sync kernel's path: the reduced ``mistral-nemo-12b`` (float32,
     head_dim 16) prefill step on the card, against its plain-attention run,
     and that kernel timed at its attention shape;
 15. the LM training path (``[train]``, TRAIN_ARGS): K3-bwd (four kernels:
     the Hopper ones at head_dim 120/128 and 64, and 256 in phase 24, and
     the mma.sync one; each case through the one ``choose_bwd_kernel``
     gives it) against its plain version, and D's rule on values with a
     large common part against float64 at 128, 64 and 256 (``d_rule``);
     the Hopper kernel, the mma.sync kernel and SDPA's
     backward timed in turns at the AdamW shape and at T = 8192; P (ABO-ZO's
     perturbation) bit for bit its plain version and timed over the whole
     model; ABO-ZO on the whole ``mistral-nemo-12b`` through
     ``launch.train.main`` (wall a step, 400 Hopper K3 launches a step, P's
     launches, peak memory over the parameter bytes); AdamW at full width
     cut to 4 layers (step 1 against the plain attention, 3 timed steps,
     K3 and the Hopper K3-bwd in every layer, the 40-layer memory
     arithmetic); the reduced config's resume, bit for bit, through the
     mma.sync K3-bwd;
 16. the mixture-of-experts family at full width (``[moe]``): K3 at the
     MoE models' MHA layer shape and both K3-bwd kernels at olmoe's AdamW
     shape, timed in turns with SDPA's backward;
     ``olmoe-1b-7b`` and ``moonshot-v1-16b-a3b`` each: the prefill step on
     one T = 8192 request (16 and 48 launches, all of the Hopper kernel;
     wall, tokens/s, peak memory), the lossless forward against its
     plain-attention run (K3 per row on every layer's own q, k, v, the
     share of routes that differ, the logits where the routes agree; with
     the routes pinned, the logits at every position, beside the library
     attention's), and prefill + 8 decode steps against the lossless
     forward; the serve
     launcher on olmoe; P bit for bit on olmoe's float32 router and a
     stacked expert leaf and timed over the whole model; ABO-ZO on the
     whole olmoe through ``launch.train.main``; AdamW on olmoe cut to 4
     layers (step 1 against the plain attention with its routes pinned,
     aux, K3 and the Hopper K3-bwd in every layer);
 17. the hybrid family at full width (``[hybrid]``, HYBRID_ARCH): S (the
     RG-LRU's gates and recurrence in one kernel, port only) bit for bit
     its plain version at ``SCAN_SHAPES`` and on a repeat, its shortcuts
     on every input they can see, its recurrence-only entry bit for bit,
     S timed in turns with the eager path it replaced beside its bound and
     the build's gate instructions; K3 at head_dim
     256 timed at recurrentgemma-2b's layer shape in turns with SDPA (the
     window as a mask, and causal without it), beside its plain version
     and bound; ``recurrentgemma-2b``'s prefill step on one T = 8192
     request (8 launches of the head_dim 256 Hopper kernel, 18 of S, no
     other K3; wall, tokens/s, peak memory); the forward against the same
     forward with the plain attention and the plain scan (K3 per row on
     every swa layer's own q, k, v, S bit for bit on every RG-LRU layer's
     own a and b, the logits at every position); prefill + 8 decode steps
     against the forward; the serve launcher (8 requests, 4 slots);
 18. RWKV6 at full width (``[rwkv6]``, RWKV_ARCH): W (RWKV6's WKV
     recurrence, port only) against its plain version at ``WKV_SHAPES``
     (y and the last state, overall and per head), the same bits on a
     repeat, a gradient launching W-bwd; W and the plain loop timed in turns at
     the model's layer shape beside the bound; ``rwkv6-3b``'s prefill step
     on one T = 8192 request (32 launches of W and none of any other
     kernel; wall, tokens/s, peak memory); the bf16 forward against the
     same forward with W's plain version (W held on every layer's own r,
     k, v and logw; the logits read) and prefill + 8 decode steps against
     the forward (read; ms a step); the same model in float32: W per
     layer, the logits at every position, the prefill step's and the
     decode seam held; the serve launcher (8 requests, 4 slots);
 19. Nelder-Mead, the paper's baseline (``[nm]``, NM_SPHERE): the sphere
     at n = 2; ABO's fun below Nelder-Mead's at n = 200 with Nelder-Mead's
     budget ABO's own fe; its chunks as CUDA graphs against the same
     chunks run eagerly, in turns; the MemoryError at n = 1e5 under 8 GiB, raised
     before any allocation; one run read at n = 1e4 (wall, iterations,
     host reads, peak memory against ``simplex_bytes``);
 20. the port's examples (``[examples]``): each ``examples_torch/`` script
     in a child process on the card, importing no JAX (quickstart at
     n = 1e6 held to 1e-6, calibrate_watershed at n = 1e5 held to the JAX
     package's residual, solve_service's 12 jobs drained, serve_decode's
     12 requests answered, train_lm_abo's losses finite);
 21. whisper-small at full width (``[whisper]``, WHISPER_ARCH): K3 at the
     encoder's, the cross-attention's and the decoder's self-attention
     shapes, the Hopper d = 64 kernel and the mma.sync kernel against the
     plain version, then both and SDPA timed in turns (the d = 64 kernel
     must beat the mma.sync one at the encoder and cross shapes); the
     prefill step (the forward with frames: 36 launches, all of
     ``flash_attention_sm90_d64``; wall, tokens/s, peak memory); the
     forward against its plain-attention run (K3 on every
     encoder, self and cross layer's own q, k, v; the logits at every
     position); fill_cross_cache and 8 decode steps against the forward;
 22. qwen2-vl-7b at full width (``[vlm]``, VLM_ARCH), M-RoPE over a
     stubbed image's (t, h, w) position ids: the prefill step (28
     launches, all of ``flash_attention_sm90`` at a GQA group of 7; wall,
     tokens/s, peak memory); the forward with the stubbed patch
     embeddings against its plain-attention run (K3 on every layer's own
     q, k, v; the logits at every position); M-RoPE on the card against
     float64, and the image's ids moving the logits; prefill + 8 decode
     steps against the forward; the int8 KV cache (its bytes, 128 tokens
     decoded against the forward beside the bf16 cache's decode, ms a step
     against 8200-slot caches); the serve launcher (8 requests); K3 at the
     layer shape timed in turns with SDPA;
 23. the other dense decoders at full width (``[dense]``, DENSE_ARCHS),
     one at a time: granite-20b (MQA 48/1, LayerNorm, tanh-gelu, a
     learned table of 32768 rows, tied embeddings), internlm2-20b (48/8)
     and h2o-danube-3-4b (32/8 at head_dim 120, a 4096 window), each
     served as phases 12-13 serve mistral-nemo-12b: the prefill step on
     one T = 8192 request (52, 48 and 24 launches, all of
     ``flash_attention_sm90``, none of another K3 kernel; wall, tokens/s,
     peak memory over the parameter bytes), the forward against its
     plain-attention run (K3 per row on every layer's own q, k, v; the
     logits at every position), prefill + 8 decode steps against the
     forward (danube's 4096-slot ring wrapping), the serve launcher (8
     requests), and K3 at the layer shape timed in turns with SDPA
     (danube's with the window as a mask, and causal without it);
     granite-20b also prefills 32768 tokens (wall, peak, K3 at (1, 48/1,
     32768, 128) timed in turns with SDPA and held to its plain version)
     and decodes at the learned table's last 8 rows against the forward
     over 32768, and takes AdamW steps cut to 4 of its 52 layers (step 1
     against the plain attention, K3 and the Hopper K3-bwd in every
     layer; K3-bwd at (8, 48/1, 512, 128) timed in turns with SDPA's
     backward);
 24. the recurrent families' and whisper-small's training at full width
     (``[rtrain]``, RTRAIN_T): the backward kernels the path adds, S-bwd,
     W-bwd and the Hopper K3-bwd at head_dim 256, each against its plain
     version on the card (T no tile or chunk divides, T below and above
     the window, MQA and GQA, float32 and bf16), the same bits on a repeat,
     each timed on the device alone beside its plain version's held call
     and its bound (K3-bwd in turns with the mma.sync kernel and SDPA's
     backward); the Hopper K3-bwd at head_dim 64 at whisper-small's three
     shapes the same way, the decoder's per row against float64; AdamW
     through
     ``make_train_step`` on recurrentgemma-2b and rwkv6-3b (1 x 4096
     tokens, remat): step 1's loss and every gradient against the plain
     versions' (rwkv6's held in float32 cut to 2 layers, its bf16 read),
     two steps timed (wall, peak memory, launches a step forward and
     backward apart: 18 S-bwd and 8 Hopper K3-bwd at 256, no mma.sync one;
     32 W-bwd; no plain version called); one ABO-ZO step on each of the
     three whole models; whisper-small's AdamW step held the same way, its
     36 K3-bwd launches all of the Hopper kernel at head_dim 64; the
     launcher's AdamW (recurrentgemma-2b) and
     ABO-ZO (rwkv6-3b) runs at 1 x 4096 tokens;
 25. one JSON line with every kernel's launches, error and times;
 26. the last line, ``{"ok": true, "device": {...}}``.

Imports torch and the port only. Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 without the
# tensor cores, bf16 on the tensor cores (dense).
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
PEAK_TF32_OPS_S = 495e12
# K2 is bound by instruction issue, not by its float32 operations: each
# coordinate runs the library sequences of rsqrt, sin/cos (one range
# reduction for the pair) and log1p or log. Its bound counts the
# instructions Griewank itself needs per coordinate, by pipe
# (benchmarks_torch/k2_sass.py, "function": cuobjdump -sass of the sm_90a
# build, NVIDIA H100 80GB HBM3, 700.00 W): rsqrt, the reduction and both
# polynomials, and log1p where sin^2 u < 0.5, else log; the products,
# compares, selects and the tile sum's adds in each thread. It leaves out
# the index, address, load and loop instructions and the cost of
# divergence: a floor of the function, not of this build. Each pipe runs at
# its own rate per SM and clock (CUDA C++ Programming Guide, arithmetic
# throughput, compute capability 9.0), all of them behind one issue port of
# 32 lanes on each of the four schedulers, on 132 SMs at 1980 MHz. The fold
# adds the tile partials in order, a chain of dependent float32 adds of 4
# clocks each; it runs beside the pass (a fold CTA trails the tiles' ready
# flags), so the bound is the larger of the two, not their sum.
K2_FN = {"common": {"fp32": 19.8125, "alu": 12.0625, "mufu": 1, "conv": 1},
         "log1p": {"fp32": 17, "alu": 7, "mufu": 0, "conv": 0},
         "log": {"fp32": 16, "alu": 11, "mufu": 0, "conv": 0}}
PIPE_RATE = {"fp32": 128, "alu": 64, "mufu": 16, "conv": 16}
SMS, CLOCK_HZ, ISSUE_LANES, FADD_CLOCKS = 132, 1.98e9, 128, 4
# What this build issues (k2_sass.py, the same build): per warp of 32
# coordinates, the tile body's common part and each branch; per tile, the
# tile prologue of its 8 warps, warp 0's tree and publication and the other
# 7 warps' share of the tree. Printed beside the bound.
K2_SASS = {"common": 42.0625, "log1p": 25, "log": 36.5,
           "tile": 8 * 33 + 119 + 7 * 28}
# Elementary float32 operations per candidate probe (K1), each
# transcendental counted as one (so the bound is a lower bound): offset
# (convert, multiply, subtract), window (multiply, add), clamp 2, incumbent
# and padding selects 2, the 16 plane operations of K2 after rsqrt
# (u .. cos<0), 3 deltas, 3 aggregate adds, combine (parity 3, compare,
# expm1 or exp, multiply, add or subtract, select), argmin compare = 40.
K1_OPS_PER_PROBE = 40
# The plain route is held to the 1e-6 of tests/test_abo.py, except where the
# JAX package itself misses it: the sphere at n = 1e6 ends at
# 9.72658017417416e-06 there (XLA:CPU, default config), and the port is
# held to that value, with 0.1% for the card's order of summation.
PLAIN_TOL = {"sphere": 9.72658017417416e-06 * 1.001}
# The kernel route solves Griewank at the paper's Table scale cut by 10;
# the plain route solves at examples/quickstart.py's n.
MAIN_N = 10**8
PLAIN_N = 10**6
# K3: (b, hq, hkv, sq, sk, d, causal, window), as tests/test_torch_gpu.py;
# no shape has a query row without a valid key (ROADMAP, K3). Two limits on
# N(0, 1) inputs: max abs, as tests/test_kernels.py holds the Pallas kernel
# to its oracle; and per query row, the row's max |got - want| over its max
# |want| (``row_rel_err``). The second scales with the output: at T = 8192
# a late row averages V over thousands of keys, its entries are ~0.02, and
# a max abs limit of 2e-2 would pass a kernel that dropped a kv block there
# (benchmarks_torch/k3_fault_check.py plants such faults).
ATTN_SHAPES = [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 384, 384, 128, True, None),        # GQA
    (2, 4, 1, 256, 256, 64, True, None),         # MQA
    (2, 4, 4, 256, 256, 64, True, 128),          # window
    (1, 2, 2, 128, 128, 64, False, None),        # non-causal
    (1, 4, 2, 200, 200, 64, True, None),         # ragged
    (1, 32, 8, 333, 333, 120, True, 96),         # d = 120, ragged window
    (2, 4, 2, 100, 300, 16, False, None),        # sq != sk, d = 16
    (1, 16, 16, 8192, 8192, 128, True, None),    # MHA: the MoE models'
    (1, 32, 8, 8192, 8192, 128, True, None),     # the model's layer shape
    # head_dim 256, bf16 only (float32 there has no kernel: the op raises)
    (1, 10, 1, 333, 333, 256, True, 96),         # ragged, window
    (1, 2, 2, 100, 300, 256, False, None),       # non-causal, sq != sk
    (1, 8, 8, 1024, 1024, 256, True, None),      # causal, no window
    # the head_dim 256 kernel's clusters and persistent walk: a 5/1 group,
    # whose last head has no partner and whose shared and solo tiles both
    # outnumber the grid; GQA in pairs at batch 2 (40 tiles); one tile
    (3, 5, 1, 6000, 6000, 256, True, 1000),
    (2, 8, 2, 640, 640, 256, True, 300),
    (1, 2, 1, 77, 77, 256, True, None),
    (1, 10, 1, 8192, 8192, 256, True, 2048),     # recurrentgemma-2b's layer
    # head_dim 64's Hopper kernel (bf16): whisper-small's encoder (1500
    # ragged keys and query rows), MQA with a window, GQA over 2000 keys
    # with a four-way key split
    (4, 12, 12, 1500, 1500, 64, False, None),
    (2, 8, 1, 1000, 1000, 64, True, 300),
    (2, 8, 2, 300, 2000, 64, False, None),
    # qwen2-vl-7b's GQA group of 7 (28 query heads over 4 kv heads): its
    # layer shape, and a ragged one at batch 2
    (1, 28, 4, 8192, 8192, 128, True, None),
    (2, 28, 4, 333, 333, 128, True, None),
    # the dense decoders' layer shapes (DENSE_ATTN_SHAPES): granite-20b's
    # MQA, internlm2-20b's 48/8, h2o-danube-3-4b's 32/8 at head_dim 120
    # under its 4096 window, whose tiles walk ~33 kv blocks, all but the
    # two edges unmasked; and a ragged d = 120 case at batch 2 whose window
    # starts mid-block past block 0
    (1, 48, 1, 8192, 8192, 128, True, None),
    (1, 48, 8, 8192, 8192, 128, True, None),
    (1, 32, 8, 8192, 8192, 120, True, 4096),
    (2, 32, 8, 5000, 5000, 120, True, 4096),
]
LM_ATTN_SHAPE = (1, 32, 8, 8192, 8192, 128, True, None)
VLM_ATTN_SHAPE = (1, 28, 4, 8192, 8192, 128, True, None)
D256_SHAPE = (1, 10, 1, 8192, 8192, 256, True, 2048)
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-3}
ATTN_ROW_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
LM_ARCH = "mistral-nemo-12b"
LM_T = 8192                  # one prefill request
LM_DECODE = 8                # decode steps after the prefill
# bf16 tolerances of the full-width model (PERF.md has the readings): the
# logits with K3 against the same forward with the plain attention, at
# every position, and prefill + decode against the forward, each as max
# abs over max |logit| of the reference at that position. The logits are
# dominated by the MLPs' share of the residual stream, so the sensitive
# check of K3 on the model's path is per layer: K3 against its plain
# version on each layer's own q, k, v, held to ATTN_ROW_TOL.
LM_REL_TOL_PLAIN = 0.05
LM_REL_TOL_DECODE = 0.05
LM_EARLY = 64                # positions reported apart: few keys each
# The kernel route at MAIN_N ends at this fun with the single-CTA sweep
# kernel; the cluster keeps the bits, so it is printed beside this run's.
ONE_CTA_MAIN_FUN = 189705552.0
# The mma.sync kernel's path: the reduced config's prefill step on the card.
MMA_TOKENS = (4, 512)

# Phase 7, the solve engine through the port's solve_server batch mode, at
# the reference's default sampling and block. solve_server's job i solves
# objective i mod 3 at size i mod 3 from seed i (the reference's mix), so
# the 24-job run holds (griewank, 1e5), (sphere, 1e6) and (rastrigin, 4e6);
# the sanitized run lists the sizes the other way round and holds
# (griewank, 4e6), (sphere, 1e6) and (rastrigin, 1e5), the three jobs held
# bit for bit to abo_minimize.
ENGINE_COMMON = ["--objectives", "griewank,sphere,rastrigin", "--samples",
                 "50", "--passes", "5", "--block", "4096", "--device", "cuda"]
ENGINE_MAIN = ["--jobs", "24", "--lanes", "8", "--n",
               "100000,1000000,4000000"] + ENGINE_COMMON
ENGINE_SANITIZED = ["--jobs", "3", "--lanes", "3", "--n",
                    "4000000,1000000,100000", "--sanitize"] + ENGINE_COMMON
# In the 24-job run the three families share the 8 lanes, 2 or 3 each, and
# a family's lanes share every row step. So one job of each family is also
# held bit for bit to abo_minimize, each on the last lane of a pool of 3
# (seeds 14, 15 and 22: rastrigin, griewank, sphere). A lane that read
# another lane's blocks or aggregates would give a fun within the limits
# all the same.
ENGINE_MAIN_SOLO_SEEDS = (14, 15, 22)
# The JAX package's own abo_minimize on these jobs (CPU, the largest fun
# over the seeds this phase gives each (objective, n);
# benchmarks_torch/engine_limits.py). From seeded starts it misses 1e-6 at
# n >= 1e6: its float32 aggregates cannot resolve a probe once the sums are
# large. A job is held to 1e-6, or where the JAX package misses that, to
# its value x 1.001, as PLAIN_TOL holds the plain route.
ENGINE_JAX_FUN = {
    ("griewank", 100000): 3.0593154676239465e-09,
    ("sphere", 1000000): 1859553.75,
    ("rastrigin", 4000000): 4065884.0,
    ("griewank", 4000000): 4814165.5,
    ("rastrigin", 100000): 0.0,
}
ENGINE_PHASE_S = 90          # the phase's time limit

# Phase 8, the paper's double-precision path: the plain route on Griewank
# in float64 from seed 0, whose aggregates are float64 as the JAX
# package's are under x64. The paper's headline n = 1e9 is cut by 100 to
# fit the time limit: the plain route is launch-bound at ~1.9 ms a block
# (PERF.md section 5), so 1e7 takes 5 x 2442 blocks, ~25 s. Then three
# float64 jobs through the engine, each held bit for bit to abo_minimize.
F64_N = 10**7
F64_ENGINE = (("griewank", 10**6, 0), ("sphere", 10**6, 1),
              ("rastrigin", 10**6, 2))
# The JAX package's own abo_minimize on these solves under
# jax.enable_x64(True) with dtype=jnp.float64 (CPU;
# benchmarks_torch/engine_limits.py --x64). Each is held to 1e-6, or where
# the JAX package misses that, to its value x 1.001.
F64_JAX_FUN = {"griewank,10000000,0": 0.0, "griewank,1000000,0": 0.0,
               "sphere,1000000,1": 0.0, "rastrigin,1000000,2": 0.0}
F64_PHASE_S = 150
# Phase 9, kill and resume at phase 7's size: ENGINE_MAIN through the
# port's solve_server in a child process on the card, killed at a
# durable-state failpoint, repaired by fsck, resumed in this process, and
# every durable job held bit for bit to phase 7's uninterrupted run. (a)
# A kill at the second snapshot write (the first is the one at submit, so
# the second is step 1's); (b) a kill at the 13th journal append, the
# torn tail inside the 24 submissions, before any base.
CKPT_SNAPSHOT_KILL = "snapshot_write:kind=kill:nth=2"
CKPT_JOURNAL_KILL = "journal_append:kind=kill:nth=13"
CKPT_PHASE_S = 150
# Phase 10, the serving tier on the card, each server in a child process.
# (a) One worker: the port's solve_server --http with phase 7's 8 lanes
# takes phase 7's 24-job mix over /submit (job i: objective i mod 3 at
# size i mod 3 from seed i, phase 7's sampling and block) and delivers it
# over /result?wait=; every fun and history, and x, must be phase 7's bit
# for bit. (b) The router over 2 workers of 2 lanes each, worker 0 killed
# by its own stepper at its 2nd step. crc32(objective) % 2 puts
# shifted_sphere on w0 and griewank, sphere and rastrigin on w1, so w0
# takes HTTP_W0_JOBS and w1 phase 7's jobs 0-5.
HTTP_CFG = {"samples_per_pass": 50, "n_passes": 5, "block_size": 4096}
HTTP_MIX = (("griewank", 100000), ("sphere", 1000000),
            ("rastrigin", 4000000))
HTTP_JOBS = [HTTP_MIX[i % 3] + (i,) for i in range(24)]
HTTP_W0_JOBS = [("shifted_sphere", 10**6, s) for s in range(6)]
HTTP_W1_JOBS = HTTP_JOBS[:6]
HTTP_INJECT = "0:worker_crash:nth=2:kind=kill"
HTTP_PHASE_S = 150
# Phase 15, the LM training path at full width (mistral-nemo-12b, bf16,
# random weights from seed 0 as the launcher draws them), batch 8 of 512
# tokens from BigramStream: (a) K3-bwd against autograd through the plain
# attention at TRAIN_BWD_SHAPES (the AdamW shape, the reduced config's at
# 512 and at (e)'s 128 tokens, a ragged sq and a window, olmoe's MHA, and
# the Hopper kernel's edges; tests/test_torch_gpu.py's BWD_SHAPES) and at
# BWD_ROUTING_CASES, held as max |got - want| over the tensor's max |want|,
# overall and per row, each through the kernel that choose_bwd_kernel names
# (its launch count moves by one); then the Hopper kernel, the mma.sync
# kernel and SDPA's backward timed in turns at the AdamW shape and at
# BWD_LONG, the Hopper kernel held at BWD_LONG_HELD; (b) P against its
# plain version bit for bit (P_CASES, then the whole model), timed over the
# whole model; (c) ABO-ZO on the whole model through launch.train.main
# (ABO_STEPS steps); (d) AdamW through make_train_step at full width cut to
# ADAMW_LAYERS of 40 layers (all 40 need 16 bytes a parameter, ~196 GB),
# step 1's loss and gradients held against the plain attention's; (e) the
# reduced config (float32: the mma kernel and K3-bwd's float32 path)
# through the launcher, 8 steps against 4 plus a resume to 8, bit for bit.
TRAIN_BWD_SHAPES = [
    (8, 32, 8, 512, 512, 128, True, None, "bfloat16"),   # the AdamW shape
    (4, 4, 2, 512, 512, 16, True, None, "float32"),      # the reduced config
    (4, 4, 2, 128, 128, 16, True, None, "float32"),      # (e)'s resume
    (2, 4, 2, 200, 200, 64, True, None, "bfloat16"),     # ragged sq
    (2, 4, 2, 200, 200, 64, True, None, "float32"),
    (2, 4, 4, 256, 256, 64, True, 96, "bfloat16"),       # window
    (2, 4, 4, 256, 256, 64, True, 96, "float32"),
    (8, 16, 16, 512, 512, 128, True, None, "bfloat16"),  # olmoe's AdamW (MHA)
    # the Hopper kernel's edges (bf16, head_dim 120 or 128)
    (2, 4, 2, 200, 200, 128, True, None, "bfloat16"),    # ragged sq
    (1, 32, 8, 333, 333, 120, True, 96, "bfloat16"),     # h2o-danube's d
    (2, 4, 2, 100, 300, 128, False, None, "bfloat16"),   # cross: sq != sk
    (1, 48, 1, 256, 256, 128, True, None, "bfloat16"),   # MQA (granite)
    (8, 48, 1, 512, 512, 128, True, None, "bfloat16"),   # granite's AdamW
]
# Hopper-eligible shapes (head_dim 128 and 64) whose dO rows are the
# given number of elements apart (not a multiple of 8): the mma.sync
# kernel takes them.
BWD_ROUTING_CASES = [((2, 4, 2, 200, 200, 128, True, None, "bfloat16"), 132),
                     ((2, 4, 2, 200, 200, 64, True, None, "bfloat16"), 68)]
# D's rule: values that share a large common part,
# v = 3 + 0.05·randn, (2, 4, 448, d) causal, through each Hopper backward;
# dQ against float64 within BWD_TOL, and D from O rounded to bf16
# (emulated in float64) more than D_RULE_RATIO times as far off
D_RULE_DIMS = (128, 64, 256)
D_RULE_RATIO = 3.0
# The long-context training shape of mistral-nemo-12b's own config, timed
# (b, hq, hkv, T, d; bf16, causal); the Hopper kernel is held to the plain
# backward at BWD_LONG_HELD, whose autograd needs a few GB
BWD_LONG = (1, 32, 8, 8192, 128)
BWD_LONG_HELD = (1, 8, 2, 8192, 128)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
BWD_ROW_TOL = {"bfloat16": 1e-1, "float32": 1e-3}
BWD_ROW_FLOOR = 5e-2      # see grad_row_err
# P: (elements, leaf offset, dtype): a ragged leaf, a stacked leaf's
# offset, the counter's high word, a float32 leaf
P_CASES = [(1_000_003, 0, "bfloat16"), (777_777, 3 * 2**31 + 5, "float32"),
           (5 * 2**20 + 3, 2**32 - 1000, "bfloat16"),
           (4096, 7 * 4096, "float32")]
# P's own instructions an element (benchmarks_torch/p_sass.py "function"):
# threefry's rotations and xors and the sign's xor run only on the integer
# ALU pipe; the adds may go to the ALU or the FMA pipe; all of them issue.
# The build's loop issues P_SASS_LOOP (p_sass.py "loop_total", NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside the bound.
P_FN = {"alu_only": 41, "int_add": 35, "other": 2, "fp32": 1, "conv": 1}
P_SASS_LOOP = 88
TRAIN_T, TRAIN_B = 512, 8
TRAIN_ARGS = ["--arch", LM_ARCH, "--seq-len", str(TRAIN_T), "--batch",
              str(TRAIN_B)]
ABO_STEPS = 2
ADAMW_LAYERS = 4
ADAMW_STEPS = 3
# AdamW's step 1 with K3 against the plain attention, bf16 (PERF.md has
# the readings): the loss, relative; each gradient tensor, max |diff| over
# max |plain|
ADAMW_LOSS_TOL = 1e-2
ADAMW_GRAD_TOL = 5e-2     # tests/test_torch_gpu.py's MODEL_GRAD_TOL
TRAIN_PHASE_S = 300
# Phase 16, the mixture-of-experts family at full width (bf16, random
# weights from seed 0, as the launchers draw them): olmoe-1b-7b and
# moonshot-v1-16b-a3b (its 48 layers, the dense head layer and 2 shared
# experts) each take the prefill step on one LM_T-token request (the
# config's capacity 1.25, dispatched in chunks of 2048), then a lossless
# forward (capacity None, the capacity prefill and decode use) with K3
# against the same forward with the plain attention, and prefill +
# LM_DECODE decode steps against the lossless forward; the serve launcher
# on olmoe; then olmoe trained with TRAIN_ARGS' shape: ABO-ZO on the whole
# model through the launcher, AdamW on the model cut to ADAMW_LAYERS of 16
# layers (all 16 need 16 bytes a parameter, ~111 GB).
MOE_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
MOE_TRAIN_ARCH = "olmoe-1b-7b"
# Route flips. A bf16 difference between K3 and the plain attention can
# reorder a near-tie in a layer's router, and a token that changes experts
# changes its output far more than the attention error; later layers then
# see it. So the two runs are compared per (token, layer, slot): a route
# differs where the slot's expert is not among the other run's top-k of
# that token and layer (a reordering within the top-k moves nothing). The
# share of routes that differ is held under MOE_ROUTE_SHARE (a K3 that
# computed garbage would move ~(1 - k/E) of them, 87.5% on olmoe), and the
# logits at the positions whose routes agree in every layer to MOE_REL_TOL
# of the reference's max |logit| at the position (dense mistral-nemo reads
# 1.8% at every position: PERF.md). On olmoe those positions must be at
# least MOE_AGREE_MIN of the request. On moonshot they are not: its 47 MoE
# layers compound the flips until 1 of 8192 positions agrees in every
# layer (PERF.md, PR 19). Two more runs pin each dispatch to the K3 run's
# experts, so that no route flips, and are compared with a third pinned
# run through the plain attention: the K3 run, which on olmoe must match
# it at every position to MOE_PINNED_TOL (the dense models' limit), and a
# run through the library's flash attention (scaled_dot_product_attention,
# a yardstick only), whose distance from it the K3 run's may exceed by no
# more than MOE_LIBRARY_RATIO, max over positions. Moonshot's pinned K3
# run reads 0.0992 (PR 19): its 48 layers amplify any one-ulp difference
# in attention, and the library's run tells how far. Decode steps are
# held to the lossless forward at the position the prefill ends on and at
# each decoded position whose routes agree. MOE_ROUTE_SHARE, MOE_AGREE_MIN
# and MOE_REL_TOL were set before the first run on the card, the pinned
# runs and their limits after it (PERF.md, PR 19, has the sequence).
MOE_ROUTE_SHARE = 0.5
MOE_AGREE_MIN = {"olmoe-1b-7b": 0.01}
MOE_REL_TOL = 0.1
MOE_PINNED_TOL = {"olmoe-1b-7b": LM_REL_TOL_PLAIN}
MOE_LIBRARY_RATIO = 2.0
# AdamW's step 1 with K3 against the plain attention holds each gradient
# tensor, the routers' included, to ADAMW_GRAD_TOL and the loss to
# ADAMW_LOSS_TOL with the plain run's routes pinned to the K3 run's (a
# route flip is a jump of the loss, not an error of K3; the flips are
# counted); aux (E·Σ f·p summed over the MoE layers) must reach
# MOE_AUX_MIN, as tests/test_models.py holds the reference's.
MOE_AUX_MIN = 1.0 - 1e-3
MOE_PHASE_S = 240
# Phase 17, the hybrid family at full width (``[hybrid]``):
# recurrentgemma-2b (26 layers in the pattern (rglru, rglru, swa): 18
# RG-LRU layers through S, 8 local-attention layers, 10/1 MQA at head_dim
# 256 with window 2048, through the Hopper K3 at head_dim 256), bf16,
# random weights from --seed. The prefill step on one LM_T-token request;
# the forward against the same forward with the plain attention and the
# plain RG-LRU (K3 per row on each swa layer's own q, k, v; S bit for bit
# on each RG-LRU layer's own u, xi, xr; the logits at every position within
# LM_REL_TOL_PLAIN); prefill + LM_DECODE decode steps against the forward
# (LM_REL_TOL_DECODE: the conv state and the float32 h carried across the
# seam); the serve launcher (8 requests, 4 slots). Before the model, S
# against its plain version bit for bit at SCAN_SHAPES, twice, and S and K3
# at head_dim 256 timed at the model's shapes.
HYBRID_ARCH = "recurrentgemma-2b"
SCAN_SHAPES = [(1, LM_T, 2560), (3, 1000, 2560 + 8)]
# The three-launch S that the one-pass kernel replaced, as recorded in
# PERF.md (this script on an NVIDIA H100 80GB HBM3 at 700.00 W, before the
# gates were fused in). That source is gone, so no run re-times it: it is
# printed as that reading, beside this run's times, and goes into no
# number of the kernels line.
S_THREE_LAUNCH_MS = 0.2033
# the phase's time limit: its first reading on the card was 8.1 s
# (PERF.md), and host time moves 1.5x between calls
HYBRID_PHASE_S = 60
# Phase 18, RWKV6 at full width (``[rwkv6]``): rwkv6-3b (32 layers of the
# time mix, 40 heads of 64, and the channel mix at d_ff 8960), bf16,
# random weights from --seed, nothing cut. Before the model, W against its
# plain version at WKV_SHAPES (the layer shape, a T no chunk divides, the
# reduced config's float32 head of 16, and a strong-decay draw, the decay
# base + 3, at a T no chunk divides; the last entry is that shift of the
# decay's log-log): y and the last state within
# WKV_TOL of the plain version's max |value|, overall and per head, twice
# the same bits. The prefill step on one LM_T-token request; the forward
# against the same forward with W's plain version (W within WKV_TOL on
# every layer's own inputs; the logits read); prefill + LM_DECODE decode
# steps (read). Then the same model drawn in float32: W per layer, the
# logits within LM_REL_TOL_PLAIN at every position with the argmax equal
# at the last, and prefill + decode within RWKV_DECODE_TOL of the forward
# (the float32 S and the two shifts carried across the seam); the serve
# launcher. A random-weight rwkv6-3b in bf16 is chaotic: a relative 1e-6
# change in the recurrence's output moves its logits by tens of percent,
# in the JAX package too (tests/torch_parity_report.py --only
# rwkv6_sensitivity; PERF.md, RWKV6). So the bf16 logits and decode seam
# are read, and held in the float32 run, where that gain stays small.
RWKV_ARCH = "rwkv6-3b"
WKV_SHAPES = [(1, LM_T, 40, 64, "bfloat16", 0.0),
              (2, 77, 40, 64, "bfloat16", 0.0),
              (3, 1000, 4, 16, "float32", 0.0),
              (1, 1000, 40, 64, "bfloat16", 3.0)]
# pinned from the card (PERF.md, RWKV6): 1.9e-6 at most, over WKV_SHAPES
# and every layer's own inputs in bf16 and float32
WKV_TOL = 1e-5
# the float32 decode seam: 2.7e-5 measured (PERF.md, RWKV6)
RWKV_DECODE_TOL = 1e-3
# the phase's time limit: the plain forward steps every layer's
# recurrence in Python (8192 steps x 32 layers)
RWKV_PHASE_S = 120

# Phase 19 ([nm]): Nelder-Mead, the paper's baseline, on the card. The
# claims of tests/test_abo.py at its sizes: the sphere at n = 2 from 5.0
# below 1e-6 within 2000 evaluations; at n = 200 from 141.6, ABO's fun
# below Nelder-Mead's with Nelder-Mead's budget ABO's own fe (Griewank in
# its direct form, griewank_naive: the tile form pads each of the 201
# vertices to 4096 coordinates); the MemoryError at n = 1e5 under 8 GiB.
# Then one run read, not held: n = 1e4 (a 400 MB float32 simplex) at
# max_fe = 5n (a shrink costs n evaluations).
NM_SPHERE = (2, 5.0, 2000)
NM_N, NM_X0 = 200, 141.6
NM_TURN_IT = 640           # iterations of each graph-or-eager turn at NM_N
NM_CRASH_N, NM_BUDGET = 100_000, 8 << 30
NM_READ_N = 10_000
NM_READ_FE = 5 * NM_READ_N
NM_PHASE_S = 120

# Phase 20 ([examples]): each examples_torch/ script in a child process on
# the card, all at once (each reads its own device times). quickstart at
# its default n = 1e6 is held to phase 6's 1e-6; calibrate_watershed at
# n = 1e5 to the JAX package's own residual there (examples/
# calibrate_watershed.py's objective, abo_minimize with n_passes=6, XLA:CPU,
# float32) with 0.1% for the card's order of summation; solve_service
# drains its 12 jobs; serve_decode answers its 12 requests; train_lm_abo
# runs EXAMPLE_TRAIN_STEPS of each optimizer to finite losses.
EXAMPLE_WATERSHED_N = 100_000
EXAMPLE_WATERSHED_JAX = 0.0060116201639175415
EXAMPLE_TRAIN_STEPS = 5
EXAMPLES_PHASE_S = 180

# Phase 21 ([whisper]): whisper-small at full width (arXiv:2212.04356; 12
# encoder and 12 decoder layers, d 768, 12/12 heads of 64, vocab 51,865),
# bf16, random weights from the seed, nothing cut. The frames stand in for
# the stubbed conv front end: (WHISPER_B, encoder_len = 1500, 768) from the
# seed; the decoder reads WHISPER_T tokens, whisper's published text
# context. K3 runs at head_dim 64 on the mma.sync kernel: the encoder's
# self-attention (non-causal, 1500 keys: 23 blocks of 64 and a ragged 28),
# the decoder's causal self-attention and its cross-attention (sq = 448,
# sk = 1500), 36 launches a forward.
WHISPER_ARCH = "whisper-small"
WHISPER_B, WHISPER_T = 4, 448
WHISPER_DECODE = 8
# fill_cross_cache + 8 decode steps against the forward's logits at
# positions 0..7, over the max |logit|: pinned from the first card reading,
# 0.01207 (PERF.md, whisper-small), at about twice it
WHISPER_DECODE_TOL = 0.025
WHISPER_PHASE_S = 60

# Phase 22 ([vlm]): qwen2-vl-7b at full width (arXiv:2409.12191; 28 layers,
# d 3584, 28/4 heads of 128, d_ff 18,944, vocab 152,064, M-RoPE sections
# (16, 24, 24), theta 1e6), bf16, random weights from the seed, nothing
# cut. The vision front end is a stub in both packages, and so is the
# position layout, which this phase builds: one request of LM_T positions
# with a VLM_GRID x VLM_GRID "image" from VLM_IMAGE_AT, each patch's ids
# (start, start + row, start + col), and every other position i text with
# ids (i, i, i). For the forward with ``embeds`` the image's span carries
# N(0, 1) patch embeddings scaled to the embedding table's std. K3 runs at
# VLM_ATTN_SHAPE, a GQA group of 7.
VLM_ARCH = "qwen2-vl-7b"
VLM_IMAGE_AT, VLM_GRID = 1024, 32
# M-RoPE on the card against a float64 run of it on the CPU (mrope_f64),
# as max abs diff over max |want|: bf16's own rounding is 2^-8
VLM_ROPE_TOL = 1e-2
# the int8 KV cache: VLM_INT8_T tokens decoded from an empty cache against
# the forward over them, held to tests/test_prefill.py's claims
VLM_INT8_T = 128
VLM_INT8_REL = 0.15
VLM_INT8_AGREE = 0.9
VLM_STEPS_8200 = 4           # decode steps timed against 8200-slot caches
VLM_PHASE_S = 90
# Phase 23, the other dense decoders at full width (bf16, random weights
# from the seed, nothing cut), one at a time: each serves one LM_T-token
# request through the prefill step, its forward against the plain
# attention's, prefill + LM_DECODE decode steps, and the launcher
# (``lm_serving``, ``lm_launcher``, as phases 12-13 serve mistral-nemo-12b);
# K3 at its layer shape timed in turns with SDPA. granite-20b also
# prefills DENSE_LONG_T tokens (the assigned prefill_32k length, the end of
# its learned table) and takes AdamW steps cut to ADAMW_LAYERS of its 52
# layers, as phase 15 (d) does for mistral-nemo-12b.
DENSE_ARCHS = ("granite-20b", "internlm2-20b", "h2o-danube-3-4b")
DENSE_ATTN_SHAPES = {"granite-20b": (1, 48, 1, 8192, 8192, 128, True, None),
                     "internlm2-20b": (1, 48, 8, 8192, 8192, 128, True, None),
                     "h2o-danube-3-4b": (1, 32, 8, 8192, 8192, 120, True,
                                         4096)}
DENSE_LONG_ARCH = "granite-20b"
DENSE_LONG_T = 32768
DENSE_LONG_SHAPE = (1, 48, 1, DENSE_LONG_T, DENSE_LONG_T, 128, True, None)
DENSE_BWD_SHAPE = (8, 48, 1, 512, 512, 128, True, None, "bfloat16")
DENSE_PHASE_S = 240
# Phase 24, the recurrent families' and whisper-small's training at full
# width (``[rtrain]``): (a) the backward kernels the path adds, each
# against its plain version run on the card, twice for the bits, then timed
# on the device alone beside that held call's time (K3-bwd in turns with
# the mma.sync kernel and SDPA's backward):
# S-bwd (``rglru_lru_bwd``) at S_BWD_SHAPES, W-bwd (``rwkv6_wkv_bwd``) at
# W_BWD_SHAPES, K3-bwd at head_dim 256 (``flash_attention_bwd_sm90_d256``)
# at D256_BWD_SHAPES and at head_dim 64 (``flash_attention_bwd_sm90_d64``)
# at WHISPER_BWD_SHAPES, each gradient held as max |got - want| over max
# |want|
# (RTRAIN_TOL: float32 outputs sum in other orders over up to 4096 steps;
# bf16 outputs are one bf16 spacing, 2^-8, apart where a rounding flips)
# and K3-bwd also per row (BWD_TOL, BWD_ROW_TOL); (b) AdamW through
# make_train_step with remat at full width on recurrentgemma-2b and rwkv6-3b
# (bf16, random weights from the seed, nothing cut; 1 x RTRAIN_T tokens of
# the bigram stream, train_4k's length, so that recurrentgemma's 2048-token
# window applies): step 1's loss and every gradient against the same step
# with every kernel's plain version (``plain_recurrent``: the plain
# attention, S's and W's plain forward with their plain backward),
# ADAMW_LOSS_TOL and ADAMW_GRAD_TOL; rwkv6's random-weight bf16 model is
# chaotic (ROADMAP "Known about the reference"), so its bf16 gradients are
# read and they are held on the float32 model cut to RWKV_HOLD_LAYERS of its
# 32 layers (the plain loops' time); then RTRAIN_STEPS steps timed (wall,
# peak memory over the parameter bytes, the launches of every kernel a
# step, forward and backward apart, no plain version called); (c) one
# ABO-ZO step on each of the three whole models (the loss at or below the
# incumbent; peak memory against twice the parameter bytes plus one
# forward's own peak: at 4096 tokens recurrentgemma's float32 logits alone
# outweigh half its parameters); (d) whisper-small's AdamW step (4 x 448
# tokens over 4 x 1500 stub frames) held as (b), its 36 K3-bwd launches all
# of ``flash_attention_bwd_sm90_d64``; (e) ``launch.train``'s own loop,
# AdamW on recurrentgemma-2b and ABO-ZO on rwkv6-3b, RTRAIN_STEPS steps
# each.
RTRAIN_T = 4096
RTRAIN_STEPS = 2
S_BWD_SHAPES = [(1, RTRAIN_T, 2560, "bfloat16"), (3, 1000, 2568, "float32"),
                (2, 65, 264, "bfloat16")]
W_BWD_SHAPES = [(1, RTRAIN_T, 40, 64, "bfloat16", 0.0),
                (1, 1000, 40, 64, "float32", 0.0),
                (2, 77, 40, 64, "float32", 3.0),
                (3, 100, 4, 16, "bfloat16", 0.0)]
D256_BWD_SHAPES = [
    (1, 10, 1, RTRAIN_T, RTRAIN_T, 256, True, 2048, "bfloat16"),  # the path
    (1, 10, 1, 1000, 1000, 256, True, 2048, "bfloat16"),  # T below the window
    (2, 8, 2, 640, 640, 256, True, 300, "bfloat16"),      # GQA
    (1, 2, 1, 77, 77, 256, True, None, "bfloat16"),       # ragged, no window
]
# whisper-small's K3-bwd shapes (bf16, head_dim 64, the model's layout):
# the encoder's 1500 frames, cross-attention of 448 tokens over them, the
# decoder's causal self-attention; the last is held against float64
WHISPER_BWD_SHAPES = [
    (4, 12, 12, 1500, 1500, 64, False, None, "bfloat16"),   # encoder
    (4, 12, 12, 448, 1500, 64, False, None, "bfloat16"),    # cross
    (4, 12, 12, 448, 448, 64, True, None, "bfloat16"),      # decoder self
]
RTRAIN_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
RWKV_HOLD_LAYERS = 2
RTRAIN_ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
RTRAIN_PHASE_S = 240


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_F32_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k2_bound_ms(x) -> tuple[float, str, dict]:
    """Least time for K2 on ``x``: its bytes (x read once) at the memory
    rate, against Griewank's own instructions (K2_FN: the common ones and,
    per coordinate, those of the branch it takes on this data) at each
    pipe's rate and the issue rate, and against the fold's chain of
    dependent adds, one per tile, which can run beside the pass. Beside it,
    the same issue rate applied to what this build issues (K2_SASS, per
    warp, both branches where a warp's coordinates take both, and per
    tile)."""
    import torch
    n = x.numel()
    i1 = torch.arange(1, n + 1, device=x.device).to(torch.float32)
    low = torch.sin(x * torch.rsqrt(i1)).square() < 0.5
    n_low = int(low.sum())
    ops = {p: n * K2_FN["common"][p] + n_low * K2_FN["log1p"][p]
           + (n - n_low) * K2_FN["log"][p] for p in PIPE_RATE}
    lanes = SMS * CLOCK_HZ
    per_pipe = {p: v / (PIPE_RATE[p] * lanes) for p, v in ops.items()}
    t_issue = max(sum(ops.values()) / (ISSUE_LANES * lanes),
                  *per_pipe.values())
    tiles = -(-n // 4096)
    t_fold = tiles * FADD_CLOCKS / CLOCK_HZ
    t_bytes = (4 * n + 4 * 128) / PEAK_BYTES_S
    t_ops = max(t_issue, t_fold)
    by = "operations" if t_ops >= t_bytes else "bytes"
    low = torch.cat([low, low.new_ones((-n) % 32)]).view(-1, 32)
    warps = low.shape[0]
    on_log1p, on_log = int(low.any(1).sum()), int((~low).any(1).sum())
    built = (warps * K2_SASS["common"] + on_log1p * K2_SASS["log1p"]
             + on_log * K2_SASS["log"] + tiles * K2_SASS["tile"])
    return 1e3 * max(t_ops, t_bytes), by, {
        "issue_ms": 1e3 * t_issue, "fold_ms": 1e3 * t_fold,
        "bytes_ms": 1e3 * t_bytes,
        "pipe_ms": {p: 1e3 * t for p, t in per_pipe.items()},
        "function_instructions_per_coordinate": sum(ops.values()) / n,
        "coordinates_on_log1p": n_low,
        "build_instructions_per_coordinate": built * 32 / n,
        "build_issue_ms": 1e3 * built / (4 * lanes)}


def row_rel_err(got, want) -> float:
    """Max over query rows of the row's max |got - want| over its max
    |want|."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def import_port():
    """Put the checkout's ``src`` first on the path and import the port
    from there; fails when the sources are not beside this script."""
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, src)
    import repro_torch
    check(os.path.dirname(os.path.abspath(repro_torch.__file__))
          == os.path.join(src, "repro_torch"),
          f"imported repro_torch from {repro_torch.__file__}, not {src}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _qkv(dev, seed, b, hq, hkv, sq, sk, d, dtype):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + sq + d)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def engine_limit(objective: str, n: int) -> float:
    v = ENGINE_JAX_FUN[(objective, n)]
    return 1e-6 if v < 1e-6 else v * 1.001


def tile_sum_readings(dev, seed: int) -> list[tuple[int, bool, bool]]:
    """One 4096-wide Griewank tile (global tile 1000) summed alone and as
    the middle row of slabs of 1, 2, 3, 17 and 256 rows: per slab, whether
    the port's tile sum (a halving tree) and the former ``.sum(dim=1)``
    give the lone tile's bits."""
    import torch
    from repro_torch.objectives import GRIEWANK
    tile, t_idx = 4096, 1000

    def old_sum(xt, first):
        rows = xt.shape[0]
        idx = (first * tile + torch.arange(rows * tile, device=dev)).view(
            rows, tile)
        return GRIEWANK.terms(idx, xt).sum(dim=1)

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(tile, generator=g, device=dev) * 1200 - 600
    new1 = GRIEWANK._tile_sums(x.view(1, tile), t_idx, 10**9,
                               torch.float32)[0]
    old1 = old_sum(x.view(1, tile), t_idx)[0]
    out = []
    for rows in (1, 2, 3, 17, 256):
        slab = torch.rand((rows, tile), generator=g, device=dev) * 1200 - 600
        pos = rows // 2
        slab[pos] = x
        new = GRIEWANK._tile_sums(slab, t_idx - pos, 10**9,
                                  torch.float32)[pos]
        old = old_sum(slab, t_idx - pos)[pos]
        out.append((rows, bool(torch.equal(new, new1)),
                    bool(torch.equal(old, old1))))
    return out


def row_step_costs(dev, objective: str) -> dict:
    """One engine row step at the 24-job run's width, 8 lanes at n = 1e5
    of one objective (25 row steps a pass), in a steady-state pass (no
    refill, no harvest; the pass's lane re-sync included): the CUDA
    kernels, the dispatched (non-view) operators and the kernels' summed
    device time per row step, from a pass under the profiler and a
    dispatch mode; and the wall time per row step of the next pass,
    unprofiled, from its start to the card's finish."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.engine import JobSpec, SolveEngine
    from repro_torch.core import ABOConfig

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    eng = SolveEngine(lanes=8, max_fuse=1, device=dev)
    eng.submit_many(JobSpec(objective, 100000, ABOConfig(), seed=i)
                    for i in range(8))
    eng.step()                                  # placement and pass 1
    torch.cuda.synchronize()
    rows = eng.row_steps
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        with OpCount() as ops:
            eng.step()                          # pass 2: steady state
        torch.cuda.synchronize()
    rows = eng.row_steps - rows
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    before = eng.row_steps
    t0 = time.perf_counter()
    eng.step()                                  # pass 3, unprofiled
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"kernels": len(kernels) / rows, "operators": ops.n / rows,
            "device_ms": 1e-3 * device_us / rows,
            "wall_ms": 1e3 * wall / (eng.row_steps - before)}


def hold_to_solo(eng, jid: str, dev, run: str, lane: tuple) -> None:
    """Fails unless the engine's job ``jid`` has the fun, x and history of
    the same spec through ``abo_minimize`` on the card, bit for bit, and a
    fun within its limit. ``lane`` is (its slot, its pool's running lanes)
    at its harvest."""
    import torch
    from repro_torch.core import abo_minimize
    from repro_torch.objectives import OBJECTIVES
    got = eng.result(jid)
    spec = eng.jobs[jid].spec
    solo = abo_minimize(OBJECTIVES[spec.objective], spec.n,
                        config=spec.config, seed=spec.seed, device=dev)
    same = (got.fun == solo.fun and torch.equal(got.x, solo.x.cpu())
            and torch.equal(got.history, solo.history.cpu()))
    lim = engine_limit(spec.objective, spec.n)
    print(f"[engine] {run}: {spec.objective} n={spec.n} seed {spec.seed} "
          f"(lane {lane[0]} of {lane[1]}): engine fun {got.fun!r}, abo_minimize {solo.fun!r}, "
          f"fun, x and history bit-identical {same}; limit {lim!r}",
          flush=True)
    check(same, f"engine job {jid} ({run}) differs from abo_minimize")
    check(got.fun < lim, f"engine {spec.objective} n={spec.n}: fun "
          f"{got.fun} >= {lim}")


def engine_phase(dev, seed: int) -> dict:
    """Phase 7: the solve engine on the card through the port's
    solve_server batch mode (see ENGINE_MAIN and ENGINE_SANITIZED).
    Returns the 24-job run's results, ``{job id: (fun, history, x)}``,
    which phase 9's resumed runs are held to."""
    import torch
    from repro_torch.engine import scheduler
    from repro_torch.kernels.coord_sweep.ops import sweep_pass
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_mma, flash_attention_sm90)
    from repro_torch.kernels.griewank.ops import griewank_aggregates
    from repro_torch.launch import solve_server

    t_phase = time.perf_counter()
    readings = tile_sum_readings(dev, seed)
    print("[engine] one tile in slabs of (rows, halving tree == alone, "
          f".sum(dim=1) == alone): {readings}", flush=True)
    check(all(new for _, new, _ in readings),
          "the tile sum depends on the slab it is reduced in")

    counters = (sweep_pass, griewank_aggregates, flash_attention,
                flash_attention_mma, flash_attention_sm90)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the pool bytes after each step, and each finishing job's (slot, the
    # pool's running lanes) at its harvest: the hooks read host metadata
    pool_bytes, lanes = [], {}
    step, harvest = scheduler.SolveEngine.step, scheduler.SolveEngine._harvest

    def sampled_step(self):
        out = step(self)
        pool_bytes.append(self.memory_stats()["pool_device_bytes"])
        return out

    def sampled_harvest(self, pool, ops):
        lanes.update((jid, (slot, pool.active))
                     for slot, jid in enumerate(pool.job_ids) if jid)
        return harvest(self, pool, ops)

    scheduler.SolveEngine.step = sampled_step
    scheduler.SolveEngine._harvest = sampled_harvest
    try:
        t0 = time.perf_counter()
        stats, eng = solve_server.run(ENGINE_MAIN)
        took = {"main": time.perf_counter() - t0}
        peak = torch.cuda.max_memory_allocated()
        main_lanes, lanes = lanes, {}
        t0 = time.perf_counter()
        stats_s, eng_s = solve_server.run(ENGINE_SANITIZED)
        took["sanitized"] = time.perf_counter() - t0
    finally:
        scheduler.SolveEngine.step = step
        scheduler.SolveEngine._harvest = harvest
    after = eng.memory_stats()
    waste = eng.pad_stats()["swept_waste"]
    wall = stats["dt_s"]
    print(f"[engine] solve_server {' '.join(ENGINE_MAIN[:6])}: "
          f"{stats['done']} jobs in {wall:.3f} s over {stats['steps']} "
          f"steps, {stats['jobs_per_s']:.4f} jobs/s, "
          f"{stats['fe_per_s']:.4g} probes/s; {eng.row_steps} row steps, "
          f"{1e3 * wall / eng.row_steps:.4f} ms per row step (wall / row "
          f"steps); swept-row waste {waste!r}; peak device memory {peak} B, "
          f"pool bytes at most {max(pool_bytes)} B over the steps, "
          f"{after['pool_device_bytes']} B after the drain "
          f"({after['pool_pages']} pages, {after['pool_slots']} slots, "
          f"{len(eng.pools)} families)", flush=True)
    by_pair: dict = {}
    for rec in eng.jobs.values():
        by_pair.setdefault((rec.spec.objective, rec.spec.n), []).append(
            (rec.spec.seed, rec.fun if rec.status == "done" else math.inf))
    for (name, n), funs in sorted(by_pair.items()):
        lim = engine_limit(name, n)
        worst = max(f for _, f in funs)
        print(f"[engine] {name} n={n}: fun by seed {sorted(funs)} (limit "
              f"{lim!r})", flush=True)
        check(worst < lim, f"engine {name} n={n}: fun {worst} >= {lim}")
    launches = {k.__name__: k.launches for k in counters}
    t0 = time.perf_counter()
    for jid, rec in sorted(eng.jobs.items()):
        if rec.spec.seed in ENGINE_MAIN_SOLO_SEEDS:
            hold_to_solo(eng, jid, dev, "24-job run", main_lanes[jid])
            check(main_lanes[jid][1] >= 2, f"job {jid} had its rows alone")
    took["abo_minimize_main"] = time.perf_counter() - t0
    check(stats["done"] == 24 and len(by_pair) == 3,
          f"the engine finished {stats['done']} of 24 jobs")
    check(not any(launches.values()),
          f"the engine launched kernels {launches}; it runs none")
    check(after["pool_pages"] <= len(eng.pools)
          and after["pool_device_bytes"] < max(pool_bytes),
          f"the pools did not shrink after the drain: {after}")
    results = {jid: (rec.fun, list(rec.history), rec.x)
               for jid, rec in eng.jobs.items()}
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for jid in sorted(eng_s.jobs):
        hold_to_solo(eng_s, jid, dev, "sanitized", lanes[jid])
    check(stats_s["done"] == 3 and stats_s["sanitize"], "the sanitized run "
          "did not finish its 3 jobs")
    took["abo_minimize"] = time.perf_counter() - t0
    del eng_s
    t0 = time.perf_counter()
    per_step = {name: row_step_costs(dev, name)
                for name in ("griewank", "sphere", "rastrigin")}
    took["row_step_costs"] = time.perf_counter() - t0
    for name, c in per_step.items():
        print(f"[engine] {name} row step at width 8 (n = 1e5, a steady-state "
              f"pass): {c['kernels']:.2f} CUDA kernels, {c['operators']:.2f} "
              f"dispatched operators, {c['device_ms']:.5f} ms of kernel time "
              f"(profiled pass), {c['wall_ms']:.5f} ms of wall time "
              f"(next pass, unprofiled)", flush=True)
        check(c["device_ms"] > 0, f"{name}: no row-step kernel time read")
    check(not any(k.launches for k in counters),
          "the engine launched a kernel")
    total = time.perf_counter() - t_phase
    print(f"[engine] phase took {total:.1f} s (limit {ENGINE_PHASE_S} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()), flush=True)
    check(total <= ENGINE_PHASE_S, f"the engine phase took {total:.1f} s")
    torch.cuda.empty_cache()
    return results


def f64_limit(key: str) -> float:
    v = F64_JAX_FUN[key]
    return 1e-6 if v < 1e-6 else v * 1.001


def f64_phase(dev) -> None:
    """Phase 8: the paper's double-precision path on the card. The plain
    route on Griewank in float64 at F64_N, then F64_ENGINE's three float64
    jobs through the engine, each bit for bit abo_minimize's."""
    import torch
    from repro_torch.core import ABOConfig, abo_minimize
    from repro_torch.engine import JobSpec, SolveEngine
    from repro_torch.objectives import GRIEWANK, OBJECTIVES

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = abo_minimize(GRIEWANK, F64_N, dtype=torch.float64, seed=0,
                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    blocks = 5 * -(-F64_N // 4096)
    key = f"griewank,{F64_N},0"
    lim = f64_limit(key)
    print(f"[f64] griewank n={F64_N} float64 seed 0, plain route: fun "
          f"{r.fun!r} (limit {lim!r}; the JAX package under x64 "
          f"{F64_JAX_FUN[key]!r}), wall {wall:.2f} s, {r.fe / wall:.4g} "
          f"probes/s, {1e3 * wall / blocks:.4f} ms per block ({blocks} "
          f"blocks), peak device memory {peak} B = "
          f"{peak / (8 * F64_N):.4f} x solution bytes {8 * F64_N}; history "
          f"{r.history.tolist()}", flush=True)
    check(tuple(r.x.shape) == (F64_N,) and r.x.dtype == torch.float64
          and r.history.dtype == torch.float64
          and bool(torch.isfinite(r.x).all()),
          "the float64 solve's x or history is not float64 and finite")
    check(r.fun < lim, f"float64 griewank fun {r.fun} >= {lim}")
    del r
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = SolveEngine(lanes=3, dtype=torch.float64, device=dev)
    specs = [JobSpec(name, n, ABOConfig(), seed=seed)
             for name, n, seed in F64_ENGINE]
    ids = eng.submit_many(specs)
    eng.run()
    print(f"[f64] engine, {len(specs)} float64 jobs on 3 lanes: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for spec, jid in zip(specs, ids):
        got = eng.result(jid)
        solo = abo_minimize(OBJECTIVES[spec.objective], spec.n,
                            seed=spec.seed, dtype=torch.float64, device=dev)
        same = (got.fun == solo.fun and torch.equal(got.x, solo.x.cpu())
                and torch.equal(got.history, solo.history.cpu()))
        lim = f64_limit(f"{spec.objective},{spec.n},{spec.seed}")
        print(f"[f64] engine {spec.objective} n={spec.n} seed {spec.seed}: "
              f"fun {got.fun!r}, abo_minimize {solo.fun!r}, fun, x and "
              f"history bit-identical {same}, history {got.history.dtype}; "
              f"limit {lim!r}", flush=True)
        check(same and got.history.dtype == torch.float64,
              f"float64 engine job {jid} differs from abo_minimize")
        check(got.fun < lim, f"float64 engine {spec.objective}: fun "
              f"{got.fun} >= {lim}")
    del eng
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[f64] phase took {total:.1f} s (limit {F64_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= F64_PHASE_S, f"the float64 phase took {total:.1f} s")


# Run in each [ckpt] and [http] child: refuses JAX, the JAX package and
# its benchmarks at import, then runs the ``main`` of the port's module
# named by the second argument (the port's solve_server or router) with
# the rest of the arguments (the first is the port's source directory).
PORT_CHILD = r"""
import importlib
import sys
FOREIGN = ("jax", "jaxlib", "repro", "benchmarks")


class NoForeign:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ImportError(f"a chip_smoke child imported {name}")
        return None


sys.meta_path.insert(0, NoForeign())
sys.path.insert(0, sys.argv[1])
importlib.import_module(sys.argv[2]).main(sys.argv[3:])
foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
if foreign:
    raise SystemExit(f"a chip_smoke child imported {foreign[:5]}")
"""


def port_child(module: str, argv: list) -> list:
    """The command line of a PORT_CHILD running ``module``'s main."""
    return [sys.executable, "-c", PORT_CHILD, os.path.join(ROOT, "src"),
            module, *argv]


def ckpt_child(argv: list, inject: str, timeout: float):
    """The port's solve_server with ``argv`` in a child process under
    ``REPRO_INJECT_FAULTS=inject``; killed at ``timeout``."""
    env = dict(os.environ, REPRO_INJECT_FAULTS=inject)
    return subprocess.run(port_child("repro_torch.launch.solve_server", argv),
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def run_fsck(d: str, repair: bool) -> tuple[int, list]:
    """``python -m repro_torch.checkpoint.fsck d [--repair]``: its exit
    code and the kinds of its findings."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.checkpoint.fsck",
                          d] + (["--repair"] if repair else []),
                         capture_output=True, text=True, env=env, timeout=120)
    kinds = sorted(f["kind"] for f in json.loads(out.stdout)["findings"])
    return out.returncode, kinds


def ckpt_phase(dev, uninterrupted: dict) -> None:
    """Phase 9: kill and resume at phase 7's size (see CKPT_SNAPSHOT_KILL
    and CKPT_JOURNAL_KILL); ``uninterrupted`` is phase 7's results."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.engine import scheduler

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # every snapshot of the resumed runs, timed whole (the host read-back
    # of every pool and np.save), and the bytes it committed
    snaps: list = []
    snapshot = scheduler.SolveEngine._snapshot

    def timed_snapshot(self):
        t0 = time.perf_counter()
        out = snapshot(self)
        ms = 1e3 * (time.perf_counter() - t0)
        step = self.ckpt.dir / f"step_{self.step_count:012d}"
        snaps.append((ms, sum(f.stat().st_size for f in step.iterdir())))
        return out

    parts: dict = {}           # the phase's wall in parts, from its prints
    cases = (("snapshot kill", CKPT_SNAPSHOT_KILL, ["--ckpt-every", "1"],
              "tmp_snapshot", {}),
             ("journal kill", CKPT_JOURNAL_KILL, ["--journal-every", "2"],
              "torn_tail", {"lanes": 8, "journal_every": 2}))
    for what, inject, flags, finding, fresh_kw in cases:
        d = os.path.join(root, what.split()[0])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = ckpt_child(ENGINE_MAIN + ["--ckpt-dir", d] + flags, inject,
                         timeout=CKPT_PHASE_S)
        t_child = time.perf_counter() - t0
        print(f"[ckpt] {what}: solve_server {' '.join(flags)} under "
              f"REPRO_INJECT_FAULTS={inject} exited {out.returncode} after "
              f"{t_child:.1f} s", flush=True)
        check(out.returncode == 137, f"[ckpt] {what}: the child exited "
              f"{out.returncode}, not 137: {out.stderr[-2000:]}")
        t0 = time.perf_counter()
        rc, kinds = run_fsck(d, repair=False)
        rc_fix, _ = run_fsck(d, repair=True)
        rc_after, kinds_after = run_fsck(d, repair=False)
        t_fsck = time.perf_counter() - t0
        print(f"[ckpt] {what}: fsck exit {rc} findings {kinds}; --repair "
              f"exit {rc_fix}; then exit {rc_after} findings {kinds_after}",
              flush=True)
        check(rc == 1 and kinds == [finding] and rc_fix == 0
              and rc_after == 0 and not kinds_after,
              f"[ckpt] {what}: fsck did not report and repair {finding}")
        scheduler.SolveEngine._snapshot = timed_snapshot
        snaps.clear()
        try:
            t0 = time.perf_counter()
            eng = scheduler.SolveEngine.resume(d, device=dev, **fresh_kw)
            t_resume = time.perf_counter() - t0
            js = eng.ckpt.journal_stats()
            left = eng.pending()
            durable = sorted(eng.jobs)
            t0 = time.perf_counter()
            eng.run()
            t_run = time.perf_counter() - t0
        finally:
            scheduler.SolveEngine._snapshot = snapshot
        with_x = 0
        for jid in durable:
            rec = eng.jobs[jid]
            fun, hist, x = uninterrupted[jid]
            check(rec.status == "done",
                  f"[ckpt] {what}: {jid} ended {rec.status}")
            same = rec.fun == fun and rec.history == hist
            if rec.x is not None:
                same = same and np.array_equal(rec.x, x)
                with_x += 1
            check(same, f"[ckpt] {what}: {jid} differs from phase 7's "
                  "uninterrupted run")
        ms = [m for m, _ in snaps]
        print(f"[ckpt] {what}: resume {t_resume:.3f} s, work left {left}, "
              f"{len(durable)} durable jobs, journal {js['records']} records"
              f" / {js['bytes']} B at resume; resumed drain {t_run:.2f} s; "
              f"all {len(durable)} DONE with phase 7's fun and history, x "
              f"too for {with_x}; {len(ms)} snapshots, at most "
              f"{max((b for _, b in snaps), default=0)} B, "
              f"{sum(ms) / max(len(ms), 1):.1f} ms per snapshot write (mean; "
              f"max {max(ms, default=0.0):.1f} ms)", flush=True)
        check(left and durable, f"[ckpt] {what}: nothing was left to resume")
        check(bool(ms), f"[ckpt] {what}: the resumed run cut no snapshot")
        parts[what] = {"child to its kill": t_child,
                       "3 fsck processes": t_fsck, "resume": t_resume,
                       "resumed drain": t_run}
        del eng
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    named = sum(sum(p.values()) for p in parts.values())
    print(f"[ckpt] phase parts (s): "
          + "; ".join(f"{w}: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                           p.items())
                      for w, p in parts.items())
          + f"; the rest (checks, copies) {total - named:.1f}", flush=True)
    print(f"[ckpt] phase took {total:.1f} s (limit {CKPT_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= CKPT_PHASE_S, f"the checkpoint phase took {total:.1f} s")


# Polls a server's /healthz from its own process (so the parent's JSON
# parsing cannot delay a probe) until the stop file appears, then writes
# what it saw to the out file. "healthz": each probe's latency (ms; None
# for a failure). "router": the wall-clock time w0's first listener stops
# answering (connection refused or reset: the kill) and the time a later
# w0, at the port the router's /healthz names, first answers /healthz 200.
HTTP_PROBE = r"""
import http.client, json, os, sys, time
port, mode, stop, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
first = int(sys.argv[5]) if len(sys.argv) > 5 else None


def get(p, path):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", p, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, body, 1e3 * (time.perf_counter() - t0)
    finally:
        conn.close()


lat, dead, up = [], None, None
while not os.path.exists(stop):
    if mode == "healthz":
        try:
            lat.append(get(port, "/healthz")[2])
        except (OSError, http.client.HTTPException):
            lat.append(None)
    elif dead is None:
        try:
            get(first, "/healthz")
        except (ConnectionError, http.client.HTTPException):
            dead = time.time()
        except OSError:
            pass
    elif up is None:
        try:
            w0 = json.loads(get(port, "/healthz")[1])["workers"]["w0"]
            if w0["port"] not in (None, first) \
                    and get(w0["port"], "/healthz")[0] == 200:
                up = time.time()
        except (OSError, http.client.HTTPException, ValueError):
            pass
    time.sleep(0.02)
with open(out, "w") as fh:
    json.dump({"ms": lat, "dead": dead, "up": up}, fh)
"""


def http_call(port: int, method: str, path: str, body=None,
              timeout: float = 120.0):
    """One request on its own connection: (status, body bytes, headers,
    ms from the request to the reply's last byte)."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, data, dict(resp.getheaders()),
                1e3 * (time.perf_counter() - t0))
    finally:
        conn.close()


def retry_after_s(headers: dict) -> float:
    """How long a client waits before it retries a 503: the reply's
    Retry-After, at most 1 s, as the reference's chaos test waits (the
    router sizes it from its restarts' mean time, 5 s before the first)."""
    return min(float(headers.get("Retry-After", 1)), 1.0)


def http_submit(port: int, rec: dict, t_end: float, retry: tuple) -> None:
    """Submits ``rec["job"]`` (objective, n, seed) with HTTP_CFG, retrying
    a 503 whose code is in ``retry`` after its Retry-After. Adds to
    ``rec`` every (status, code) seen and, once accepted, the job id, the
    wall-clock time of the ack and the accepted call's ms."""
    name, n, seed = rec["job"]
    body = json.dumps({"objective": name, "n": n, "seed": seed,
                       "config": HTTP_CFG})
    while time.perf_counter() < t_end:
        st, data, hdrs, ms = http_call(port, "POST", "/submit", body)
        out = json.loads(data)
        rec["statuses"].append((st, out.get("code")))
        if st == 200:
            rec.update(jid=out["job_id"], t_ack=time.time(), submit_ms=ms)
            return
        if st != 503 or out.get("code") not in retry:
            return
        time.sleep(retry_after_s(hdrs))


def http_result(port: int, rec: dict, t_end: float, retry: tuple) -> None:
    """Long-polls the result of ``rec``'s job (``/result?wait=30``) until a
    200, retrying 202s and the 503s whose code is in ``retry``; adds the
    statuses seen, the 200's raw body, its bytes and ms, and the wall-
    clock time it arrived."""
    path = f"/result?job_id={rec['jid']}&wait=30"
    while time.perf_counter() < t_end:
        st, data, hdrs, ms = http_call(port, "GET", path)
        if st == 200:
            rec["statuses"].append((st, None))
            rec.update(raw=data, bytes=len(data), ms=ms, t_done=time.time())
            return
        code = json.loads(data).get("code")
        rec["statuses"].append((st, code))
        if st == 503 and code in retry:
            time.sleep(retry_after_s(hdrs))
        elif st != 202:
            return


def parse_result(rec: dict) -> None:
    """Replaces ``rec``'s raw reply with its payload without x (``out``)
    and x as float64 (``x``, None where the reply carries none)."""
    import numpy as np
    out = json.loads(rec.pop("raw"))
    x = out.pop("x", None)
    rec.update(out=out, x=None if x is None else np.asarray(x, np.float64))


def in_threads(fn, recs: list, t_end: float) -> float:
    """``fn(rec)`` for every record, each on a thread of its own, all
    started together; the seconds until the last one ended. An exception
    is kept as the record's ``error``."""
    import threading

    def one(rec):
        try:
            fn(rec)
        except Exception as e:     # noqa: BLE001 — the caller checks it
            rec["error"] = repr(e)

    threads = [threading.Thread(target=one, args=(rec,), daemon=True)
               for rec in recs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(t_end - time.perf_counter(), 1.0))
    check(not any(t.is_alive() for t in threads),
          "[http] a client did not end")
    return time.perf_counter() - t0


def wait_port_file(path: str, proc, timeout: float) -> int:
    """The port a child publishes in ``path``; fails if it exits first."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        check(proc.poll() is None, f"[http] a child exited "
              f"{proc.returncode} before it listened")
        try:
            with open(path) as fh:
                return int(fh.read().strip())
        except (FileNotFoundError, ValueError):
            time.sleep(0.05)
    fail(f"[http] no port in {path} after {timeout} s")


def pct(values: list, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(q * len(s)))]


def stop_child(proc, timeout: float = 60.0) -> int:
    """SIGTERM (a server's clean exit: final snapshot, exit 0), then its
    exit code; its whole process group is killed after ``timeout``."""
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        return -9


def http_phase(dev, uninterrupted: dict) -> None:
    """Phase 10: the serving tier on the card (see HTTP_CFG); each server
    runs in a child process, and each job has a client thread of its own
    (``client``). ``uninterrupted`` is phase 7's results."""
    import shutil
    import signal

    import numpy as np
    import torch
    from repro_torch.core import ABOConfig, abo_minimize
    from repro_torch.objectives import OBJECTIVES

    t_phase = time.perf_counter()
    t_end = t_phase + HTTP_PHASE_S
    root = os.path.join(ROOT, "build", "http_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()
    # the router's workers run ``-m repro_torch.serve.worker``
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    procs, logs = [], []

    def start(cmd, name):
        logs.append(open(os.path.join(root, f"{name}.log"), "w"))
        # a group of its own: the router's workers go down with it
        p = subprocess.Popen(cmd, stdout=logs[-1], stderr=subprocess.STDOUT,
                             env=env, start_new_session=True)
        procs.append(p)
        return p

    def tail(name: str) -> str:
        with open(os.path.join(root, f"{name}.log")) as fh:
            return fh.read()[-3000:]

    def client(port: int, retry: tuple):
        def run(rec):
            http_submit(port, rec, t_end, retry)
            if "jid" in rec:
                http_result(port, rec, t_end, retry)
            if "raw" in rec:
                parse_result(rec)
        return run

    def held(rec: dict, fun, hist, x) -> bool:
        """The client's result is (fun, hist), bit for bit, and x too
        where both sides have it."""
        out = rec["out"]
        same = out.get("status") == "done" and out["fun"] == fun \
            and out["history"] == list(hist)
        if x is not None and rec["x"] is not None:
            same = same and np.array_equal(rec["x"],
                                           np.asarray(x, np.float64))
        return same

    def probe_readings(probe, stop: str, out: str) -> dict:
        open(stop, "w").close()
        check(probe.wait(timeout=60) == 0, "[http] a probe failed")
        with open(out) as fh:
            return json.load(fh)

    try:
        # ---- (a) one worker ---------------------------------------------
        t0 = time.perf_counter()
        pf = os.path.join(root, "a.port")
        trace = os.path.join(root, "a.trace.json")
        child = start(port_child("repro_torch.launch.solve_server",
                                 ["--http", "0", "--port-file", pf,
                                  "--lanes", "8", "--trace", trace]), "a")
        # (b)'s fleet starts now too and idles through (a): a worker steps,
        # and w0's fault can fire, only once (b) sends it work
        pf_b = os.path.join(root, "b.port")
        router = start(port_child(
            "repro_torch.serve.router",
            ["--workers", "2", "--lanes", "2", "--ckpt-dir",
             os.path.join(root, "cluster"), "--port-file", pf_b,
             "--inject-worker", HTTP_INJECT]), "b")
        # (b)'s references, on the card while the children start
        solo = {seed: abo_minimize(OBJECTIVES[name], n,
                                   config=ABOConfig(**HTTP_CFG), seed=seed,
                                   device=dev)
                for name, n, seed in HTTP_W0_JOBS}
        t_solo = time.perf_counter() - t0
        port = wait_port_file(pf, child, 120)
        t_ready = time.perf_counter() - t0
        stop_a, probe_a = (os.path.join(root, f"a.{s}")
                           for s in ("stop", "probe.json"))
        probe = start([sys.executable, "-c", HTTP_PROBE, str(port),
                       "healthz", stop_a, probe_a], "a.probe")
        # the 24 submissions arrive as one burst, as phase 7 submits them
        # all before its drain, and each client long-polls its own job
        recs = [{"job": job, "statuses": []} for job in HTTP_JOBS]
        t_burst = time.perf_counter()
        t0 = time.time()
        in_threads(client(port, ()), recs, t_end)
        wall = max(rec.get("t_done", math.inf) for rec in recs) - t0
        t_burst = time.perf_counter() - t_burst
        steps = json.loads(http_call(port, "GET", "/stats")[1])["steps"]
        lat = probe_readings(probe, stop_a, probe_a)["ms"]
        # one more /result a size with the engine idle: what building and
        # sending x costs, apart from waiting for the job
        again = {n: http_call(port, "GET", f"/result?job_id={rec['jid']}")
                 for rec in recs[:len(HTTP_MIX)]
                 for n in [rec["job"][1]]}
        t_stop = time.perf_counter()
        rc = stop_child(child)
        t_stop = time.perf_counter() - t_stop
        ok_lat = [v for v in lat if v is not None]
        statuses = sorted({s for rec in recs for s in rec["statuses"]})
        check(not any("error" in rec for rec in recs), f"[http] (a) a "
              f"client raised: {[r['error'] for r in recs if 'error' in r]}")
        check(all("out" in rec for rec in recs)
              and {s for s, _ in statuses} <= {200, 202},
              f"[http] (a) statuses {statuses}")
        for rec in recs:
            name, n, seed = rec["job"]
            fun, hist, x = uninterrupted[f"job-{seed:06d}"]
            check(held(rec, fun, hist, x)
                  and (x is None or rec["x"] is not None),
                  f"[http] (a) {rec['jid']} ({name} n={n} seed {seed}) "
                  "differs from phase 7's run")
        check(len(ok_lat) == len(lat) and ok_lat, f"[http] (a) {len(lat)} "
              f"/healthz probes, {len(lat) - len(ok_lat)} failed")
        check(rc == 0, f"[http] (a) exited {rc} on SIGTERM: {tail('a')}")
        with open(trace) as fh:
            spans = [e for e in json.load(fh)["traceEvents"]
                     if e["name"] == "step"]
        submit_ms = [rec["submit_ms"] for rec in recs]
        print(f"[http] (a) solve_server --http --lanes 8: listening "
              f"{t_ready:.1f} s after the spawn (beside (b)'s fleet "
              f"starting, and the parent running (b)'s 6 references on the "
              f"card, {t_solo:.1f} s); "
              f"{len(recs)} jobs from the first submit to the last result "
              f"in {wall:.3f} s, {len(recs) / wall:.4f} jobs/s over {steps} "
              f"engine steps ({1e-6 * sum(e['dur'] for e in spans):.3f} s "
              f"in their trace spans); submit latency p50 "
              f"{pct(submit_ms, 0.5):.2f} ms p99 {pct(submit_ms, 0.99):.2f} "
              f"ms; statuses {statuses}; every fun, history and x bit for "
              f"bit phase 7's; SIGTERM: exit {rc}", flush=True)
        for size, (st, data, _, ms) in sorted(again.items()):
            check(st == 200, f"[http] (a) /result again at n={size}: {st}")
            rs = [r["ms"] for r in recs if r["job"][1] == size]
            print(f"[http] (a) /result at n={size}: {len(data)} B, "
                  f"{ms:.1f} ms from the request to the last byte with the "
                  f"engine idle; the burst's {len(rs)} long-polls "
                  f"{sum(rs) / len(rs):.1f} ms (mean; max {max(rs):.1f} ms, "
                  f"waiting for the job included)", flush=True)
        print(f"[http] (a) /healthz while the steps ran: {len(ok_lat)} "
              f"probes, 0 failed, p50 {pct(ok_lat, 0.5):.2f} ms, max "
              f"{max(ok_lat):.2f} ms", flush=True)

        t_a = time.perf_counter() - t_phase
        # ---- (b) the router, worker 0 killed -------------------------------
        t_b = time.perf_counter()
        rport = wait_port_file(pf_b, router, 60)
        # the router serves once both workers listen
        st, data, _, _ = http_call(rport, "GET", "/healthz", timeout=150)
        health = json.loads(data)
        check(st == 200 and health["status"] == "ok", f"[http] (b) the "
              f"router is not healthy: {st} {health}")
        t_healthy = time.perf_counter() - t_b
        stop_b, probe_b = (os.path.join(root, f"b.{s}")
                           for s in ("stop", "probe.json"))
        probe = start([sys.executable, "-c", HTTP_PROBE, str(rport),
                       "router", stop_b, probe_b,
                       str(health["workers"]["w0"]["port"])], "b.probe")
        ok_503 = ("worker_unavailable", "shutting_down")
        recs = [{"job": job, "statuses": []}
                for job in HTTP_W0_JOBS + HTTP_W1_JOBS]
        wall = in_threads(client(rport, ok_503), recs, t_end)
        seen = probe_readings(probe, stop_b, probe_b)
        health = json.loads(http_call(rport, "GET", "/healthz")[1])
        st_m, metrics, _, _ = http_call(rport, "GET", "/metrics")
        t_stop_b = time.perf_counter()
        rc = stop_child(router)
        t_stop_b = time.perf_counter() - t_stop_b
        statuses = [s for rec in recs for s in rec["statuses"]]
        errors = [rec["error"] for rec in recs if "error" in rec]
        lost = [rec["job"] for rec in recs if "out" not in rec]
        restarts = {w: health["workers"][w]["restarts"] for w in ("w0", "w1")}
        dead, up = seen["dead"], seen["up"]
        at_risk = sum(1 for rec in recs
                      if rec.get("jid", "").startswith("w0:")
                      and dead is not None and rec["t_ack"] < dead
                      and rec.get("t_done", math.inf) > dead)
        print(f"[http] (b) router --workers 2 --lanes 2 --inject-worker "
              f"{HTTP_INJECT}: {len(recs)} jobs in {wall:.3f} s; statuses "
              f"{sorted(set(statuses))}; {len(lost)} lost; restarts "
              f"{restarts}; w0's acked jobs pending at the kill: {at_risk}; "
              f"time to recover (kill to w0's first healthy probe) "
              f"{'not seen' if None in (dead, up) else f'{up - dead:.3f} s'}"
              f"; SIGTERM: exit {rc}", flush=True)
        check(not errors, f"[http] (b) a client raised: {errors[:3]}")
        # what each lost job saw: its id, its last statuses and whether the
        # phase's time ran out, with the router's and workers' log
        seen_lost = [(rec["job"], rec.get("jid"), len(rec["statuses"]),
                      rec["statuses"][-3:]) for rec in recs
                     if "out" not in rec]
        check(not lost, f"[http] (b) acked jobs lost: {seen_lost}; "
              f"{time.perf_counter() - t_end:.1f} s past the phase's end; "
              f"kill {dead}, w0 back {up}; the router's log ends:\n"
              f"{tail('b')[-2500:]}")
        check({s for s, _ in statuses} <= {200, 202, 503}
              and all(c in ok_503 for s, c in statuses if s == 503),
              f"[http] (b) undeliberate statuses {sorted(set(statuses))}")
        check(restarts["w0"] >= 1 and restarts["w1"] == 0,
              f"[http] (b) restarts {restarts}")
        check(st_m == 200 and b'router_worker_restarts_total{worker="w0"}'
              in metrics, "[http] (b) /metrics lacks w0's restarts")
        check(None not in (dead, up), "[http] (b) the probe did not see "
              "w0 die and come back")
        check(at_risk >= 1, "[http] (b) the kill landed with no acked job "
              "of w0 pending")
        check(rc == 0, f"[http] (b) the router exited {rc} on SIGTERM: "
              f"{tail('b')}")
        with_x = {"w0": 0, "w1": 0}
        for rec in recs:
            name, n, seed = rec["job"]
            w = rec["jid"].split(":")[0]
            if w == "w1":
                fun, hist, x = uninterrupted[f"job-{seed:06d}"]
            else:
                fun, hist, x = solo[seed].fun, solo[seed].history.tolist(), \
                    solo[seed].x.cpu().numpy()
            check(held(rec, fun, hist, x), f"[http] (b) {rec['jid']} "
                  f"({name} n={n} seed {seed}) differs from "
                  f"{'phase 7' if w == 'w1' else 'abo_minimize'}")
            with_x[w] += rec["x"] is not None
        print(f"[http] (b) every fun and history bit for bit (w1's phase "
              f"7's, w0's abo_minimize's on the card); replies with x, held "
              f"too: {with_x} of 6 each", flush=True)
        t_b = time.perf_counter() - t_b
        print(f"[http] phase parts (s): (a) {t_a:.1f}: spawn to listening "
              f"{t_ready:.1f} (the 6 references on the card {t_solo:.1f} of "
              f"it), the burst's clients {t_burst:.1f}, SIGTERM to exit "
              f"{t_stop:.1f}; (b) {t_b:.1f}: until the router is healthy "
              f"{t_healthy:.1f}, the jobs {wall:.1f}, SIGTERM to exit "
              f"{t_stop_b:.1f}", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        for log in logs:
            log.close()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[http] phase took {total:.1f} s (limit {HTTP_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= HTTP_PHASE_S, f"the serving phase took {total:.1f} s")


def poison_next_output(q) -> None:
    """Leave the output's memory NaN for the next attention call, whose
    first allocation is its output: with the allocator's cache emptied, the
    freed NaN block of the output's size is the free block that fits it
    best (for an output of a MB or more, the only one). So a query tile
    that a kernel never writes reads NaN, not a stale right answer."""
    import torch
    torch.cuda.empty_cache()
    torch.full_like(q, float("nan"))
    # the temporary is freed at once, its block back in the cache


def attention_readings(dev, seed: int) -> list[dict]:
    """K3 against its plain version at every shape of ATTN_SHAPES in bf16
    and float32, each through the kernel ``choose_kernel`` names for it,
    twice: per case the kernel, the max abs and the per-row error, whether
    the two calls gave the same bits, and whether the kernel's own launch
    count moved, the bits repeated and both errors are within their
    limits. At bf16 head_dim 64 the mma.sync kernel, which the op no longer
    sends there, is also called directly and held the same way (a reading
    of its own, ``direct``). A bf16 row of more than 1024 keys (non-causal,
    sk > 1024) is held per row to the plain version on float64 copies of
    the inputs, and to be no further from it than the bf16 plain version
    is, as phase 21 holds whisper's shapes: the bf16 plain version rounds
    its scores, which moves such rows by ~0.02 of their max."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    out = []
    for shape in ATTN_SHAPES:
        causal, window = shape[6], shape[7]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(dev, seed, *shape[:6], dtype)
            if dtype == torch.float32 and shape[5] > 128:
                try:                   # no kernel takes it: the op raises
                    ops.flash_attention(q, k, v, causal=causal, window=window)
                    refused = False
                except ValueError:
                    refused = True
                out.append({"shape": shape, "dtype": "float32",
                            "kernel": "none (refused)", "abs": 0.0,
                            "row": 0.0, "ok": refused})
                continue
            name = str(dtype).split(".")[-1]
            want = ops.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
            exact = None
            if name == "bfloat16" and not causal and shape[4] > 1024:
                exact = ops.flash_attention_plain(
                    q.double(), k.double(), v.double(), causal=causal,
                    window=window)
            kernel = ops.choose_kernel(q, k, v)
            runs = [(kernel, False)]
            if name == "bfloat16" and shape[5] == 64:
                runs.append(("flash_attention_mma", True))
            for kname, direct in runs:
                wrapper = getattr(ops, kname)
                call = wrapper if direct else ops.flash_attention
                before = wrapper.launches
                poison_next_output(q)
                got = call(q, k, v, causal=causal, window=window)
                launched = wrapper.launches == before + 1
                poison_next_output(q)
                again = call(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                # no atomics anywhere: a second call gives the same bits,
                # and a race (a stage read before it lands) shows as a
                # difference
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                repeat = bool(torch.equal(got.contiguous().view(bits),
                                          again.contiguous().view(bits)))
                err = float((got.float() - want.float()).abs().max())
                row = row_rel_err(got, want)
                ok_row = row < ATTN_ROW_TOL[name]
                r = {"shape": shape, "dtype": name, "kernel": kname,
                     "direct": direct, "abs": err, "row": row,
                     "repeat": repeat}
                if exact is not None:
                    r["row"] = row_rel_err(got, exact)
                    r["row_bf16_plain"] = row
                    r["row_plain"] = row_rel_err(want, exact)
                    ok_row = (r["row"] < ATTN_ROW_TOL[name]
                              and r["row"] <= r["row_plain"])
                r["ok"] = (launched and repeat
                           and tuple(got.shape) == tuple(want.shape)
                           and bool(torch.isfinite(got).all())
                           and err < ATTN_TOL[name] and ok_row)
                out.append(r)
                del got, again
            del q, k, v, want, exact
    return out


def k3_bound(b, hq, hkv, t, d, causal=True, peak=PEAK_BF16_OPS_S,
             itemsize=2, window=None) -> tuple[float, str]:
    """Least time for attention at (b, hq/hkv, t, d): Q, K, V and O moved
    once; 4·d FLOP a (query, key) pair, over the pairs the mask keeps
    (query q sees min(q + 1, window) keys under a causal window)."""
    if window:
        w = min(window, t)
        pairs = w * (w + 1) / 2 + (t - w) * w
    else:
        pairs = t * (t + 1) / 2 if causal else t * t
    return bound_ms(itemsize * (2 * b * hq * t * d + 2 * b * hkv * t * d),
                    4 * b * hq * d * pairs, peak)


def d256_release_order() -> dict:
    """K3 at head_dim 256's stage releases in its SASS, as
    ``benchmarks_torch.k3_sass`` reads them: a release right after a
    product, with no wait for it, is a race that outputs rarely show."""
    from benchmarks_torch.k3_sass import disassemble, releases
    order = releases(disassemble())
    print(f"[K3] head_dim 256 SASS: {order['products']} products, "
          f"{order['arrivals']} mbarrier arrivals, {len(order['early'])} of "
          "them after a product with no wait since", flush=True)
    return order


def d64_release_order() -> dict:
    """K3 at head_dim 64's stage releases in its SASS (both
    instantiations), as ``benchmarks_torch.k3_sass --kernel d64`` reads
    them."""
    from benchmarks_torch.k3_sass import KERNELS, disassemble, releases
    kernel, library = KERNELS["d64"]
    order = releases(disassemble(library), kernel)
    print(f"[K3] head_dim 64 SASS: {order['products']} products, "
          f"{order['arrivals']} mbarrier arrivals, {len(order['early'])} of "
          "them after a product with no wait since", flush=True)
    return order


def attention_phase(dev, seed: int) -> tuple[dict, dict, dict, dict]:
    """Phase 11: K3 against its plain version at every shape of ATTN_SHAPES
    in bf16 and float32 (float32 at head_dim 256 must be refused), then
    both kernels and SDPA timed in turns at the model's layer shape and at
    T = 32768. Returns the Hopper kernel's entry of the kernels line,
    without its launches, the mma.sync kernel's readings at the model's
    shape, the head_dim 256 kernel's errors at D256_SHAPE, and the head_dim
    64 kernel's largest errors over its shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_mma, flash_attention_plain, flash_attention_sm90)

    main_err, d256_err, d64_err = {}, None, {"abs": 0.0, "row": 0.0}
    vlm_err = None
    for r in attention_readings(dev, seed):
        how = "called directly" if r.get("direct") else "via"
        against = ("" if "row_plain" not in r else
                   f" against the plain version on float64 inputs, no "
                   f"further than the bf16 plain version's "
                   f"{r['row_plain']:.3g} (against the bf16 plain version "
                   f"{r['row_bf16_plain']:.3g})")
        print(f"[K3] {r['shape']} {r['dtype']} {how} {r['kernel']}: max abs "
              f"err {r['abs']:.3g} (limit {ATTN_TOL[r['dtype']]}), per row "
              f"{r['row']:.3g} (limit {ATTN_ROW_TOL[r['dtype']]}){against}, "
              f"the same bits on a repeat {r.get('repeat', '-')}", flush=True)
        check(r["ok"], f"K3 ({r['kernel']}) disagrees with its plain version "
              f"at {r['shape']} {r['dtype']}, or with itself on a repeat, or "
              "did not launch (or, at float32 and head_dim 256, was not "
              "refused)")
        if r.get("direct"):
            continue
        if r["shape"] == LM_ATTN_SHAPE:
            main_err[r["dtype"]] = (r["abs"], r["row"], r["kernel"])
        if r["shape"] == VLM_ATTN_SHAPE and r["dtype"] == "bfloat16":
            vlm_err = {"max_abs_err": r["abs"], "row_rel_err": r["row"],
                       "kernel": r["kernel"]}
        if r["shape"] == D256_SHAPE and r["dtype"] == "bfloat16":
            d256_err = {"max_abs_err": r["abs"], "row_rel_err": r["row"]}
        want = {256: "flash_attention_sm90_d256",
                64: "flash_attention_sm90_d64",
                128: "flash_attention_sm90",
                120: "flash_attention_sm90"}.get(r["shape"][5])
        check(want is None or r["dtype"] != "bfloat16" or r["kernel"] == want,
              f"{r['shape']} bf16 went to {r['kernel']}")
        if r["kernel"] == "flash_attention_sm90_d64":
            d64_err = {k: max(d64_err[k], r[k]) for k in d64_err}
    check(main_err["bfloat16"][2] == "flash_attention_sm90"
          and main_err["float32"][2] == "flash_attention_mma"
          and d256_err is not None and vlm_err is not None
          and vlm_err["kernel"] == "flash_attention_sm90",
          f"the models' layer shapes went to {main_err}, {vlm_err}")
    order = d256_release_order()
    check(not order["early"], "K3 at head_dim 256 frees a stage right after "
          f"a product, before waiting for it (SASS at {order['early']})")
    order = d64_release_order()
    check(not order["early"], "K3 at head_dim 64 frees a stage right after "
          f"a product, before waiting for it (SASS at {order['early']})")

    def timed(t, reps):
        """Both kernels and SDPA (the yardstick) at (1, 32/8, t, 128) bf16
        causal, in turns (sm90, mma, SDPA, SDPA, mma, sm90), and the
        bound."""
        b, hq, hkv, d = 1, 32, 8, 128
        q, k, v = _qkv(dev, seed, b, hq, hkv, t, t, d, torch.bfloat16)
        new = flash_attention_sm90(q, k, v)
        old = flash_attention_mma(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        ref = sdpa()
        diff = float((new.float() - ref.float()).abs().max())
        old_err = float((old.float() - new.float()).abs().max())
        runs = {"sm90": (lambda: flash_attention_sm90(q, k, v), reps),
                "mma": (lambda: flash_attention_mma(q, k, v),
                        max(2, reps // 4)),
                "sdpa": (sdpa, reps)}
        ms = {n: [] for n in runs}
        for order in (("sm90", "mma", "sdpa"), ("sdpa", "mma", "sm90")):
            for n in order:
                ms[n].append(cuda_ms(*runs[n]))
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        bound, by = k3_bound(b, hq, hkv, t, d)
        print(f"[K3] (1, 32/8, {t}, 128) bf16 causal, in turns: "
              f"flash_attention_sm90 {ms['sm90']} ms, flash_attention_mma "
              f"{ms['mma']} ms, scaled_dot_product_attention "
              f"{ms['sdpa']} ms; sm90 is {mean['mma'] / mean['sm90']:.3f}x "
              f"faster than mma and {mean['sm90'] / mean['sdpa']:.3f}x SDPA's "
              f"time; bound {bound:.4f} ms ({by}); max abs diff sm90 vs SDPA "
              f"{diff:.3g}, mma vs sm90 {old_err:.3g}", flush=True)
        return q, k, v, mean, bound, by

    q, k, v, mean, bound, by = timed(LM_T, 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3)
    print(f"[K3] (1, 32/8, {LM_T}, 128) bf16 causal: plain version "
          f"{plain_ms:.3f} ms", flush=True)
    del q, k, v
    q, k, v, mean32, bound32, _ = timed(4 * LM_T, 4)  # prefill_32k's shape
    del q, k, v
    check(mean["mma"] >= 3 * mean["sm90"],
          f"flash_attention_sm90 ({mean['sm90']:.4f} ms) is not 3x faster "
          f"than flash_attention_mma ({mean['mma']:.4f} ms) at T = {LM_T}")
    torch.cuda.empty_cache()
    sm90 = {"name": "flash_attention_sm90", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
            "launches": 0, "max_abs_err": main_err["bfloat16"][0],
            "ms": mean["sm90"], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": mean["sdpa"],
            "max_abs_err_of": f"bf16 at (1, 32/8, {LM_T}, 128), causal",
            "row_rel_err": main_err["bfloat16"][1],
            "ms_32768": mean32["sm90"], "library_ms_32768": mean32["sdpa"],
            "bound_ms_32768": bound32,
            "qwen2_vl": {"max_abs_err": vlm_err["max_abs_err"],
                         "row_rel_err": vlm_err["row_rel_err"]}}
    mma_model = {"ms_model_shape": mean["mma"],
                 "ms_model_shape_32768": mean32["mma"],
                 "model_shape": f"bf16 (1, 32/8, {LM_T}, 128) causal",
                 "max_abs_err_f32_model_shape": main_err["float32"][0],
                 "row_rel_err_f32_model_shape": main_err["float32"][1]}
    return sm90, mma_model, d256_err, d64_err


def mma_path_phase(dev, seed: int) -> dict:
    """Phase 13: the mma.sync kernel's path, the reduced config's prefill step
    (float32, head_dim 16) on the card, with its launches counted, the
    forward held against its plain-attention run, and the kernel timed at
    that attention shape. Returns the kernel's entry of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_mma, flash_attention_plain, flash_attention_sm90)
    from repro_torch.models.model import Model
    from repro_torch.train.steps import make_prefill_step

    cfg = reduced(ARCHS[LM_ARCH])
    model = Model(cfg, device=dev).init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, MMA_TOKENS, generator=gen,
                           device=dev)
    step = make_prefill_step(model)
    step({"tokens": tokens})                               # warm-up
    torch.cuda.synchronize()
    flash_attention_mma.launches = flash_attention_sm90.launches = 0
    last = step({"tokens": tokens})
    torch.cuda.synchronize()
    launches = flash_attention_mma.launches
    print(f"[mma] reduced {LM_ARCH} ({cfg.n_layers} layers, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, float32) prefill step "
          f"on {MMA_TOKENS}: flash_attention_mma launches {launches}, "
          f"flash_attention_sm90 {flash_attention_sm90.launches}", flush=True)
    check(launches == cfg.n_layers and flash_attention_sm90.launches == 0,
          "the reduced prefill step did not run flash_attention_mma per layer")
    check(bool(torch.isfinite(last).all()), "reduced logits not finite")
    agree, _ = lm_agreement(model, tokens)
    print(f"[mma] forward vs plain attention: per layer "
          f"{agree['layers_max']:.4g} (limit {ATTN_ROW_TOL['bfloat16']}), "
          f"logits {agree['pos_rel_max']:.4g} (limit {LM_REL_TOL_PLAIN})",
          flush=True)
    check(agree["ok_layers"] and agree["ok_logits"],
          "the reduced forward disagrees with its plain-attention run")
    b, t = MMA_TOKENS
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(dev, seed, b, hq, hkv, t, t, d, torch.float32)
    got = flash_attention_mma(q, k, v)
    want = flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    ms = cuda_ms(lambda: flash_attention_mma(q, k, v), 50)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    bound, by = k3_bound(b, hq, hkv, t, d, peak=PEAK_F32_OPS_S, itemsize=4)
    print(f"[mma] ({b}, {hq}/{hkv}, {t}, {d}) float32 causal: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {bound:.5f} "
          f"ms ({by}); max abs err {err:.3g} (limit {ATTN_TOL['float32']})",
          flush=True)
    check(err < ATTN_TOL["float32"], "flash_attention_mma disagrees at its "
          "path's shape")
    del model
    torch.cuda.empty_cache()
    return {"name": "flash_attention_mma", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms,
            "launches_of": f"reduced {LM_ARCH} prefill step, float32",
            "max_abs_err_of": f"float32 at ({b}, {hq}/{hkv}, {t}, {d}), "
                              "causal"}


@contextlib.contextmanager
def plain_attention(layer_err: list):
    """Run the model's attention through K3's plain version (the reference
    run of phase 9; the wrapper itself never does that on the card). Each
    layer also runs K3 on the same q, k, v, and its per-row error against
    the plain output is appended to ``layer_err``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import attention

    def both(q, k, v, *, causal=True, window=None):
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            layer_err.append(row_rel_err(
                flash_attention(q, k, v, causal=causal, window=window), want))
        return want

    saved = attention.flash_attention
    attention.flash_attention = both
    try:
        yield
    finally:
        attention.flash_attention = saved


@contextlib.contextmanager
def library_attention():
    """Run the model's attention through ``scaled_dot_product_attention``,
    the library's flash attention: a yardstick for how far another correct
    bf16 attention moves a deep model's logits (no window)."""
    import torch.nn.functional as F
    from repro_torch.models import attention

    def sdpa(q, k, v, *, causal=True, window=None):
        check(window is None, "the library yardstick takes no window")
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    saved = attention.flash_attention
    attention.flash_attention = sdpa
    try:
        yield
    finally:
        attention.flash_attention = saved


def lm_agreement(model, tokens, plain=plain_attention, **fwd
                 ) -> tuple[dict, "torch.Tensor"]:
    """The full forward over ``tokens`` (``fwd``: its other arguments)
    with K3 against the same forward with the plain attention
    (``plain(layer_err)``, a context in which the model's kernels give way
    to their plain versions): K3's per-row error at each attention layer on
    that layer's own q, k, v, and the logits' max abs difference over the
    reference's max |logit| at each position. Returns the readings, the
    reference's logits at the last position, and whether each is within its
    limit."""
    import torch
    full, _ = model.forward(tokens, **fwd)
    layer_err = []
    t0 = time.perf_counter()
    with plain(layer_err):
        ref, _ = model.forward(tokens, **fwd)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    diff = (full[0].float() - ref[0].float()).abs().amax(-1)
    pos_rel = diff / ref[0].float().abs().amax(-1)
    same = full[0].argmax(-1) == ref[0].argmax(-1)
    last_ref = ref[:, -1].float()
    del full, ref
    r = {"layer_row_err": layer_err, "layers_max": max(layer_err,
                                                       default=0.0),
         "pos_rel_early": float(pos_rel[:LM_EARLY].max()),
         "pos_rel_max": float(pos_rel.max()),
         "pos_rel_last": float(pos_rel[-1]),
         "argmax_equal_share": float(same.double().mean()),
         "argmax_last_equal": bool(same[-1]), "plain_wall": plain_wall}
    cfg = model.cfg
    n_attn = sum(cfg.mixer_kind(i) in ("attn", "swa")
                 for i in range(cfg.n_layers))
    r["ok_layers"] = (len(layer_err) == n_attn
                      and r["layers_max"] < ATTN_ROW_TOL["bfloat16"])
    r["ok_logits"] = (r["pos_rel_max"] <= LM_REL_TOL_PLAIN
                      and r["argmax_last_equal"])
    return r, last_ref


K3_COUNTED = ("flash_attention", "flash_attention_sm90", "flash_attention_mma",
              "flash_attention_sm90_d64", "flash_attention_sm90_d256")


def prefill_step_reading(model, tokens, tag: str, smi: str = "",
                         warm_up: bool = True, positions=None) -> dict:
    """One ``make_prefill_step`` call on ``tokens`` (1, T) at ``positions``
    (the model's default ids if None), after a warm-up call unless
    ``warm_up`` is False, timed, with each K3 kernel's launches
    and the peak memory over the parameter bytes, printed under ``tag``.
    Fails unless every attention layer launched ``flash_attention_sm90``
    once, no other K3 kernel ran and the logits are finite. Returns the
    wall, the launches, the peak, the parameter bytes and the logits."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train.steps import make_prefill_step

    cfg = model.cfg
    t = tokens.shape[1]
    n_attn = sum(cfg.mixer_kind(i) in ("attn", "swa")
                 for i in range(cfg.n_layers))
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = {"tokens": tokens, "positions": positions}
    step = make_prefill_step(model)
    if warm_up:
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in K3_COUNTED:
        getattr(fa, n).launches = 0
    t0 = time.perf_counter()
    last = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: getattr(fa, n).launches for n in K3_COUNTED}
    launches = counts["flash_attention_sm90"]
    others = sum(counts[n] for n in K3_COUNTED[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} prefill step, 1 x {t} tokens"
          f"{'' if warm_up else ' (no warm-up at this length)'}: wall "
          f"{wall:.4f} s, {t / wall:.1f} tokens/s, K3 launches: "
          f"flash_attention_sm90 {launches}, flash_attention_mma "
          f"{counts['flash_attention_mma']}, the other K3 kernels "
          f"{others - counts['flash_attention_mma']}; peak device memory "
          f"{peak} B = {peak / par_bytes:.4f} x the parameter bytes{smi}",
          flush=True)
    check(launches == n_attn and others == 0
          and counts["flash_attention"] == n_attn,
          f"the prefill step on {t} tokens launched flash_attention_sm90 "
          f"{launches} times and the other K3 kernels {others} times, want "
          f"{n_attn} and 0")
    check(tuple(last.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(last).all()),
          "prefill-step logits are not finite or of the wrong shape")
    return {"wall": wall, "launches": launches, "peak": peak,
            "par_bytes": par_bytes, "n_attn": n_attn, "last": last}


def lm_serving(model, tokens, tag: str, smi: str = "") -> dict:
    """The LM serving path of ``model`` (full width, bf16) on one request of
    ``tokens[:, :LM_T]``: the prefill step (``prefill_step_reading``); the
    forward against its plain-attention run (``lm_agreement``) and the
    prefill step's logits against it; prefill + the rest of ``tokens``
    decoded against the forward over all of them (``decode_seam``). Prints
    each reading under ``tag``, fails on any check, and returns the
    readings with each part's seconds."""
    import torch

    n_new = tokens.shape[1] - LM_T
    seconds, t_part = {}, time.perf_counter()
    batch = {"tokens": tokens[:, :LM_T]}
    pre = prefill_step_reading(model, batch["tokens"], tag, smi)
    n_attn, last = pre["n_attn"], pre.pop("last")
    seconds["prefill step"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    agree, ref = lm_agreement(model, batch["tokens"])
    print(f"{tag} forward over {LM_T}, K3 vs plain attention (plain run "
          f"{agree['plain_wall']:.2f} s): K3 per row on each layer's own "
          f"q, k, v: max {agree['layers_max']:.4g} (limit "
          f"{ATTN_ROW_TOL['bfloat16']}), per layer "
          f"{[round(e, 5) for e in agree['layer_row_err']]}", flush=True)
    print(f"{tag} logits max abs diff over max |logit| per position: max "
          f"{agree['pos_rel_max']:.4g} (limit {LM_REL_TOL_PLAIN}), first "
          f"{LM_EARLY} positions {agree['pos_rel_early']:.4g}, last "
          f"{agree['pos_rel_last']:.4g}; argmax equal at "
          f"{agree['argmax_equal_share']:.4f} of positions, at the last "
          f"{agree['argmax_last_equal']}", flush=True)
    check(agree["ok_layers"], "K3 disagrees with its plain version on the "
          "model's own q, k, v")
    check(agree["ok_logits"], "the full-width forward disagrees with its "
          "plain-attention run")
    err = float((last.float() - ref).abs().max())
    scale = float(ref.abs().max())
    step_rel = err / scale
    print(f"{tag} prefill-step logits vs the plain-attention forward's last "
          f"position: max abs diff {err:.4g}, max |logit| {scale:.4g}, "
          f"relative {step_rel:.4g} (limit {LM_REL_TOL_PLAIN}), argmax "
          f"{int(last.argmax())} vs {int(ref.argmax())}", flush=True)
    check(int(last.argmax()) == int(ref.argmax())
          and err <= LM_REL_TOL_PLAIN * scale,
          "the full-width prefill step disagrees with its plain-attention run")
    del last, ref
    torch.cuda.empty_cache()
    seconds["agreement"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    dec = decode_seam(model, tokens, LM_T)
    check(dec["prefill_launches"] == n_attn,
          f"Model.prefill launched K3 {dec['prefill_launches']} times")
    print(f"{tag} prefill({LM_T}) + {n_new} decode steps vs forward over "
          f"{LM_T + n_new}: max abs diff per position {dec['err']}, "
          f"max |logit| {dec['scale']:.4g}, relative {dec['rel']:.4g} "
          f"(limit {LM_REL_TOL_DECODE}), argmax equal {dec['argmax']}, "
          f"{dec['ms']:.2f} ms per decode step, {dec['slots']} cache slots "
          f"a layer{smi}", flush=True)
    check(dec["rel"] <= LM_REL_TOL_DECODE,
          "prefill + decode disagrees with the forward")
    torch.cuda.empty_cache()
    seconds["decode seam"] = time.perf_counter() - t_part
    return {**pre, "agree": agree, "step_rel": step_rel, "decode": dec,
            "seconds": seconds}


def decode_seam(model, tokens, t: int) -> dict:
    """``model.prefill`` of ``tokens[:, :t]`` into caches of all of
    ``tokens``' slots (a ring of ``window`` under SWA), then decode the
    rest token by token, against the forward over all of ``tokens`` from
    position t - 1 on: max abs diff per position, over the forward's max
    |logit| (``rel``), argmax equal per position, ms a decode step and the
    first layer's cache slots; and the K3 launches of the prefill."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    total = tokens.shape[1]
    before = flash_attention.launches
    logits_pre, cache = model.prefill(tokens[:, :t], max_len=total)
    launches = flash_attention.launches - before
    slots = cache[0]["kv"]["k"].shape[2]
    outs = [logits_pre[:, -1].float()]
    del logits_pre
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(t, total):
        lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
        outs.append(lg[:, 0].float())
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / (total - t)
    del cache
    full, _ = model.forward(tokens)
    want = full[0, t - 1:].float()
    del full
    got = torch.cat(outs)
    err = (got - want).abs().amax(dim=-1)
    scale = float(want.abs().max())
    return {"err": err.tolist(), "scale": scale,
            "rel": float(err.max()) / scale,
            "argmax": (got.argmax(-1) == want.argmax(-1)).tolist(),
            "ms": dec_ms, "slots": slots, "prefill_launches": launches}


def lm_launcher(arch: str, tag: str) -> float:
    """``launch.serve.main`` at full width (it draws its own model): 8
    requests of 16 tokens over 4 slots, each answered with 16 tokens in the
    vocabulary. Returns its wall in seconds."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    outputs = serve.main(["--arch", arch, "--requests", "8",
                          "--batch-slots", "4", "--prompt-len", "16",
                          "--max-new", "16", "--max-len", "256"])
    wall = time.perf_counter() - t0
    print(f"{tag} serve.main() took {wall:.2f} s with the model's draw",
          flush=True)
    vocab = ARCHS[arch].vocab_size
    check(len(outputs) == 8
          and all(len(g) == 16 and all(0 <= x < vocab for x in g)
                  for _, g in outputs),
          f"the {arch} serve launcher did not answer 8 requests with 16 "
          "tokens")
    torch.cuda.empty_cache()
    return wall


def lm_phase(dev, seed: int) -> int:
    """Phases 12-13: the LM serving path at full width. Returns the Hopper
    kernel's launches in the main-path run (one prefill step)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import Model

    cfg = ARCHS[LM_ARCH]
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[lm] {LM_ARCH}: {n_par} parameters ({2 * n_par / 1e9:.2f} GB "
          f"bf16), drawn on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    launches = lm_serving(model, tokens, "[lm]")["launches"]
    del model
    torch.cuda.empty_cache()

    # ---- 13. the serve launcher ---------------------------------------------
    lm_launcher(LM_ARCH, "[serve]")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the LM training path
# ---------------------------------------------------------------------------
def grad_row_err(got, want) -> float:
    """Max over rows of the row's max |got - want| over the row's max
    |want|, floored at BWD_ROW_FLOOR of the tensor's max |want|. A
    gradient row can vanish (causal query row 0's dQ is exactly 0), and a
    small dQ row is a cancellation, P·(dP - rowsum(dO·O)), that bf16 O
    and bf16 dP round differently in the kernel and the plain version
    (PERF.md): such rows are held in absolute terms at that floor."""
    diff = (got.float() - want.float()).abs().amax(-1)
    w = want.float().abs()
    den = w.amax(-1).clamp_min(BWD_ROW_FLOOR * float(w.max()))
    return float((diff / den).max())


def _model_layout(t):
    """t as a (b, h, s, d) view of a (b, s, h, d) buffer: the layout of the
    model's projections, which K3 and K3-bwd read."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def bwd_bound(b, hq, hkv, t, d, causal=True, peak=PEAK_BF16_OPS_S,
              itemsize=2) -> tuple[float, str]:
    """Least time for K3's backward at (b, hq/hkv, t, d): q, k, v, dO and
    the lse read once, dQ, dK, dV written once; five products of 2·d FLOP a
    kept (query, key) pair (S recomputed, dP, dV, dK, dQ). O is read only
    where D = rowsum(dO ∘ O), the mma.sync kernel's float32 path (bf16 and
    every Hopper backward take D = rowsum(P ∘ dP) and never read O)."""
    pairs = t * (t + 1) / 2 if causal else t * t
    o_rows = b * hq * t * d if itemsize == 4 else 0
    return bound_ms(itemsize * (3 * b * hq * t * d + o_rows
                                + 4 * b * hkv * t * d)
                    + 4 * b * hq * t, 10 * d * b * hq * pairs, peak)


def p_bound(n: int, itemsize: int) -> tuple[float, str, dict]:
    """Least time for P over n elements: each read and written once,
    against the function's own instructions (P_FN): its shifts and logic
    at the integer ALU pipe's rate, all of them at the issue rate."""
    lanes = SMS * CLOCK_HZ
    t_alu = n * P_FN["alu_only"] / (PIPE_RATE["alu"] * lanes)
    t_issue = n * sum(P_FN.values()) / (ISSUE_LANES * lanes)
    t_bytes = 2 * itemsize * n / PEAK_BYTES_S
    t_ops = max(t_alu, t_issue)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), by, {
        "alu_ms": 1e3 * t_alu, "issue_ms": 1e3 * t_issue,
        "bytes_ms": 1e3 * t_bytes,
        "build_issue_ms": 1e3 * n * P_SASS_LOOP / (ISSUE_LANES * lanes)}


def bwd_kernel_for(dtype: str, d: int, dout_stride=None) -> str:
    """The K3-bwd kernel a case must run, from the routing rule stated
    apart from ``choose_bwd_kernel``: bf16 with 16-byte strides to the
    Hopper kernel of its head dim (120 or 128, 64, 256), the rest to the
    mma.sync one."""
    if dtype == "bfloat16" and (dout_stride is None or dout_stride % 8 == 0):
        hopper = {120: "flash_attention_bwd_sm90",
                  128: "flash_attention_bwd_sm90",
                  64: "flash_attention_bwd_sm90_d64",
                  256: "flash_attention_bwd_sm90_d256"}.get(d)
        if hopper:
            return hopper
    return "flash_attention_bwd_mma"


def bwd_reading(got, again, want, name: str, ran: str, want_kernel: str,
                shape) -> dict:
    """One K3-bwd case held to its plain version: max |got - want| over the
    tensor's max |want| and per row for dQ, dK and dV, the max abs error,
    the kernel that ran and whether a second run gave the same bits."""
    import torch
    rel = {n: float((a.float() - w.float()).abs().max()
                    / w.float().abs().max())
           for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    row = {n: grad_row_err(a, w)
           for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    return {"shape": tuple(shape[:8]), "dtype": name, "rel": rel, "row": row,
            "abs": err, "same_bits": same, "kernel": ran,
            "want_kernel": want_kernel, "ok": (
                ran == want_kernel and same
                and all(bool(torch.isfinite(a).all()) for a in got)
                and max(rel.values()) < BWD_TOL[name]
                and max(row.values()) < BWD_ROW_TOL[name])}


BWD_COUNTED = ("flash_attention_bwd", "flash_attention_bwd_sm90",
               "flash_attention_bwd_sm90_d64", "flash_attention_bwd_sm90_d256",
               "flash_attention_bwd_mma")


def _bwd_counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    return {n: getattr(fa, n).launches for n in BWD_COUNTED}


def _bwd_ran(before: dict) -> str | None:
    """The one K3-bwd kernel whose launch count moved by one since
    ``before`` (``_bwd_counts()``), the others' unchanged and the
    dispatching wrapper's moved by one, else None."""
    moved = {n: c - before[n] for n, c in _bwd_counts().items()}
    if moved.pop("flash_attention_bwd") != 1:
        return None
    ran = [n for n, m in moved.items() if m == 1]
    return ran[0] if len(ran) == 1 and sum(moved.values()) == 1 else None


def train_bwd_readings(dev, seed: int) -> list[dict]:
    """(a) K3-bwd against autograd through the plain attention at each
    shape of TRAIN_BWD_SHAPES, through ``flash_attention``'s gradient, and
    at each of BWD_ROUTING_CASES, through ``flash_attention_bwd`` with a dO
    whose rows are the case's stride apart: per case ``bwd_reading``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    out = []
    for shape in TRAIN_BWD_SHAPES:
        b, hq, hkv, sq, sk, d, causal, window, name = shape
        dtype = getattr(torch, name)
        q, k, v = (_model_layout(t).requires_grad_(True)
                   for t in _qkv(dev, seed, b, hq, hkv, sq, sk, d, dtype))
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        dout = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dtype)
        before = _bwd_counts()
        got = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        ran = _bwd_ran(before)
        again = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        want = fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        out.append(bwd_reading(got, again, want, name, ran,
                               bwd_kernel_for(name, d), shape))
        del q, k, v, dout, got, again, want
    for case, stride in BWD_ROUTING_CASES:
        b, hq, hkv, sq, sk, d, causal, window, name = case
        dtype = getattr(torch, name)
        q, k, v = (_model_layout(t)
                   for t in _qkv(dev, seed, b, hq, hkv, sq, sk, d, dtype))
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        dout = torch.randn((b, hq, sq, stride), generator=g,
                           device=dev).to(dtype)[..., :d]
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        o = fa._KERNELS[fa.choose_kernel(q, k, v)](
            q, k, v, causal=causal, window=window, lse=lse)
        before = _bwd_counts()
        got = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal,
                                     window=window)
        ran = _bwd_ran(before)
        again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal,
                                       window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        r = bwd_reading(got, again, want, name, ran,
                        bwd_kernel_for(name, d, stride), case)
        r["dout_stride"] = stride
        out.append(r)
    return out


def d_rule(dev, seed: int) -> list[dict]:
    """D's rule through each Hopper K3-bwd (D_RULE_DIMS): on values that
    share a large common part, dQ against the float64 gradient, beside
    the float64 emulation of D = rowsum(dO ∘ O) with O rounded to bf16.
    Each reading: head dim, kernel, the two errors (max |diff| over max
    |want|)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    out = []
    for d in D_RULE_DIMS:
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        b, h, t = 2, 4, 448
        q, k = (torch.randn(b, h, t, d, generator=g, device=dev).bfloat16()
                for _ in range(2))
        v = (3.0 + 0.05 * torch.randn(b, h, t, d, generator=g,
                                      device=dev)).bfloat16()
        dout = torch.randn(b, h, t, d, generator=g, device=dev).bfloat16()
        lse = torch.empty(b, h, t, dtype=torch.float32, device=dev)
        o = fa._KERNELS[fa.choose_kernel(q, k, v)](q, k, v, lse=lse)
        name = fa.choose_bwd_kernel(q, k, v, o, dout)
        dq = getattr(fa, name)(q, k, v, o, dout, lse)[0]
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
        s = (q64 @ k64.transpose(-1, -2)) * d ** -0.5
        mask = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        dp = do64 @ v64.transpose(-1, -2)
        want = (p * (dp - (p * dp).sum(-1, keepdim=True))) @ k64 * d ** -0.5
        rounded = ((p * (dp - (do64 * o.double()).sum(-1, keepdim=True)))
                   @ k64 * d ** -0.5)
        out.append({"d": d, "kernel": name, "err": rel_max(dq, want),
                    "err_rounded_o": rel_max(rounded, want)})
        del q, k, v, dout, lse, o, dq, q64, k64, v64, do64, s, p, dp, want
        del rounded
    torch.cuda.empty_cache()
    return out


def bwd_times(dev, seed: int, b, hq, hkv, t, d, reps: int, dtype="bfloat16",
              plain=True, device_only=False) -> dict:
    """The K3-bwd kernels that take (b, hq/hkv, t, d) causal in ``dtype``
    (the Hopper one of the head dim in bf16, the mma.sync one always)
    and SDPA's backward, timed in turns (Hopper, mma, SDPA, SDPA, mma,
    Hopper), each over ``reps`` calls; the plain version's time unless
    ``plain`` is False; the bound. The lse and O come from the forward.

    With ``device_only``, each turn is timed twice, by ``cuda_ms`` (events
    around the host's loop: a host stall between calls counts) and then by
    ``queued_ms`` (the calls queued behind a device sleep: device time
    alone); ``turns`` and ``ms`` are the second, ``turns_events`` the
    first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    dt = getattr(torch, dtype)
    q, k, v = (_model_layout(x)
               for x in _qkv(dev, seed, b, hq, hkv, t, t, d, dt))
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    dout = torch.randn((b, hq, t, d), generator=g, device=dev).to(dt)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
    o = fa._KERNELS[fa.choose_kernel(q, k, v)](q, k, v, lse=lse)
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            enable_gqa=hq != hkv)
    runs = {"mma": lambda: fa.flash_attention_bwd_mma(q, k, v, o, dout, lse),
            "sdpa": lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), dout,
                                                retain_graph=True)}
    order = ("mma", "sdpa", "sdpa", "mma")
    hopper = fa.choose_bwd_kernel(q, k, v, o, dout)
    if hopper != "flash_attention_bwd_mma":
        runs["sm90"] = lambda: getattr(fa, hopper)(q, k, v, o, dout, lse)
        order = ("sm90",) + order + ("sm90",)
    for fn in runs.values():
        fn()                                              # warm-up
    turns = {n: [] for n in runs}
    events = {n: [] for n in runs}
    for n in order:
        if device_only:
            events[n].append(cuda_ms(runs[n], reps))
            turns[n].append(queued_ms(runs[n], reps))
        else:
            turns[n].append(cuda_ms(runs[n], reps))
    peak, size = ((PEAK_BF16_OPS_S, 2) if dt == torch.bfloat16
                  else (PEAK_F32_OPS_S, 4))
    bound, by = bwd_bound(b, hq, hkv, t, d, peak=peak, itemsize=size)
    out = {"shape": f"{dtype} ({b}, {hq}/{hkv}, {t}, {d}) causal",
           "turns": turns, "turns_events": events if device_only else None,
           "ms": {n: sum(x) / len(x) for n, x in turns.items()},
           "plain_ms": (cuda_ms(lambda: fa.flash_attention_bwd_plain(
               q, k, v, dout), 3) if plain else None),
           "bound_ms": bound, "bound_by": by}
    del q, k, v, dout, lse, o, qs, ks, vs, o_sdpa, runs
    torch.cuda.empty_cache()
    return out


def print_bwd_times(tag: str, r: dict) -> None:
    ms = r["ms"]
    hopper = (f"Hopper {r['turns']['sm90']} ms ({ms['sm90'] / ms['sdpa']:.3f}x "
              f"SDPA's, {ms['mma'] / ms['sm90']:.2f}x faster than mma.sync, "
              f"{r['bound_ms'] / ms['sm90']:.1%} of the bound), "
              if "sm90" in ms else "")
    plain = (f"plain {r['plain_ms']:.3f} ms, " if r["plain_ms"] is not None
             else "")
    timer = ("device only (queued_ms), " if r["turns_events"] is not None
             else "")
    print(f"{tag} K3-bwd at {r['shape']}, in turns, {timer}{hopper}mma.sync "
          f"{r['turns']['mma']} ms, SDPA's backward {r['turns']['sdpa']} ms; "
          f"{plain}bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    if r["turns_events"] is not None:
        print(f"{tag} K3-bwd at {r['shape']}, the same turns by events "
              f"around the host's loop (cuda_ms): {r['turns_events']} ms",
              flush=True)


def bwd_long_reading(dev, seed: int) -> dict:
    """The Hopper K3-bwd at BWD_LONG_HELD against the plain backward (the
    kernel that ran, both gradients' errors, the same bits on a repeat)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    b, hq, hkv, t, d = BWD_LONG_HELD
    q, k, v = (_model_layout(x) for x in _qkv(dev, seed, b, hq, hkv, t, t, d,
                                               torch.bfloat16))
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    dout = torch.randn((b, hq, t, d), generator=g, device=dev).to(
        torch.bfloat16)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
    o = fa.flash_attention_sm90(q, k, v, lse=lse)
    before = _bwd_counts()
    got = fa.flash_attention_bwd(q, k, v, o, dout, lse)
    ran = _bwd_ran(before)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse)
    want = fa.flash_attention_bwd_plain(q, k, v, dout)
    torch.cuda.synchronize()
    r = bwd_reading(got, again, want, "bfloat16", ran,
                    "flash_attention_bwd_sm90", (b, hq, hkv, t, t, d, True,
                                                 None))
    del q, k, v, dout, lse, o, got, again, want
    torch.cuda.empty_cache()
    return r


def train_counted() -> tuple:
    """The kernel wrappers a training step can launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.perturb.ops import abo_zo_perturb
    return (fa.flash_attention_sm90, fa.flash_attention_mma,
            fa.flash_attention_bwd, fa.flash_attention_bwd_sm90,
            fa.flash_attention_bwd_mma, abo_zo_perturb)


@contextlib.contextmanager
def recorded_steps(records: list, counted: tuple):
    """Run with every step that ``train.steps.make_train_step`` builds (the
    launcher's too) timed: its wall, the launches of each wrapper of
    ``counted`` and its metrics appended to ``records``."""
    import torch
    from repro_torch.train import steps as steps_mod
    make = steps_mod.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def timed(*args):
            torch.cuda.synchronize()
            before = {w: w.launches for w in counted}
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            records.append({"wall": time.perf_counter() - t0,
                            "launches": {w.__name__: w.launches - before[w]
                                         for w in counted},
                            "metrics": {k: float(x)
                                        for k, x in out[1].items()}})
            return out
        return timed

    steps_mod.make_train_step = recording
    try:
        yield
    finally:
        steps_mod.make_train_step = make


def _loss_grads(model, batch):
    """Step 1's loss (float) and every gradient, with remat."""
    for p in model.parameters():
        p.grad = None
    loss = model.loss(batch, remat=True)[0]
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def adamw_cut(dev, seed: int, arch: str, tag: str) -> dict:
    """AdamW through ``make_train_step`` on ``arch`` at full width cut to
    ADAMW_LAYERS layers (remat, TRAIN_B x TRAIN_T tokens of the bigram
    stream): step 1's loss and every gradient tensor with K3 against the
    plain attention's (ADAMW_LOSS_TOL, ADAMW_GRAD_TOL; no projection's
    gradient zero), then ADAMW_STEPS steps timed, K3 and the Hopper K3-bwd
    in every layer and no mma.sync kernel; the memory all layers would
    need. Prints under ``tag``; returns the steps' launches."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import BigramStream, StreamConfig
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod

    cfg = ARCHS[arch]
    counted = train_counted()
    cfg4 = dataclasses.replace(cfg, n_layers=ADAMW_LAYERS)
    model = Model(cfg4, device=dev).init(seed).requires_grad_(True)
    n4 = sum(p.numel() for p in model.parameters())
    stream = BigramStream(StreamConfig(vocab_size=cfg4.vocab_size,
                                       seq_len=TRAIN_T, global_batch=TRAIN_B))

    batch0 = {"tokens": stream.torch_batch(0, dev)}
    loss_k3, g_k3 = _loss_grads(model, batch0)
    with plain_attention([]):
        loss_plain, g_plain = _loss_grads(model, batch0)
    grad_rel = {n: float((g_k3[n].float() - g_plain[n].float()).abs().max()
                         / g_plain[n].float().abs().max()) for n in g_k3}
    qkv_zero = [n for n in g_k3 if n.split(".")[-1] in ("wq", "wk", "wv")
                and float(g_k3[n].abs().max()) == 0.0]
    worst = max(grad_rel, key=grad_rel.get)
    loss_rel = abs(loss_k3 - loss_plain) / abs(loss_plain)
    tables = {n: round(grad_rel[n], 6) for n in ("embed", "unembed",
                                                  "pos_embed")
              if n in grad_rel}
    print(f"{tag} {arch} cut to {ADAMW_LAYERS} of {cfg.n_layers} "
          f"layers ({n4} parameters): step 1's loss with K3 {loss_k3:.6f}, "
          f"with the plain attention {loss_plain:.6f} (relative "
          f"{loss_rel:.3g}, limit {ADAMW_LOSS_TOL}); gradients, max |diff| / "
          f"max |plain| per tensor: worst {worst} {grad_rel[worst]:.4g} "
          f"(limit {ADAMW_GRAD_TOL}), wq/wk/wv "
          f"{max(v for n, v in grad_rel.items() if n.split('.')[-1] in ('wq', 'wk', 'wv')):.4g},"
          f" the tables {tables}; zero attention gradients {qkv_zero}",
          flush=True)
    check(loss_rel <= ADAMW_LOSS_TOL and grad_rel[worst] <= ADAMW_GRAD_TOL
          and not qkv_zero, f"{arch}: AdamW's step 1 with K3 disagrees with "
          "the plain attention's, or a projection's gradient is zero")
    del g_k3, g_plain
    step = steps_mod.make_train_step(model, optimizer="adamw", remat=True)
    state = steps_mod.init_opt_state(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in counted:
        w.launches = 0
    walls, losses = [], []
    for s in range(ADAMW_STEPS):
        batch = {"tokens": stream.torch_batch(s, dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = {w.__name__: w.launches for w in counted}
    peak = torch.cuda.max_memory_allocated()
    n_all = cfg.n_params()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{tag} AdamW, {ADAMW_STEPS} steps of {TRAIN_B} x {TRAIN_T} "
          f"tokens, remat: wall per step {[round(w, 4) for w in walls]} s, "
          f"losses {losses}; launches {launches} "
          f"({ADAMW_STEPS} steps); peak device memory {peak} B = "
          f"{peak / (2 * n4):.3f} x the bf16 parameter bytes; 16 bytes a "
          f"parameter (bf16 params and grads, fp32 master, m, v) for all "
          f"{cfg.n_layers} layers: {16 * n_all} B against the card's {total} B",
          flush=True)
    check(all(math.isfinite(x) for x in losses), "AdamW's loss not finite")
    check(launches["flash_attention_sm90"] >= ADAMW_STEPS * ADAMW_LAYERS
          and launches["flash_attention_bwd"]
          == launches["flash_attention_bwd_sm90"]
          == ADAMW_STEPS * ADAMW_LAYERS
          and launches["flash_attention_mma"] == 0
          and launches["flash_attention_bwd_mma"] == 0,
          f"{arch}: AdamW's steps launched {launches}: K3 and the Hopper "
          "K3-bwd not in every layer, or a mma.sync kernel ran")
    del model, step, state, met
    torch.cuda.empty_cache()
    return launches


def train_phase(dev, seed: int) -> list[dict]:
    """Phase 15, the LM training path (see TRAIN_ARGS): (a) K3-bwd, (b) P,
    (c) ABO-ZO on the whole mistral-nemo-12b, (d) AdamW at full width cut
    to ADAMW_LAYERS layers, (e) the reduced config's resume on the card.
    Returns the entries of the kernels line for both K3-bwd kernels and
    P."""
    import io
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.perturb.ops import (abo_zo_perturb,
                                                 abo_zo_perturb_plain)
    from repro_torch.launch import train as train_launch
    from repro_torch.models.model import Model
    from repro_torch.models.params import leaf_map
    from repro_torch.train import abo_zo

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = ARCHS[LM_ARCH]

    # ---- (a) K3-bwd against its plain version, then timed ---------------
    for r in train_bwd_readings(dev, seed):
        stride = (f", dO row stride {r['dout_stride']}" if "dout_stride" in r
                  else "")
        print(f"[train] (a) K3-bwd {r['shape']} {r['dtype']}{stride}: ran "
              f"{r['kernel']} (want {r['want_kernel']}); max |err| / "
              f"max |want| {r['rel']} (limit {BWD_TOL[r['dtype']]}), per row "
              f"{r['row']} (limit {BWD_ROW_TOL[r['dtype']]}), max abs "
              f"{r['abs']:.4g}; a second run the same bits {r['same_bits']}",
              flush=True)
        check(r["ok"], f"K3-bwd disagrees with its plain version at "
              f"{r['shape']} {r['dtype']}{stride}, gave other bits on a "
              f"repeat, or ran {r['kernel']} for {r['want_kernel']}")
        if r["shape"] == TRAIN_BWD_SHAPES[0][:8]:
            bwd_main = r
        if r["shape"] == TRAIN_BWD_SHAPES[1][:8]:
            bwd_reduced = r
        if r["shape"] == DENSE_BWD_SHAPE[:8]:
            bwd_granite = r
    rule = d_rule(dev, seed)
    for r in rule:
        print(f"[train] (a) D's rule at head_dim {r['d']} (v = 3 + 0.05 "
              f"randn, (2, 4, 448) causal): {r['kernel']} dQ against float64 "
              f"{r['err']:.4g} (limit {BWD_TOL['bfloat16']}); D from O "
              f"rounded to bf16 {r['err_rounded_o']:.4g} "
              f"({r['err_rounded_o'] / r['err']:.1f}x, must exceed "
              f"{D_RULE_RATIO}x)", flush=True)
        check(r["kernel"] == bwd_kernel_for("bfloat16", r["d"])
              and r["err"] < BWD_TOL["bfloat16"]
              and r["err_rounded_o"] > D_RULE_RATIO * r["err"],
              f"D's rule at head_dim {r['d']}: {r}")
    b, hq, hkv, d = TRAIN_B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = TRAIN_T
    bwd_adamw = bwd_times(dev, seed, b, hq, hkv, t, d, 20)
    print_bwd_times("[train] (a)", bwd_adamw)
    rb, rhq, rhkv, rt, _, rd = TRAIN_BWD_SHAPES[1][:6]   # the reduced config
    bwd_red = bwd_times(dev, seed, rb, rhq, rhkv, rt, rd, 20, "float32")
    print_bwd_times("[train] (a)", bwd_red)
    bwd_long = bwd_times(dev, seed, *BWD_LONG, 3, plain=False)
    print_bwd_times("[train] (a)", bwd_long)
    held = bwd_long_reading(dev, seed)
    bwd_long_plain = bwd_times(dev, seed, *BWD_LONG_HELD, 3)
    print_bwd_times("[train] (a)", bwd_long_plain)
    print(f"[train] (a) K3-bwd {held['shape']} bf16: ran {held['kernel']}; "
          f"max |err| / max |want| {held['rel']} (limit "
          f"{BWD_TOL['bfloat16']}), per row {held['row']} (limit "
          f"{BWD_ROW_TOL['bfloat16']}), max abs {held['abs']:.4g}; a second "
          f"run the same bits {held['same_bits']}", flush=True)
    check(held["ok"], f"the Hopper K3-bwd disagrees with its plain version "
          f"at {held['shape']}, gave other bits on a repeat, or ran "
          f"{held['kernel']}")
    ms = bwd_adamw["ms"]
    check(ms["sm90"] < ms["mma"], f"the Hopper K3-bwd ({ms['sm90']:.4f} ms) "
          f"is not faster than the mma.sync one ({ms['mma']:.4f} ms) at the "
          "AdamW shape")
    torch.cuda.empty_cache()

    # ---- (b) P against its plain version, bit for bit -------------------
    key = (123456789, 987654321)
    for n, offset, name in P_CASES:
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(n)
        src = torch.randn(n, generator=g, device=dev).to(dtype)
        got = abo_zo_perturb(torch.empty_like(src), src, key, offset, 0.0123)
        want = abo_zo_perturb_plain(torch.empty_like(src), src, key, offset,
                                    0.0123)
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        same = bool(torch.equal(got.view(view), want.view(view)))
        print(f"[train] (b) P on {n} {name} elements at leaf offset {offset}:"
              f" bit for bit its plain version {same}", flush=True)
        check(same, f"P differs from its plain version at n={n}, "
              f"offset={offset}, {name}")
    del src, got, want
    # over the whole model: the kernel into the probe buffer, timed, then
    # the plain version tensor by tensor against it
    model = Model(cfg, device=dev).init(seed)
    params = dict(model.named_parameters())
    n_par = sum(p.numel() for p in params.values())
    probe = {n: torch.empty_like(p) for n, p in params.items()}
    leaves = leaf_map(cfg)
    dir_key = abo_zo.fold_in(abo_zo.prng_key(1), 0)
    scale = np.float32(0.25) * np.float32(0.01)
    abo_zo.perturb_(probe, params, leaves, dir_key, scale)     # warm-up
    p_ms = cuda_ms(lambda: abo_zo.perturb_(probe, params, leaves, dir_key,
                                           scale), 3)
    p_plain_ms, p_same, p_err = 0.0, True, 0.0
    for n, p in params.items():
        leaf, offset = leaves[n]
        want = torch.empty_like(p)
        p_plain_ms += cuda_ms(lambda: abo_zo_perturb_plain(
            want, p, abo_zo.split_key(dir_key, leaf), offset, scale), 1)
        p_same &= bool(torch.equal(want.view(torch.int16),
                                   probe[n].view(torch.int16)))
        p_err = max(p_err, float((probe[n].float() - want.float()).abs()
                                 .max()))
        del want
    p_b, p_by, p_parts = p_bound(n_par, 2)
    print(f"[train] (b) P over the whole {LM_ARCH} ({n_par} bf16 parameters, "
          f"{len(params)} tensors): kernel {p_ms:.3f} ms, plain "
          f"{p_plain_ms:.1f} ms, bound {p_b:.3f} ms ({p_by}; {p_parts}), "
          f"{p_b / p_ms:.1%} of it; bit for bit the plain version {p_same}",
          flush=True)
    check(p_same, "P over the whole model differs from its plain version")
    del model, params, probe
    torch.cuda.empty_cache()

    # ---- (c) ABO-ZO on the whole model through the launcher --------------
    records = []
    counted = train_counted()
    torch.cuda.reset_peak_memory_stats()
    for w in counted:
        w.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with recorded_steps(records, counted), contextlib.redirect_stdout(log):
        final = train_launch.main(TRAIN_ARGS + [
            "--optimizer", "abo_zo", "--steps", str(ABO_STEPS),
            "--log-every", "1"])
    abo_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches_abo = {w.__name__: w.launches for w in counted}
    for line in log.getvalue().splitlines():
        print(f"[train] (c) {line}", flush=True)
    for i, r in enumerate(records):
        m = r["metrics"]
        print(f"[train] (c) ABO-ZO step {i + 1}: wall {r['wall']:.3f} s, loss "
              f"{m['loss']:.6f} (incumbent {m['incumbent']:.6f}, candidate "
              f"{int(m['best'])} won), launches {r['launches']}", flush=True)
        check(math.isfinite(m["loss"]) and m["loss"] <= m["incumbent"],
              f"ABO-ZO step {i + 1}: loss {m['loss']} not finite or above "
              f"its incumbent {m['incumbent']}")
        check(r["launches"]["flash_attention_sm90"]
              == (abo_zo.ABOZOConfig().m_candidates + 1) * cfg.n_layers
              and r["launches"]["flash_attention_mma"] == 0
              and r["launches"]["flash_attention_bwd"] == 0
              and r["launches"]["abo_zo_perturb"] > 0,
              f"ABO-ZO step {i + 1} launched {r['launches']}")
    param_bytes = 2 * n_par
    print(f"[train] (c) ABO-ZO on the whole {LM_ARCH}, {ABO_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_T} tokens: main() {abo_wall:.2f} s with the "
          f"draw, final loss {final:.6f}; step 2's loss {records[-1]['metrics']['loss']:.6f}"
          f" vs step 1's incumbent {records[0]['metrics']['incumbent']:.6f} "
          f"(two batches); peak device memory {peak} B = "
          f"{peak / param_bytes:.4f} x the bf16 parameter bytes "
          f"{param_bytes} (limit 2.5); launches {launches_abo}", flush=True)
    check(len(records) == ABO_STEPS and math.isfinite(final),
          "ABO-ZO did not run its steps to a finite loss")
    check(peak < 2.5 * param_bytes, f"ABO-ZO's peak {peak} B is not under "
          f"2.5 x the parameter bytes")
    torch.cuda.empty_cache()

    # ---- (d) AdamW at full width, ADAMW_LAYERS layers --------------------
    launches_adamw = adamw_cut(dev, seed, LM_ARCH, "[train] (d)")

    # ---- (e) resume on the card, bit for bit -----------------------------
    root = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    common = ["--arch", LM_ARCH, "--reduced", "--seq-len", "128", "--batch",
              "4", "--ckpt-every", "4", "--log-every", "100"]
    for w in counted:
        w.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        full = train_launch.main(common + ["--steps", "8", "--ckpt-dir",
                                           os.path.join(root, "a")])
        train_launch.main(common + ["--steps", "4", "--ckpt-dir",
                                    os.path.join(root, "b")])
        resumed = train_launch.main(common + ["--steps", "8", "--ckpt-dir",
                                              os.path.join(root, "b")])
    launches_e = {w.__name__: w.launches for w in counted}
    leaves_of = {}
    for run in ("a", "b"):
        d8 = os.path.join(root, run, f"step_{8:012d}")
        leaves_of[run] = [np.load(os.path.join(d8, f))
                          for f in sorted(os.listdir(d8)) if f.endswith(".npy")]
    same = (len(leaves_of["a"]) == len(leaves_of["b"]) > 0
            and all(x.dtype == y.dtype and np.array_equal(x, y)
                    for x, y in zip(leaves_of["a"], leaves_of["b"])))
    print(f"[train] (e) reduced {LM_ARCH} (float32) 8 AdamW steps vs 4 + a "
          f"resume to 8: final loss {full!r} vs {resumed!r}; parameters and "
          f"optimizer state bit for bit {same} ({len(leaves_of['a'])} "
          f"leaves); launches {launches_e}", flush=True)
    check(same and full == resumed, "the resumed run differs from the "
          "uninterrupted one")
    check(launches_e["flash_attention_mma"] > 0
          and launches_e["flash_attention_bwd"]
          == launches_e["flash_attention_bwd_mma"] > 0
          and launches_e["flash_attention_bwd_sm90"] == 0,
          "the reduced run did not go through the mma kernel and the "
          "mma.sync K3-bwd")
    shutil.rmtree(root, ignore_errors=True)

    total_s = time.perf_counter() - t_phase
    print(f"[train] phase took {total_s:.1f} s (limit {TRAIN_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total_s <= TRAIN_PHASE_S, f"the training phase took {total_s:.1f} s")
    note = ("port only: stands for the autodiff of "
            "src/repro/kernels/flash_attention/ref.py::attention_ref")
    return [
        {"name": "flash_attention_bwd_sm90", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
         "replaces": None, "note": note,
         "launches": launches_adamw["flash_attention_bwd_sm90"],
         "max_abs_err": bwd_main["abs"], "ms": bwd_adamw["ms"]["sm90"],
         "plain_ms": bwd_adamw["plain_ms"], "bound_ms": bwd_adamw["bound_ms"],
         "bound_by": bwd_adamw["bound_by"],
         "library_ms": bwd_adamw["ms"]["sdpa"],
         "launches_of": f"{ADAMW_STEPS} AdamW steps, {LM_ARCH} at "
                        f"{ADAMW_LAYERS} layers",
         "max_abs_err_of": f"bf16 at ({b}, {hq}/{hkv}, {t}, {d}), causal",
         "max_rel_err": bwd_main["rel"], "row_rel_err": bwd_main["row"],
         "d_rule": rule,
         "library": "scaled_dot_product_attention's backward",
         "long": {"shape": bwd_long["shape"],
                  "ms": bwd_long["ms"]["sm90"],
                  "library_ms": bwd_long["ms"]["sdpa"],
                  "bound_ms": bwd_long["bound_ms"],
                  "bound_by": bwd_long["bound_by"],
                  "held_at": bwd_long_plain["shape"],
                  "held_ms": bwd_long_plain["ms"]["sm90"],
                  "held_plain_ms": bwd_long_plain["plain_ms"],
                  "max_abs_err": held["abs"], "max_rel_err": held["rel"],
                  "row_rel_err": held["row"]},
         DENSE_LONG_ARCH: {"max_abs_err": bwd_granite["abs"],
                           "max_rel_err": bwd_granite["rel"],
                           "row_rel_err": bwd_granite["row"]}},
        {"name": "flash_attention_bwd_mma", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": None, "note": note,
         "launches": launches_e["flash_attention_bwd_mma"],
         "max_abs_err": bwd_reduced["abs"], "ms": bwd_red["ms"]["mma"],
         "plain_ms": bwd_red["plain_ms"], "bound_ms": bwd_red["bound_ms"],
         "bound_by": bwd_red["bound_by"],
         "library_ms": bwd_red["ms"]["sdpa"],
         "launches_of": f"reduced {LM_ARCH} (float32), 8 + 4 + 4 AdamW "
                        "steps (the resume)",
         "max_abs_err_of": f"float32 at {bwd_red['shape']}",
         "max_rel_err": bwd_reduced["rel"], "row_rel_err": bwd_reduced["row"],
         "library": "scaled_dot_product_attention's backward",
         "at_adamw_shape": {"shape": bwd_adamw["shape"],
                            "ms": bwd_adamw["ms"]["mma"],
                            "long_ms": bwd_long["ms"]["mma"]}},
        {"name": "abo_zo_perturb", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/abo_zo_perturb.cu",
         "replaces": None,
         "note": "port only: stands for src/repro/train/abo_zo.py:37 "
                 "(_perturb)",
         "launches": launches_abo["abo_zo_perturb"], "max_abs_err": p_err,
         "ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": p_b,
         "bound_by": p_by, "library_ms": None,
         "launches_of": f"{ABO_STEPS} ABO-ZO steps on the whole {LM_ARCH}",
         "ms_of": f"the whole {LM_ARCH}, {n_par} bf16 parameters"},
    ]


# ---------------------------------------------------------------------------
# phase 16: the mixture-of-experts family
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def lossless(model):
    """Run ``model`` with its MoE layers at capacity None (no slot dropped),
    the capacity its prefill and decode dispatch at."""
    import dataclasses
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, moe_capacity_factor=None)
    try:
        yield model
    finally:
        model.cfg = saved


@contextlib.contextmanager
def recorded_routes(routes: list, own: list | None = None, pinned=None):
    """Append each MoE dispatch's experts, (T, k), to ``routes`` in call
    order. With ``pinned`` (another run's ``routes``), dispatch i goes to
    ``pinned[i]``'s experts instead, gated by this run's probabilities
    there as the router gates its own, and the experts this run would have
    chosen go to ``own``."""
    from repro_torch.models import moe
    route = moe.route

    def recording(params, cfg, tokens):
        probs, gates, idx = route(params, cfg, tokens)
        if pinned is not None:
            own.append(idx)
            idx = pinned[len(routes)]
            gates = probs.gather(-1, idx)
            if cfg.renorm_gates:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        routes.append(idx)
        return probs, gates, idx

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def route_readings(a: list, b: list):
    """Two runs' routes, dispatch by dispatch ((T, k) each): the share of
    (token, dispatch, slot) routes of ``a`` whose expert is not among
    ``b``'s top-k there (see MOE_ROUTE_SHARE), the share that differ in
    order only or more, each dispatch's share, and whether each token's
    routes agree in every dispatch, (T,)."""
    import torch
    differ = torch.stack([~(x[:, :, None] == y[:, None, :]).any(-1)
                          for x, y in zip(a, b)])             # (L, T, k)
    order = float(torch.stack([x != y for x, y in zip(a, b)]).float().mean())
    per = [round(float(d.float().mean()), 5) for d in differ]
    return (float(differ.float().mean()), order, per,
            ~differ.any(-1).any(0))


def logits_rel(full, ref, chunk: int = 512):
    """Per position of the first sequence: max |full - ref| over the
    reference's max |logit| there, a chunk of positions at a time."""
    import torch
    out = []
    for a in range(0, ref.shape[1], chunk):
        x, y = full[0, a:a + chunk].float(), ref[0, a:a + chunk].float()
        out.append((x - y).abs().amax(-1) / y.abs().amax(-1))
    return torch.cat(out)


def moe_kernel_times(dev, seed: int) -> dict:
    """K3 at the MoE models' layer shape (1, 16/16, LM_T, 128) bf16 causal
    (MHA) against its plain version, then K3 and SDPA timed in turns; both
    K3-bwd kernels and SDPA's backward timed in turns at olmoe's AdamW shape
    (TRAIN_B, 16/16, TRAIN_T, 128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _qkv(dev, seed, 1, 16, 16, LM_T, LM_T, 128, torch.bfloat16)
    check(fa.choose_kernel(q, k, v) == "flash_attention_sm90",
          "the MoE layer shape does not go to flash_attention_sm90")
    got = fa.flash_attention_sm90(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    row = row_rel_err(got, want)
    del got, want
    runs = {"kernel": lambda: fa.flash_attention_sm90(q, k, v),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)}
    runs["sdpa"]()
    ms = {n: [] for n in runs}
    for n in ("kernel", "sdpa", "sdpa", "kernel"):
        ms[n].append(cuda_ms(runs[n], 20))
    bound, by = k3_bound(1, 16, 16, LM_T, 128)
    out = {"k3": {"shape": f"bf16 (1, 16/16, {LM_T}, 128) causal",
                  "max_abs_err": err, "row_rel_err": row,
                  "ms": sum(ms["kernel"]) / 2,
                  "library_ms": sum(ms["sdpa"]) / 2, "bound_ms": bound,
                  "bound_by": by}}
    print(f"[moe] K3 at (1, 16/16, {LM_T}, 128) bf16 causal: max abs err "
          f"{err:.3g} (limit {ATTN_TOL['bfloat16']}), per row {row:.3g} "
          f"(limit {ATTN_ROW_TOL['bfloat16']}); in turns kernel "
          f"{ms['kernel']} ms, SDPA {ms['sdpa']} ms; bound {bound:.4f} ms "
          f"({by})", flush=True)
    check(err < ATTN_TOL["bfloat16"] and row < ATTN_ROW_TOL["bfloat16"],
          "K3 disagrees with its plain version at the MoE layer shape")
    del q, k, v, runs

    # device time alone: at ~0.18 ms a call of three launches and a Python
    # wrapper, a host stall inside the events' window once read 1.2305 ms
    # (PERF.md section 7); the events' reading is printed beside it
    r = bwd_times(dev, seed, TRAIN_B, 16, 16, TRAIN_T, 128, 20, plain=False,
                  device_only=True)
    print_bwd_times("[moe]", r)
    ms = r["ms"]
    check(ms["sm90"] < ms["mma"], f"the Hopper K3-bwd ({ms['sm90']:.4f} ms) "
          f"is not faster than the mma.sync one ({ms['mma']:.4f} ms) at "
          "olmoe's AdamW shape")
    out["bwd"] = {"shape": r["shape"], "ms": ms["sm90"],
                  "library_ms": ms["sdpa"], "mma_ms": ms["mma"],
                  "timer": "queued_ms (device only)",
                  "turns_events": r["turns_events"],
                  "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
    return out


def moe_serving(dev, seed: int, arch: str) -> int:
    """(a) and (b) of phase 16 for one config: the prefill step (wall,
    tokens/s, peak memory, K3's launches); the lossless forward with K3
    against the same with the plain attention (K3 per row on each layer's
    own q, k, v; routes; logits where the routes agree); prefill + decode
    against the lossless forward. Returns the prefill step's launches of
    the Hopper kernel."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_mma, flash_attention_sm90)
    from repro_torch.models.model import Model
    from repro_torch.train.steps import make_prefill_step

    cfg = ARCHS[arch]
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[moe] {arch}: {n_par} parameters ({n_bytes / 1e9:.2f} GB: bf16, "
          f"the routers float32), {cfg.n_layers} layers of which {n_moe} MoE "
          f"({cfg.n_experts} experts, top {cfg.top_k}, "
          f"{cfg.n_shared_experts} shared), {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}; drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :LM_T]}
    step = make_prefill_step(model)
    step(batch)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_sm90.launches = flash_attention_mma.launches = 0
    t0 = time.perf_counter()
    last = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_sm90.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[moe] {arch} prefill step, 1 x {LM_T} tokens at capacity "
          f"{cfg.moe_capacity_factor} (chunks of {cfg.moe_dispatch_chunk}): "
          f"wall {wall:.4f} s, {LM_T / wall:.1f} tokens/s, K3 launches: "
          f"flash_attention_sm90 {launches}, flash_attention_mma "
          f"{flash_attention_mma.launches}; peak device memory {peak} B "
          f"({peak / n_bytes:.4f} x the parameter bytes)", flush=True)
    check(launches == cfg.n_layers and flash_attention_mma.launches == 0
          and flash_attention.launches == cfg.n_layers,
          f"{arch}'s prefill step launched flash_attention_sm90 {launches} "
          f"times and flash_attention_mma {flash_attention_mma.launches} "
          f"times, want {cfg.n_layers} and 0")
    check(tuple(last.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(last).all()),
          f"{arch}'s prefill-step logits are not finite or of the wrong shape")
    del last
    torch.cuda.empty_cache()

    # ---- K3 against the plain attention, lossless ------------------------
    k3_routes, plain_routes, layer_err = [], [], []
    pinned_routes, pinned_own = [], []
    with lossless(model):
        with recorded_routes(k3_routes):
            full, _ = model.forward(batch["tokens"])
        t0 = time.perf_counter()
        with plain_attention(layer_err), recorded_routes(plain_routes):
            ref, _ = model.forward(batch["tokens"])
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        rel = logits_rel(full, ref)
        last_equal = int(full[0, -1].argmax()) == int(ref[0, -1].argmax())
        del ref
        with plain_attention([]), recorded_routes(
                pinned_routes, pinned_own, pinned=k3_routes):
            ref, _ = model.forward(batch["tokens"])
        rel_pinned = logits_rel(full, ref)
        with library_attention(), recorded_routes([], [], pinned=k3_routes):
            lib, _ = model.forward(batch["tokens"])
    lib_pinned = logits_rel(lib, ref)
    del full, ref, lib
    share, order, per, agree = route_readings(k3_routes, plain_routes)
    share_pinned, _, per_pinned, _ = route_readings(k3_routes, pinned_own)
    del k3_routes, plain_routes, pinned_routes, pinned_own
    n_agree = int(agree.sum())
    held = float(rel[agree].max()) if n_agree else math.inf
    print(f"[moe] {arch} lossless forward over {LM_T}, K3 vs plain attention "
          f"(plain run {plain_wall:.2f} s): K3 per row on each layer's own "
          f"q, k, v: max {max(layer_err):.4g} (limit "
          f"{ATTN_ROW_TOL['bfloat16']}), per layer "
          f"{[round(e, 5) for e in layer_err]}", flush=True)
    print(f"[moe] {arch} routes, K3 run vs plain run: {share:.5f} of "
          f"(token, layer, slot) routes differ (limit {MOE_ROUTE_SHARE}; "
          f"{order:.5f} differ in order or more), per MoE layer {per}; "
          f"positions whose routes agree in every layer {n_agree} of {LM_T} "
          f"(limit >= {MOE_AGREE_MIN.get(arch, 0.0):.0%})", flush=True)
    print(f"[moe] {arch} logits, max abs diff over max |logit| per position:"
          f" where the routes agree max {held:.4g} (limit {MOE_REL_TOL}); "
          f"over all positions max {float(rel.max()):.4g}, first "
          f"{LM_EARLY} {float(rel[:LM_EARLY].max()):.4g}, last "
          f"{float(rel[-1]):.4g}; argmax equal at the last {last_equal}",
          flush=True)
    print(f"[moe] {arch} plain attention with its routes pinned to the K3 "
          f"run's: logits max abs diff over max |logit| at every position: "
          f"max {float(rel_pinned.max()):.4g} (limit {LM_REL_TOL_PLAIN}), "
          f"first {LM_EARLY} {float(rel_pinned[:LM_EARLY].max()):.4g}, last "
          f"{float(rel_pinned[-1]):.4g}; the routes it would have taken "
          f"differ at {share_pinned:.5f} (per MoE layer {per_pinned})",
          flush=True)
    print(f"[moe] {arch} scaled_dot_product_attention in K3's place, the "
          f"routes pinned to the K3 run's: logits max abs diff over max "
          f"|logit| against the plain run's at every position: max "
          f"{float(lib_pinned.max()):.4g}, first {LM_EARLY} "
          f"{float(lib_pinned[:LM_EARLY].max()):.4g}, last "
          f"{float(lib_pinned[-1]):.4g}; K3's max is "
          f"{float(rel_pinned.max()) / max(float(lib_pinned.max()), 1e-30):.3f}"
          f" x it "
          f"(limit {MOE_LIBRARY_RATIO})", flush=True)
    check(len(layer_err) == cfg.n_layers
          and max(layer_err) < ATTN_ROW_TOL["bfloat16"],
          f"K3 disagrees with its plain version on {arch}'s own q, k, v")
    check(share <= MOE_ROUTE_SHARE and held <= MOE_REL_TOL
          and n_agree >= MOE_AGREE_MIN.get(arch, 0.0) * LM_T
          and float(rel_pinned.max()) <= MOE_PINNED_TOL.get(arch, math.inf)
          and rel_pinned.max() <= MOE_LIBRARY_RATIO * lib_pinned.max(),
          f"{arch}'s forward with K3 disagrees with its plain-attention runs")
    torch.cuda.empty_cache()

    # ---- prefill + decode against the lossless forward ----------------------
    fwd_routes, dec_routes = [], []
    with lossless(model), recorded_routes(fwd_routes):
        full, _ = model.forward(tokens)
    want = full[0, LM_T - 1:].float()
    del full
    flash_attention.launches = 0
    with recorded_routes(dec_routes):
        logits_pre, cache = model.prefill(tokens[:, :LM_T],
                                          max_len=LM_T + LM_DECODE)
        check(flash_attention.launches == cfg.n_layers,
              f"{arch}'s Model.prefill launched K3 {flash_attention.launches}"
              " times")
        outs = [logits_pre[:, -1].float()]
        del logits_pre
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_T, LM_T + LM_DECODE):
            lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
            outs.append(lg[:, 0].float())
        torch.cuda.synchronize()
        dec_ms = 1e3 * (time.perf_counter() - t0) / LM_DECODE
    del cache
    got = torch.cat(outs)
    err = (got - want).abs().amax(dim=-1)
    scale = float(want.abs().max())
    # the routes of each compared position: the prefill's at LM_T - 1, then
    # each decode step's, against the forward's at the same position
    mine = [[r[LM_T - 1:] for r in dec_routes[:n_moe]]] + [
        dec_routes[n_moe * (j + 1):n_moe * (j + 2)] for j in range(LM_DECODE)]
    agrees = [all(bool((m[0][:, None] == f[LM_T - 1 + j][None, :]).any(-1)
                       .all()) for m, f in zip(ms, fwd_routes))
              for j, ms in enumerate(mine)]
    rel_dec = (err / scale).tolist()
    held = max(r for r, a in zip(rel_dec, agrees) if a) if any(agrees) \
        else math.inf
    print(f"[moe] {arch} prefill({LM_T}) + {LM_DECODE} decode steps vs the "
          f"lossless forward over {LM_T + LM_DECODE}: max abs diff over max "
          f"|logit| per position {[round(r, 5) for r in rel_dec]}, routes "
          f"agree {agrees}; where they agree max {held:.4g} (limit "
          f"{MOE_REL_TOL}); argmax equal "
          f"{(got.argmax(-1) == want.argmax(-1)).tolist()}; {dec_ms:.2f} ms "
          f"per decode step", flush=True)
    check(agrees[0] and held <= MOE_REL_TOL,
          f"{arch}'s prefill + decode disagrees with the lossless forward")
    del model, got, want, outs, fwd_routes, dec_routes
    torch.cuda.empty_cache()
    return launches


def moe_train(dev, seed: int) -> dict:
    """(c) of phase 16 on olmoe: P on the MoE tree, then ABO-ZO on the whole
    model through the launcher, then AdamW at ADAMW_LAYERS layers. Returns
    the launches and times for the kernels line."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import BigramStream, StreamConfig
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_mma,
        flash_attention_bwd_sm90)
    from repro_torch.kernels.perturb.ops import (abo_zo_perturb,
                                                 abo_zo_perturb_plain)
    from repro_torch.launch import train as train_launch
    from repro_torch.models.model import Model
    from repro_torch.models.params import leaf_map
    from repro_torch.train import abo_zo, steps as steps_mod

    arch = MOE_TRAIN_ARCH
    cfg = ARCHS[arch]
    counted = train_counted()
    out = {}

    # ---- P over the MoE tree: a float32 router and a stacked expert leaf --
    model = Model(cfg, device=dev).init(seed)
    params = dict(model.named_parameters())
    n_par = sum(p.numel() for p in params.values())
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    leaves = leaf_map(cfg)
    dir_key = abo_zo.fold_in(abo_zo.prng_key(1), 0)
    scale = np.float32(0.25) * np.float32(0.01)
    last = cfg.n_layers - 1
    for n in (f"decoder.{last}.moe.router", f"decoder.{last}.moe.w_in"):
        p = params[n]
        leaf, offset = leaves[n]
        key = abo_zo.split_key(dir_key, leaf)
        got = abo_zo_perturb(torch.empty_like(p), p, key, offset, scale)
        want = abo_zo_perturb_plain(torch.empty_like(p), p, key, offset,
                                    scale)
        view = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
        same = bool(torch.equal(got.view(view), want.view(view)))
        print(f"[moe] (c) P on {n} ({str(p.dtype).split('.')[-1]}, "
              f"{p.numel()} elements at leaf {leaf}, offset {offset}): bit "
              f"for bit its plain version {same}", flush=True)
        check(same, f"P differs from its plain version on {n}")
        del got, want
    probe = {n: torch.empty_like(p) for n, p in params.items()}
    abo_zo.perturb_(probe, params, leaves, dir_key, scale)     # warm-up
    p_ms = cuda_ms(lambda: abo_zo.perturb_(probe, params, leaves, dir_key,
                                           scale), 3)
    p_b, p_by, _ = p_bound(n_par, n_bytes / n_par)
    out["p"] = {"ms": p_ms, "bound_ms": p_b, "bound_by": p_by,
                "ms_of": f"the whole {arch}, {n_par} parameters"}
    print(f"[moe] (c) P over the whole {arch} ({n_par} parameters, "
          f"{len(params)} tensors): {p_ms:.3f} ms, bound {p_b:.3f} ms "
          f"({p_by}), {p_b / p_ms:.1%} of it", flush=True)
    del model, params, probe
    torch.cuda.empty_cache()

    # ---- ABO-ZO on the whole model through the launcher --------------------
    records = []
    torch.cuda.reset_peak_memory_stats()
    for w in counted:
        w.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with recorded_steps(records, counted), contextlib.redirect_stdout(log):
        final = train_launch.main([
            "--arch", arch, "--seq-len", str(TRAIN_T), "--batch",
            str(TRAIN_B), "--optimizer", "abo_zo", "--steps", str(ABO_STEPS),
            "--log-every", "1"])
    abo_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    out["abo_launches"] = {w.__name__: w.launches for w in counted}
    for line in log.getvalue().splitlines():
        print(f"[moe] (c) {line}", flush=True)
    for i, r in enumerate(records):
        m = r["metrics"]
        print(f"[moe] (c) ABO-ZO step {i + 1}: wall {r['wall']:.3f} s, loss "
              f"{m['loss']:.6f} (incumbent {m['incumbent']:.6f}, candidate "
              f"{int(m['best'])} won), launches {r['launches']}", flush=True)
        check(math.isfinite(m["loss"]) and m["loss"] <= m["incumbent"],
              f"ABO-ZO step {i + 1} on {arch}: loss {m['loss']} not finite or "
              f"above its incumbent {m['incumbent']}")
        check(r["launches"]["flash_attention_sm90"]
              == (abo_zo.ABOZOConfig().m_candidates + 1) * cfg.n_layers
              and r["launches"]["flash_attention_mma"] == 0
              and r["launches"]["flash_attention_bwd"] == 0
              and r["launches"]["abo_zo_perturb"] > 0,
              f"ABO-ZO step {i + 1} on {arch} launched {r['launches']}")
    print(f"[moe] (c) ABO-ZO on the whole {arch}, {ABO_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_T} tokens: main() {abo_wall:.2f} s with the "
          f"draw, final loss {final:.6f}; peak device memory {peak} B = "
          f"{peak / n_bytes:.4f} x the parameter bytes {n_bytes} (limit "
          f"2.5); launches {out['abo_launches']}", flush=True)
    check(len(records) == ABO_STEPS and math.isfinite(final),
          f"ABO-ZO did not run its steps on {arch} to a finite loss")
    check(peak < 2.5 * n_bytes, f"ABO-ZO's peak {peak} B on {arch} is not "
          "under 2.5 x the parameter bytes")
    torch.cuda.empty_cache()

    # ---- AdamW at ADAMW_LAYERS layers ----------------------------------------
    cfg4 = dataclasses.replace(cfg, n_layers=ADAMW_LAYERS)
    model = Model(cfg4, device=dev).init(seed).requires_grad_(True)
    n4 = sum(p.numel() for p in model.parameters())
    stream = BigramStream(StreamConfig(vocab_size=cfg4.vocab_size,
                                       seq_len=TRAIN_T, global_batch=TRAIN_B))
    batch0 = {"tokens": stream.torch_batch(0, dev)}

    def loss_and_grads():
        """Step 1's loss, aux and gradients, remat off: each dispatch routes
        once, in order, so that a second run can be pinned to its routes."""
        for p in model.parameters():
            p.grad = None
        loss, metrics = model.loss(batch0)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), float(metrics["aux"].detach()), grads

    k3_routes, pinned_routes, plain_routes = [], [], []
    before = [w.launches for w in (flash_attention_bwd,
                                   flash_attention_bwd_sm90,
                                   flash_attention_bwd_mma)]
    with recorded_routes(k3_routes):
        loss_k3, aux_k3, g_k3 = loss_and_grads()
    bwd_launched, sm90_launched, mma_launched = (
        w.launches - n for w, n in zip((flash_attention_bwd,
                                        flash_attention_bwd_sm90,
                                        flash_attention_bwd_mma), before))
    with plain_attention([]), recorded_routes(pinned_routes, plain_routes,
                                              pinned=k3_routes):
        loss_plain, _, g_plain = loss_and_grads()
    share, order, _, _ = route_readings(k3_routes, plain_routes)
    del k3_routes, pinned_routes, plain_routes
    grad_rel = {n: float((g_k3[n].float() - g_plain[n].float()).abs().max()
                         / g_plain[n].float().abs().max()) for n in g_k3}
    del g_k3, g_plain
    qkv = [n for n in grad_rel if n.split(".")[-1] in ("wq", "wk", "wv")]
    worst = max(grad_rel, key=grad_rel.get)
    router = max(v for n, v in grad_rel.items() if n.endswith(".router"))
    loss_rel = abs(loss_k3 - loss_plain) / abs(loss_plain)
    print(f"[moe] (d) {arch} cut to {ADAMW_LAYERS} of {cfg.n_layers} layers "
          f"({n4} parameters): step 1's loss with K3 {loss_k3:.6f}, with the "
          f"plain attention (routes pinned to K3's) {loss_plain:.6f} "
          f"(relative {loss_rel:.3g}, limit {ADAMW_LOSS_TOL}); gradients, max "
          f"|diff| / max |plain| per tensor: worst {worst} "
          f"{grad_rel[worst]:.4g} (limit {ADAMW_GRAD_TOL}), routers "
          f"{router:.4g}, wq/wk/wv {max(grad_rel[n] for n in qkv):.4g}; the "
          f"plain run's own routes differ from K3's at {share:.5f} of "
          f"(token, dispatch, slot) ({order:.5f} in order or more); aux "
          f"{aux_k3:.6f} (limit >= {MOE_AUX_MIN}); K3-bwd launches "
          f"{bwd_launched} (Hopper {sm90_launched}, mma.sync "
          f"{mma_launched})", flush=True)
    check(loss_rel <= ADAMW_LOSS_TOL and grad_rel[worst] <= ADAMW_GRAD_TOL
          and bwd_launched == sm90_launched == ADAMW_LAYERS
          and mma_launched == 0 and aux_k3 >= MOE_AUX_MIN,
          f"AdamW's step 1 on {arch} with K3 disagrees with the plain "
          "attention's, did not run K3-bwd in every layer, or aux is low")
    step = steps_mod.make_train_step(model, optimizer="adamw", remat=True)
    state = steps_mod.init_opt_state(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in counted:
        w.launches = 0
    walls, losses, auxes = [], [], []
    for s in range(ADAMW_STEPS):
        batch = {"tokens": stream.torch_batch(s, dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        auxes.append(float(met["aux"]))
    out["adamw_launches"] = {w.__name__: w.launches for w in counted}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[moe] (d) AdamW, {ADAMW_STEPS} steps of {TRAIN_B} x {TRAIN_T} "
          f"tokens, remat: wall per step {[round(w, 4) for w in walls]} s, "
          f"losses {losses}, aux {auxes}; launches {out['adamw_launches']}; "
          f"peak device memory {peak} B = {peak / (2 * n4):.3f} x the bf16 "
          f"parameter bytes; 16 bytes a parameter for all {cfg.n_layers} "
          f"layers: {16 * cfg.n_params()} B against the card's {total} B",
          flush=True)
    check(all(math.isfinite(x) for x in losses)
          and all(a >= MOE_AUX_MIN for a in auxes),
          f"AdamW's loss on {arch} is not finite or its aux is low")
    launched = out["adamw_launches"]
    check(launched["flash_attention_sm90"] >= ADAMW_STEPS * ADAMW_LAYERS
          and launched["flash_attention_bwd"]
          == launched["flash_attention_bwd_sm90"]
          == ADAMW_STEPS * ADAMW_LAYERS
          and launched["flash_attention_mma"] == 0
          and launched["flash_attention_bwd_mma"] == 0,
          f"AdamW's steps on {arch} launched {launched}: K3 and the Hopper "
          "K3-bwd not in every layer, or a mma.sync kernel ran")
    del model, step, state, met
    torch.cuda.empty_cache()
    return out


def moe_phase(dev, seed: int) -> dict:
    """Phase 16, the mixture-of-experts family (see MOE_ARCHS). Returns its
    readings for the kernels line."""
    import io

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = moe_kernel_times(dev, seed)
    out["prefill_launches"] = {}
    for arch in MOE_ARCHS:
        out["prefill_launches"][arch] = moe_serving(dev, seed, arch)
        if arch != MOE_TRAIN_ARCH:
            continue
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            outputs = serve.main(["--arch", arch, "--requests", "8",
                                  "--batch-slots", "4", "--prompt-len", "16",
                                  "--max-new", "16", "--max-len", "256"])
        for line in log.getvalue().splitlines():
            print(f"[moe] {arch} {line.strip()}", flush=True)
        print(f"[moe] {arch} serve main() took {time.perf_counter() - t0:.2f} "
              "s with the model's draw", flush=True)
        vocab = ARCHS[arch].vocab_size
        check(len(outputs) == 8
              and all(len(g) == 16 and all(0 <= x < vocab for x in g)
                      for _, g in outputs),
              f"the serve launcher on {arch} did not answer 8 requests with "
              "16 tokens")
        torch.cuda.empty_cache()
    out.update(moe_train(dev, seed))
    total = time.perf_counter() - t_phase
    print(f"[moe] phase took {total:.1f} s (limit {MOE_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= MOE_PHASE_S, f"the MoE phase took {total:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the hybrid family (RG-LRU and local attention at head_dim 256)
# ---------------------------------------------------------------------------
def scan_bound(b, t, d) -> tuple[float, str]:
    """Least time for S on (b, t, d) bf16: u, xi and xr read once, h
    written once (bf16), the last h (float32); against the gates' and the
    recurrence's float32 operations (the two sigmoids' exp, add and
    reciprocal, exp, 1 - a², max, sqrt, three products; a multiply and an
    add a step), a transcendental counted as one."""
    return bound_ms(2 * 4 * b * t * d + 4 * b * d, 15 * b * t * d)


def s_build_issue(n: int) -> dict:
    """This run's build of S, counted: its gate instructions an element
    (``benchmarks_torch.s_sass`` on ``cuobjdump -sass`` of the library
    just built) and, for n elements, their time in ms at the issue rate
    and at the ALU and MUFU pipes' rates."""
    from benchmarks_torch.s_sass import count, disassemble
    per = count(disassemble())["per_element"]
    n_lanes = n / (SMS * CLOCK_HZ)
    return {"per_element": per,
            "issue_ms": 1e3 * n_lanes * sum(per.values()) / ISSUE_LANES,
            "alu_ms": 1e3 * n_lanes * per.get("alu", 0) / PIPE_RATE["alu"],
            "mufu_ms": 1e3 * n_lanes * per.get("mufu", 0) / PIPE_RATE["mufu"]}


def queued(fn, reps: int):
    """``fn()`` back to back, queued by the host while the device sleeps:
    (the mean device time a call, the mean host time a call to queue it),
    in ms. The first is the device's alone while the host's whole queueing
    stays within the sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` back to back: the device sleeps while
    the host queues every call, so a call whose host side outlasts its
    kernel (S's wrapper) is timed on the device alone."""
    return queued(fn, reps)[0]


def lru_inputs(dev, g, shape):
    """u, xi, xr of the model's scale (N(0, 1), bf16) and Λ from its init."""
    import torch
    from repro_torch.models.rglru import log_lambda_init
    u, xi, xr = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(3))
    return u, xi, xr, log_lambda_init(shape[2], dev).to(torch.bfloat16)


def hybrid_kernels(dev, seed: int) -> tuple[dict, dict]:
    """S against its plain version bit for bit at SCAN_SHAPES, twice; S's
    two shortcuts on every input; S, the eager elementwise work it replaced
    and its plain version timed at recurrentgemma-2b's shape, and its build's
    gate instructions counted; K3 at head_dim 256 (with its plain version
    and SDPA, in turns). Returns the two kernels' entries of the kernels
    line, without launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_plain, flash_attention_sm90_d256)
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ops import (rglru_lru,
                                                    shortcut_mismatches)
    from repro_torch.kernels.rglru_scan.ref import (decay_rate,
                                                    rglru_gates_ref,
                                                    rglru_lru_ref)

    bad = shortcut_mismatches(dev)
    print(f"[S] shortcuts: the bf16 sigmoid rule differs from torch.sigmoid "
          f"on {bad['sigmoid_bf16']} of all 65536 bf16 inputs, the square "
          f"root from __fsqrt_rn on {bad['sqrt']} of the floats in [1e-12, "
          f"1]", flush=True)
    check(bad == {"sigmoid_bf16": 0, "sqrt": 0},
          f"S's shortcuts are not exact: {bad}")
    g = torch.Generator(device=dev).manual_seed(seed)
    for shape in SCAN_SHAPES[::-1]:      # the model's shape, timed, last
        u, xi, xr, lam = lru_inputs(dev, g, shape)
        before = rglru_lru.launches
        (h, last), (h2, last2) = (rglru_lru(u, xi, xr, lam),
                                  rglru_lru(u, xi, xr, lam))
        want, want_last = rglru_lru_ref(u, xi, xr, lam)
        torch.cuda.synchronize()
        bits = bool(torch.equal(h, want) and torch.equal(last, want_last))
        same = bool(torch.equal(h, h2) and torch.equal(last, last2))
        err = float((h.float() - want.float()).abs().max())
        moved = rglru_lru.launches - before
        print(f"[S] {shape} bf16: bit for bit its plain version {bits} (h "
              f"and the last h), the same bits on a repeat {same}, max abs "
              f"diff {err:.3g}; launches {moved}", flush=True)
        check(bits and same and moved == 2
              and bool(torch.isfinite(h).all()),
              f"S is not its plain version's bits at {shape}, or not twice")
    del h, h2, want
    # timed on the device alone (queued_ms), kernel and eager path in turns
    nsp = decay_rate(lam)
    h = torch.empty_like(u)
    last = torch.empty(shape[0], shape[2], device=dev)

    def kernel():
        ops._launch(u, xi, xr, nsp, h, last)

    def eager():
        # the elementwise work the kernel took over from eager torch: the
        # gates, and the cast of a float32 (b, T, d) to the model's type
        # (the recurrence, now the kernel's own, is not in it)
        a_, b_ = rglru_gates_ref(xi, xr, u, nsp)
        return b_.to(torch.bfloat16)

    runs = {"kernel": (kernel, 50), "eager": (eager, 10),
            "op": (lambda: rglru_lru(u, xi, xr, lam), 50)}
    t_ms = {name: [] for name in runs}
    for order in (("kernel", "op", "eager"), ("eager", "op", "kernel")):
        for name in order:
            t_ms[name].append(queued_ms(*runs[name]))
    mean = {name: sum(v) / len(v) for name, v in t_ms.items()}
    plain_ms = cuda_ms(lambda: rglru_lru_ref(u, xi, xr, lam), 1)
    s_bound, s_by = scan_bound(*shape)
    issue = s_build_issue(shape[0] * shape[1] * shape[2])
    print(f"[S] {shape} bf16, in turns: kernel {t_ms['kernel']} ms, the op "
          f"with its Λ prep {t_ms['op']} ms, the eager elementwise work it "
          f"took over (the gates' elementwise ops and a cast of a float32 "
          f"(b, T, d) to bf16; no recurrence) {t_ms['eager']} ms; plain "
          f"version {plain_ms:.2f} ms; bound {s_bound:.4f} ms ({s_by}), "
          f"{s_bound / mean['kernel']:.1%} of it; the three-launch S it "
          f"replaced {S_THREE_LAUNCH_MS} ms (its recorded reading, PERF.md; "
          f"not re-timed here); this build's gates "
          f"{sum(issue['per_element'].values())} instructions an element "
          f"{issue['per_element']}: {issue['issue_ms']:.4f} ms at the issue "
          f"rate, ALU pipe {issue['alu_ms']:.4f}, MUFU "
          f"{issue['mufu_ms']:.4f}; no library call computes the RG-LRU | "
          f"{nvidia_smi_line()}", flush=True)
    check(s_bound <= mean["kernel"], "S beat its bound: the bound is not a "
          "floor")
    del u, xi, xr, h, last
    scan = {"name": "rglru_lru", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "port only: stands for _gates' elementwise part and "
                        "jax.lax.associative_scan at "
                        "src/repro/models/rglru.py:37-46,74,90",
            "launches": 0, "max_abs_err": 0.0, "ms": mean["kernel"],
            "plain_ms": plain_ms, "bound_ms": s_bound, "bound_by": s_by,
            "library_ms": None, "op_ms": mean["op"],
            "eager_ms": mean["eager"],
            "max_abs_err_of": f"{shape} bf16: bit for bit its plain version"}

    b_, hq, hkv, t, _, d, causal, window = D256_SHAPE
    q, k, v = _qkv(dev, seed, b_, hq, hkv, t, t, d, torch.bfloat16)
    # SDPA as a yardstick, K and V repeated to the query heads beforehand:
    # with the window as an explicit boolean mask (the same function), and
    # causal with no window (the flash path, twice the pairs)
    kr, vr = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
    pos = torch.arange(t, device=dev)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    runs = {"kernel": (lambda: flash_attention_sm90_d256(
                q, k, v, causal=causal, window=window), 20),
            "sdpa_window_mask": (lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask), 5),
            "sdpa_causal": (lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True), 20)}
    ref = runs["sdpa_window_mask"][0]()
    got = runs["kernel"][0]()
    diff = float((got.float() - ref.float()).abs().max())
    runs["sdpa_causal"][0]()              # warm-up: its first call is slow
    t_ms = {n: [] for n in runs}
    for order in (("kernel", "sdpa_window_mask", "sdpa_causal"),
                  ("sdpa_causal", "sdpa_window_mask", "kernel")):
        for n in order:
            t_ms[n].append(cuda_ms(*runs[n]))
    mean = {n: sum(v) / len(v) for n, v in t_ms.items()}
    plain_ms = cuda_ms(lambda: flash_attention_plain(
        q, k, v, causal=causal, window=window), 3)
    k_bound, k_by = k3_bound(b_, hq, hkv, t, d, window=window)
    print(f"[K3/256] {D256_SHAPE} bf16, in turns: flash_attention_sm90_d256 "
          f"{t_ms['kernel']} ms, scaled_dot_product_attention with the "
          f"window as a boolean mask {t_ms['sdpa_window_mask']} ms, causal "
          f"without the window {t_ms['sdpa_causal']} ms (K and V repeated to "
          f"the {hq} query heads first); plain version {plain_ms:.3f} ms; "
          f"bound {k_bound:.4f} ms ({k_by}), {k_bound / mean['kernel']:.1%} "
          f"of it; max abs diff kernel vs SDPA (mask) {diff:.3g} | "
          f"{nvidia_smi_line()}", flush=True)
    check(k_bound <= mean["kernel"], "K3 at head_dim 256 beat its bound")
    del q, k, v, kr, vr, mask, ref, got
    torch.cuda.empty_cache()
    k3 = {"name": "flash_attention_sm90_d256", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/flash_attention_sm90_d256.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
          "launches": 0, "ms": mean["kernel"], "plain_ms": plain_ms,
          "bound_ms": k_bound, "bound_by": k_by,
          "library_ms": mean["sdpa_window_mask"],
          "library_call": "scaled_dot_product_attention with the window as "
                          "a boolean attn_mask, K and V repeated to 10 heads",
          "library_ms_causal_no_window": mean["sdpa_causal"],
          "max_abs_err_of": f"bf16 at {D256_SHAPE}"}
    return scan, k3


@contextlib.contextmanager
def plain_hybrid(layer_err: list, scan_bits: list):
    """``plain_attention`` and, in the RG-LRU layers, S's plain version:
    each layer also runs S on the same u, xi, xr and Λ, and whether its h
    and last h are the plain version's bits is appended to ``scan_bits``."""
    import torch
    from repro_torch.kernels.rglru_scan.ref import rglru_lru_ref
    from repro_torch.models import rglru

    def both(u, xi, xr, lam):
        want = rglru_lru_ref(u, xi, xr, lam)
        got = rglru_lru(u, xi, xr, lam)
        scan_bits.append(bool(torch.equal(got[0], want[0])
                              and torch.equal(got[1], want[1])))
        return want

    rglru_lru = rglru.rglru_lru
    rglru.rglru_lru = both
    try:
        with plain_attention(layer_err):
            yield
    finally:
        rglru.rglru_lru = rglru_lru


def hybrid_phase(dev, seed: int) -> tuple[dict, dict]:
    """Phase 17 (see HYBRID_ARCH). Returns S's and the head_dim 256 K3's
    entries of the kernels line, their launches those of the prefill step."""
    import io

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_mma, flash_attention_sm90,
        flash_attention_sm90_d256)
    from repro_torch.kernels.rglru_scan.ops import rglru_lru
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.steps import make_prefill_step

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    scan, k3 = hybrid_kernels(dev, seed)
    cfg = ARCHS[HYBRID_ARCH]
    n_rec = sum(cfg.mixer_kind(i) == "rglru" for i in range(cfg.n_layers))
    n_attn = cfg.n_layers - n_rec
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[hybrid] {HYBRID_ARCH}: {n_par} parameters ({2 * n_par / 1e9:.2f} "
          f"GB bf16), {cfg.n_layers} layers: {n_rec} RG-LRU (width "
          f"{cfg.lru_width}), {n_attn} local attention ({cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, window {cfg.window}); "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :LM_T]}
    step = make_prefill_step(model)
    step(batch)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (flash_attention, flash_attention_sm90_d256,
                flash_attention_sm90, flash_attention_mma, rglru_lru)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    last = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    print(f"[hybrid] prefill step, 1 x {LM_T} tokens: wall {wall:.4f} s, "
          f"{LM_T / wall:.1f} tokens/s, launches {counts}; peak device "
          f"memory {peak} B = {peak / (2 * n_par):.4f} x the parameter bytes",
          flush=True)
    check(counts == {"flash_attention": n_attn,
                     "flash_attention_sm90_d256": n_attn,
                     "flash_attention_sm90": 0, "flash_attention_mma": 0,
                     "rglru_lru": n_rec},
          f"the prefill step launched {counts}, want {n_attn} of the head_dim "
          f"256 Hopper K3, {n_rec} of S and no other K3 or recurrence")
    check(tuple(last.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(last).all()),
          "prefill-step logits are not finite or of the wrong shape")
    scan["launches"], k3["launches"] = n_rec, n_attn

    scan_bits = []
    agree, ref = lm_agreement(
        model, batch["tokens"],
        plain=lambda errs: plain_hybrid(errs, scan_bits))
    print(f"[hybrid] forward over {LM_T}, K3 and S vs the plain attention "
          f"and RG-LRU (plain run {agree['plain_wall']:.2f} s): K3 per row on "
          f"each swa layer's own q, k, v: max {agree['layers_max']:.4g} "
          f"(limit {ATTN_ROW_TOL['bfloat16']}), per layer "
          f"{[round(e, 5) for e in agree['layer_row_err']]}; S bit for bit "
          f"on each RG-LRU layer's own u, xi, xr: {scan_bits}", flush=True)
    print(f"[hybrid] logits max abs diff over max |logit| per position: max "
          f"{agree['pos_rel_max']:.4g} (limit {LM_REL_TOL_PLAIN}), first "
          f"{LM_EARLY} positions {agree['pos_rel_early']:.4g}, last "
          f"{agree['pos_rel_last']:.4g}; argmax equal at "
          f"{agree['argmax_equal_share']:.4f} of positions, at the last "
          f"{agree['argmax_last_equal']}", flush=True)
    check(agree["ok_layers"], "K3 disagrees with its plain version on an swa "
          "layer's own q, k, v")
    check(len(scan_bits) == n_rec and all(scan_bits),
          "S is not its plain version's bits on an RG-LRU layer's inputs")
    check(agree["ok_logits"], "the full-width forward disagrees with its "
          "plain run")
    err = float((last.float() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[hybrid] prefill-step logits vs the plain forward's last "
          f"position: relative {err / scale:.4g} (limit {LM_REL_TOL_PLAIN}), "
          f"argmax {int(last.argmax())} vs {int(ref.argmax())}", flush=True)
    check(err <= LM_REL_TOL_PLAIN * scale, "the full-width prefill step "
          "disagrees with its plain run")
    del last, ref
    torch.cuda.empty_cache()

    logits_pre, cache = model.prefill(tokens[:, :LM_T],
                                      max_len=LM_T + LM_DECODE)
    last_pre = logits_pre[:, -1].float()
    del logits_pre
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_T, LM_T + LM_DECODE):
        lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
        outs.append(lg[:, 0].float())
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / LM_DECODE
    del cache
    full, _ = model.forward(tokens)
    want = full[0, LM_T - 1:].float()
    del full
    got = torch.cat([last_pre] + outs)
    err = (got - want).abs().amax(dim=-1)
    scale = float(want.abs().max())
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"[hybrid] prefill({LM_T}) + {LM_DECODE} decode steps vs forward "
          f"over {LM_T + LM_DECODE}: max abs diff per position "
          f"{err.tolist()}, max |logit| {scale:.4g}, relative "
          f"{float(err.max()) / scale:.4g} (limit {LM_REL_TOL_DECODE}), "
          f"argmax equal {same}, {dec_ms:.2f} ms per decode step", flush=True)
    check(float(err.max()) <= LM_REL_TOL_DECODE * scale,
          "prefill + decode disagrees with the forward")
    del model, got, want, outs
    torch.cuda.empty_cache()

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        outputs = serve.main(["--arch", HYBRID_ARCH, "--requests", "8",
                              "--batch-slots", "4", "--prompt-len", "16",
                              "--max-new", "16", "--max-len", "256"])
    for line in log.getvalue().splitlines():
        print(f"[hybrid] {line.strip()}", flush=True)
    print(f"[hybrid] serve main() took {time.perf_counter() - t0:.2f} s with "
          "the model's draw", flush=True)
    check(len(outputs) == 8
          and all(len(g) == 16 and all(0 <= x < cfg.vocab_size for x in g)
                  for _, g in outputs),
          "the serve launcher did not answer 8 requests with 16 tokens")
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[hybrid] phase took {total:.1f} s (limit {HYBRID_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= HYBRID_PHASE_S, f"the hybrid phase took {total:.1f} s")
    return scan, k3


# ---------------------------------------------------------------------------
# phase 18: RWKV6 (W, the WKV recurrence) at full width
# ---------------------------------------------------------------------------
def wkv_bound(b, t, h, hd, itemsize) -> tuple[float, str]:
    """Least time for W on (b, t, h, hd): r, k, v (of ``itemsize`` bytes)
    and logw (float32) read once, u read once, y and the last state
    written once (float32); against the recurrence's five float32
    operations an element of the state a step (5·b·h·hd²·t: y_t regrouped
    as r_tᵀS + (r_t·(u ⊙ k_t))·v_t, one multiply-add an element; S ← w ⊙ S
    + k_t v_tᵀ, one multiply and one multiply-add) on the tensor cores,
    where W runs them, as three TF32 products each (split TF32)."""
    n = b * t * h * hd
    return bound_ms(3 * itemsize * n + 4 * n + 4 * n + 4 * h * hd
                    + 4 * b * h * hd * hd, 3 * 5 * b * h * hd * hd * t,
                    PEAK_TF32_OPS_S)


def wkv_cuda_core_ms(b, t, h, hd) -> float:
    """The same 5·b·h·hd²·t float32 operations at the CUDA cores' rate:
    the bound W was held to before its products moved to the tensor cores
    (its earlier step design), printed beside the bound."""
    return 1e3 * 5 * b * h * hd * hd * t / PEAK_F32_OPS_S


def wkv_inputs(dev, g, shape, dtype, shift=0.0):
    """r, k, v N(0, 1) in dtype; logw = -exp(lw), lw spread over the
    channels as rwkv6's decay base (-6 to -0.5) plus ``shift`` plus N(0,
    0.25), so decays run from 0.37 to 0.9975 at shift 0 (at 3, the
    fastest channels decay by e^-12 a step); u N(0, 0.25), float32."""
    import torch
    b, t, h, hd = shape
    r, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for _ in range(3))
    base = shift + torch.linspace(-6.0, -0.5, h * hd, device=dev).view(
        h, hd)
    lw = base + 0.5 * torch.randn(shape, generator=g, device=dev)
    u = 0.5 * torch.randn((h, hd), generator=g, device=dev)
    return r, k, v, -torch.exp(lw), u


def wkv_rel(got, want, head_dims) -> tuple[float, list]:
    """max |got - want| over max |want|, overall and per head (the max
    over ``head_dims`` for each head)."""
    diff, scale = (got - want).abs(), want.abs()
    per_head = (diff.amax(head_dims) / scale.amax(head_dims).clamp_min(1e-30))
    return (float(diff.max()) / max(float(scale.max()), 1e-30),
            per_head.tolist())


def wkv_readings(dev, seed: int) -> dict:
    """W against its plain version at WKV_SHAPES, twice; a gradient
    through it launching W-bwd; W and the plain loop timed in turns at the model's layer
    shape (the last of WKV_SHAPES' order here) beside the bound. Returns
    W's entry of the kernels line, without launches."""
    import torch
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    worst = {"y": 0.0, "state": 0.0, "abs": 0.0}
    for *shape, dt, shift in WKV_SHAPES[::-1]:   # the model's shape last
        dtype = getattr(torch, dt)
        r, k, v, logw, u = wkv_inputs(dev, g, tuple(shape), dtype, shift)
        before = rwkv6_wkv.launches
        (y, st), (y2, st2) = (rwkv6_wkv(r, k, v, logw, u),
                              rwkv6_wkv(r, k, v, logw, u))
        out = {}
        plain_ms = cuda_ms(lambda: out.update(w=wkv_ref(r, k, v, logw, u)),
                           1)
        want_y, want_s = out.pop("w")
        same = bool(torch.equal(y, y2) and torch.equal(st, st2))
        moved = rwkv6_wkv.launches - before
        rel_y, head_y = wkv_rel(y, want_y, (0, 1, 3))
        rel_s, head_s = wkv_rel(st, want_s, (0, 2, 3))
        err = float((y - want_y).abs().max())
        print(f"[W] {tuple(shape)} {dt}, decay shift {shift}: y max abs "
              f"diff {err:.4g} over max "
              f"|y| {float(want_y.abs().max()):.4g}: {rel_y:.4g}, per head "
              f"max {max(head_y):.4g}; last state {rel_s:.4g}, per head max "
              f"{max(head_s):.4g} (limit {WKV_TOL}); the same bits on a "
              f"repeat {same}; launches {moved}; plain loop {plain_ms:.2f} ms",
              flush=True)
        check(moved == 2 and same and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(st).all()),
              f"W is not finite, not one launch a call or not the same bits "
              f"twice at {shape}")
        check(max(rel_y, rel_s, *head_y, *head_s) <= WKV_TOL,
              f"W disagrees with its plain version at {shape}")
        worst = {"y": max(worst["y"], rel_y), "state": max(worst["state"],
                                                           rel_s),
                 "abs": max(worst["abs"], err)}
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_bwd
    before = rwkv6_wkv_bwd.launches
    y_g, _ = rwkv6_wkv(r.float().requires_grad_(True), k.float(), v.float(),
                       logw, u)
    y_g.sum().backward()
    torch.cuda.synchronize()
    moved = rwkv6_wkv_bwd.launches - before
    print(f"[W] an input that requires grad: its gradient launched W-bwd "
          f"{moved} time(s) (phase 24 holds W-bwd)", flush=True)
    check(moved == 1, "a gradient through W did not launch W-bwd once")
    del y_g
    # the layer's shape, in turns: W, plain, W, plain
    t_ms = {"kernel": [], "plain": [plain_ms]}
    for name in ("kernel", "plain", "kernel"):
        if name == "kernel":
            t_ms[name].append(cuda_ms(lambda: rwkv6_wkv(r, k, v, logw, u),
                                      20))
        else:
            t_ms[name].append(cuda_ms(lambda: wkv_ref(r, k, v, logw, u), 1))
    mean = {n: sum(x) / len(x) for n, x in t_ms.items()}
    b, t, h, hd = r.shape
    w_bound, w_by = wkv_bound(b, t, h, hd, r.element_size())
    print(f"[W] {tuple(r.shape)} {r.dtype}, in turns: kernel {t_ms['kernel']} "
          f"ms, plain loop {t_ms['plain']} ms; bound {w_bound:.4f} ms "
          f"({w_by}), {w_bound / mean['kernel']:.1%} of it (the same "
          f"operations on the CUDA cores, the step design's bound: "
          f"{wkv_cuda_core_ms(b, t, h, hd):.4f} ms); no library call "
          f"computes the recurrence | {nvidia_smi_line()}", flush=True)
    wkv_build_report()
    check(w_bound <= mean["kernel"], "W beat its bound: the bound is not a "
          "floor")
    del r, k, v, logw, y, y2, st, st2, want_y, want_s
    torch.cuda.empty_cache()
    return {"name": "rwkv6_wkv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
            "replaces": "port only: stands for the jax.lax.scan at "
                        "src/repro/models/rwkv6.py:97-111,123-137",
            "launches": 0, "max_abs_err": worst["abs"], "ms": mean["kernel"],
            "plain_ms": mean["plain"], "bound_ms": w_bound,
            "bound_by": w_by, "library_ms": None,
            "rel_err_y": worst["y"], "rel_err_state": worst["state"],
            "max_abs_err_of": "y, over WKV_SHAPES; rel_err_*: max |diff| "
                              "over max |plain|"}


def wkv_build_report() -> None:
    """What ptxas said of W's build (registers, shared memory, spills, each
    instantiation), its dynamic shared memory a CTA, and its SASS counted
    (benchmarks_torch.w_sass): tensor-core products and TMA loads in every
    instantiation, bulk copies between CTAs in those of head size 64 (a
    cluster of four), no atomic."""
    import ctypes

    from benchmarks_torch.w_sass import count, disassemble
    from repro_torch.kernels import _build
    log = (_build.build_dir() / "rwkv6_wkv.log").read_text()
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print(f"[W] ptxas: {line.strip()}", flush=True)
    lib = _build.load("rwkv6_wkv")
    lib.rwkv6_wkv_smem_bytes.restype = ctypes.c_int
    print(f"[W] dynamic shared memory a CTA at head size 64: bf16 "
          f"{lib.rwkv6_wkv_smem_bytes(64, 1)} B, float32 "
          f"{lib.rwkv6_wkv_smem_bytes(64, 0)} B; at 16: bf16 "
          f"{lib.rwkv6_wkv_smem_bytes(16, 1)} B, float32 "
          f"{lib.rwkv6_wkv_smem_bytes(16, 0)} B", flush=True)
    sass = count(disassemble())
    for name, by in sass.items():
        print(f"[W] SASS {name}: {by}", flush=True)
    check(all(by["HMMA"] > 0 and by["UTMALDG"] > 0
              and (by["UBLKCP"] > 0 or "Li64E" not in name)
              and by["ATOM"] + by["ATOMS"] + by["RED"] == 0
              for name, by in sass.items()),
          "W's SASS lacks tensor-core products or TMA loads, or at head size "
          "64 the bulk copies between the cluster's CTAs, or holds an atomic")


@contextlib.contextmanager
def plain_rwkv(wkv_err: list):
    """RWKV6's recurrence through W's plain version (the reference run of
    phase 18; the wrapper never does that on the card). Each layer also
    runs W on the same r, k, v, logw and u, and (y, last state) relative
    errors, overall and worst head, are appended to ``wkv_err``."""
    import torch
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref
    from repro_torch.models import rwkv6

    def both(r, k, v, logw, u):
        want = wkv_ref(r, k, v, logw, u)
        got = kernel(r, k, v, logw, u)
        ry, hy = wkv_rel(got[0], want[0], (0, 1, 3))
        rs, hs = wkv_rel(got[1], want[1], (0, 2, 3))
        wkv_err.append(max(ry, rs, *hy, *hs))
        return want

    kernel = rwkv6.rwkv6_wkv
    rwkv6.rwkv6_wkv = both
    try:
        yield
    finally:
        rwkv6.rwkv6_wkv = kernel


def rwkv_decode(model, tokens) -> dict:
    """Prefill LM_T tokens, decode LM_DECODE more, against the forward
    over all of them: each position's max abs difference over the
    forward's max |logit|, the argmax per position, ms a decode step and
    the decode state's bytes."""
    import torch
    logits_pre, cache = model.prefill(tokens[:, :LM_T],
                                      max_len=LM_T + LM_DECODE)
    outs = [logits_pre[:, -1].float()]
    del logits_pre
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_T, LM_T + LM_DECODE):
        lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
        outs.append(lg[:, 0].float())
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / LM_DECODE
    state = sum(x.numel() * x.element_size() for lc in cache
                for x in (lc["cmix_shift"], *lc["rec"].values()))
    del cache
    full, _ = model.forward(tokens)
    want = full[0, LM_T - 1:].float()
    del full
    got = torch.cat(outs)
    err = (got - want).abs().amax(dim=-1)
    scale = float(want.abs().max())
    return {"err": err.tolist(), "scale": scale,
            "rel": float(err.max()) / scale,
            "argmax_equal": (got.argmax(-1) == want.argmax(-1)).tolist(),
            "ms": dec_ms, "state_bytes": state}


def rwkv6_phase(dev, seed: int) -> dict:
    """Phase 18 (see RWKV_ARCH). Returns W's entry of the kernels line,
    its launches those of the prefill step."""
    import dataclasses
    import io

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_mma, flash_attention_sm90,
        flash_attention_sm90_d256)
    from repro_torch.kernels.rglru_scan.ops import rglru_lru
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.train.steps import make_prefill_step

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wkv = wkv_readings(dev, seed)
    cfg = ARCHS[RWKV_ARCH]
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[rwkv6] {RWKV_ARCH}: {n_par} parameters (config n_params "
          f"{cfg.n_params()}; {2 * n_par / 1e9:.2f} GB bf16), "
          f"{cfg.n_layers} layers of the time mix ({cfg.rwkv_heads} heads of "
          f"{cfg.rwkv_head_dim}) and the channel mix (d_ff {cfg.d_ff}), vocab "
          f"{cfg.vocab_size}; drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :LM_T]}
    step = make_prefill_step(model)
    step(batch)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (flash_attention, flash_attention_sm90_d256,
                flash_attention_sm90, flash_attention_mma, rglru_lru,
                rwkv6_wkv)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    last = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    print(f"[rwkv6] prefill step, 1 x {LM_T} tokens: wall {wall:.4f} s, "
          f"{LM_T / wall:.1f} tokens/s, launches {counts}; peak device "
          f"memory {peak} B = {peak / (2 * n_par):.4f} x the parameter bytes",
          flush=True)
    check(counts == {**{w.__name__: 0 for w in wrappers},
                     "rwkv6_wkv": cfg.n_layers},
          f"the prefill step launched {counts}, want {cfg.n_layers} of W and "
          "no other kernel")
    check(tuple(last.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(last).all()),
          "prefill-step logits are not finite or of the wrong shape")
    wkv["launches"] = cfg.n_layers
    del last

    # bf16: W held on every layer's own inputs; the logits read (a
    # random-weight RWKV6 is chaotic in bf16: see RWKV_ARCH)
    wkv_err = []
    agree, _ = lm_agreement(model, batch["tokens"],
                            plain=lambda errs: plain_rwkv(wkv_err))
    print(f"[rwkv6] bf16 forward over {LM_T}, W vs its plain version (plain "
          f"run {agree['plain_wall']:.2f} s): on each layer's own r, k, v, "
          f"logw, the worst of y's and the last state's relative error, "
          f"overall and per head: max {max(wkv_err, default=0.0):.4g} "
          f"(limit {WKV_TOL}), per layer "
          f"{[float(f'{e:.3g}') for e in wkv_err]}", flush=True)
    print(f"[rwkv6] bf16 logits max abs diff over max |logit| per position, "
          f"W vs its plain version (a reading): max {agree['pos_rel_max']:.4g}"
          f", first {LM_EARLY} positions {agree['pos_rel_early']:.4g}, last "
          f"{agree['pos_rel_last']:.4g}, argmax equal at "
          f"{agree['argmax_equal_share']:.4f} of positions, at the last "
          f"{agree['argmax_last_equal']}", flush=True)
    check(len(wkv_err) == cfg.n_layers and max(wkv_err) <= WKV_TOL,
          "W disagrees with its plain version on a layer's own inputs (bf16)")
    check(math.isfinite(agree["pos_rel_max"]),
          "the bf16 forward gave logits that are not finite")
    dec = rwkv_decode(model, tokens)
    print(f"[rwkv6] bf16 prefill({LM_T}) + {LM_DECODE} decode steps vs "
          f"forward over {LM_T + LM_DECODE} (a reading): relative "
          f"{dec['rel']:.4g} per "
          f"position {[round(e / dec['scale'], 5) for e in dec['err']]}, "
          f"argmax equal {dec['argmax_equal']}, {dec['ms']:.2f} ms per "
          f"decode step; decode state {dec['state_bytes']} B", flush=True)
    check(all(math.isfinite(e) for e in dec["err"]),
          "bf16 prefill + decode gave logits that are not finite")
    del model, step
    torch.cuda.empty_cache()

    # float32 at full width: the logits held at every position, and the
    # decode seam
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg32, device=dev).init(seed)
    wkv_err32 = []
    agree, ref = lm_agreement(model, batch["tokens"],
                              plain=lambda errs: plain_rwkv(wkv_err32))
    last = make_prefill_step(model)(batch)
    err = float((last.float() - ref).abs().max()) / float(ref.abs().max())
    print(f"[rwkv6] float32 forward over {LM_T}, W vs its plain version "
          f"(plain run {agree['plain_wall']:.2f} s): W per layer max "
          f"{max(wkv_err32, default=0.0):.4g} (limit {WKV_TOL}); logits max "
          f"abs diff over max |logit| per position: max "
          f"{agree['pos_rel_max']:.4g} (limit {LM_REL_TOL_PLAIN}), first "
          f"{LM_EARLY} positions {agree['pos_rel_early']:.4g}, last "
          f"{agree['pos_rel_last']:.4g}; argmax equal at "
          f"{agree['argmax_equal_share']:.4f} of positions, at the last "
          f"{agree['argmax_last_equal']}; the prefill step's logits vs the "
          f"plain run's last position {err:.4g}", flush=True)
    check(len(wkv_err32) == cfg.n_layers and max(wkv_err32) <= WKV_TOL,
          "W disagrees with its plain version on a layer's own inputs "
          "(float32)")
    check(agree["ok_layers"] and agree["ok_logits"]
          and err <= LM_REL_TOL_PLAIN,
          "the full-width float32 forward disagrees with its plain run")
    del last, ref
    dec = rwkv_decode(model, tokens)
    print(f"[rwkv6] float32 prefill({LM_T}) + {LM_DECODE} decode steps vs "
          f"forward over {LM_T + LM_DECODE}: relative {dec['rel']:.4g} "
          f"(limit {RWKV_DECODE_TOL}), max abs diff per position "
          f"{dec['err']}, max |logit| {dec['scale']:.4g}, argmax equal "
          f"{dec['argmax_equal']}, {dec['ms']:.2f} ms per decode step",
          flush=True)
    check(dec["rel"] <= RWKV_DECODE_TOL,
          "float32 prefill + decode disagrees with the forward")
    del model
    torch.cuda.empty_cache()

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        outputs = serve.main(["--arch", RWKV_ARCH, "--requests", "8",
                              "--batch-slots", "4", "--prompt-len", "16",
                              "--max-new", "16", "--max-len", "256"])
    for line in log.getvalue().splitlines():
        print(f"[rwkv6] {line.strip()}", flush=True)
    print(f"[rwkv6] serve main() took {time.perf_counter() - t0:.2f} s with "
          "the model's draw", flush=True)
    check(len(outputs) == 8
          and all(len(g) == 16 and all(0 <= x < cfg.vocab_size for x in g)
                  for _, g in outputs),
          "the serve launcher did not answer 8 requests with 16 tokens")
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[rwkv6] phase took {total:.1f} s (limit {RWKV_PHASE_S} s) | "
          f"{nvidia_smi_line()}", flush=True)
    check(total <= RWKV_PHASE_S, f"the RWKV6 phase took {total:.1f} s")
    return wkv


# ---------------------------------------------------------------------------
# phase 19: Nelder-Mead, the paper's baseline
# ---------------------------------------------------------------------------
def nm_graph_turns(dev) -> tuple[list, list]:
    """Nelder-Mead at NM_N for NM_TURN_IT iterations with each chunk
    replayed as a CUDA graph and, with GRAPH_MAX_BYTES set to 0, run
    eagerly, in turns (graph, eager, eager, graph): ms an iteration of
    each, wall over iterations; checks that both give the same bits."""
    import importlib

    import torch
    from repro_torch.objectives import griewank_naive
    from repro_torch.optim import nelder_mead
    mod = importlib.import_module("repro_torch.optim.nelder_mead")
    x0 = torch.full((NM_N,), NM_X0, device=dev)
    ms, out = {"graph": [], "eager": []}, {}
    saved = mod.GRAPH_MAX_BYTES
    for how in ("graph", "eager", "eager", "graph"):
        mod.GRAPH_MAX_BYTES = saved if how == "graph" else 0
        try:
            t0 = time.perf_counter()
            r = nelder_mead(griewank_naive, x0,
                            max_fe=NM_N + 1 + 2 * NM_TURN_IT)
            ms[how].append(1e3 * (time.perf_counter() - t0) / r.iterations)
        finally:
            mod.GRAPH_MAX_BYTES = saved
        out[how] = r
    check(torch.equal(out["graph"].x, out["eager"].x)
          and out["graph"].fe == out["eager"].fe,
          "Nelder-Mead's graph replay differs from its eager chunks")
    return ms["graph"], ms["eager"]


def nm_phase(dev, seed: int) -> dict:
    """Phase 19 (see NM_SPHERE): Nelder-Mead on the card. Returns the
    readings of its run at NM_READ_N."""
    import torch
    from repro_torch.core import abo_minimize
    from repro_torch.objectives import GRIEWANK, griewank_naive
    from repro_torch.optim import nelder_mead, simplex_bytes

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    n, x0, max_fe = NM_SPHERE
    t0 = time.perf_counter()
    r = nelder_mead(lambda x: torch.sum(x * x),
                    torch.full((n,), x0, device=dev), max_fe=max_fe)
    print(f"[nm] sphere n={n} from {x0}: fun {r.fun!r} (limit 1e-6), fe "
          f"{r.fe}, {r.iterations} iterations, converged {r.converged}, "
          f"{time.perf_counter() - t0:.2f} s | {smi}", flush=True)
    check(r.fun < 1e-6 and r.x.device.type == dev.type,
          f"Nelder-Mead on the sphere ended at {r.fun}")

    abo = abo_minimize(GRIEWANK, NM_N, device=dev)
    stats: dict = {}
    t0 = time.perf_counter()
    nm = nelder_mead(griewank_naive, torch.full((NM_N,), NM_X0, device=dev),
                     max_fe=abo.fe, stats=stats)
    wall = time.perf_counter() - t0
    print(f"[nm] Griewank n={NM_N} from {NM_X0} at Nelder-Mead's max_fe = "
          f"ABO's fe {abo.fe}: ABO fun {abo.fun!r}, Nelder-Mead fun "
          f"{nm.fun!r} (fe {nm.fe}, {nm.iterations} iterations, "
          f"{stats['host_reads']} host reads, {wall:.2f} s, "
          f"{1e3 * wall / max(nm.iterations, 1):.4f} ms an iteration) | "
          f"{smi}", flush=True)
    check(abo.fun < nm.fun and abo.fe <= nm.fe + 1,
          f"ABO ({abo.fun}, fe {abo.fe}) does not beat Nelder-Mead "
          f"({nm.fun}, fe {nm.fe}) at equal evaluations")
    graph, eager = nm_graph_turns(dev)
    print(f"[nm] n={NM_N}, {NM_TURN_IT} iterations, in turns: chunks of 64 "
          f"replayed as one CUDA graph each {graph} ms an iteration "
          f"(capture included), the same chunks eagerly {eager} ms, the same "
          f"bits | {smi}", flush=True)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        nelder_mead(griewank_naive, torch.zeros(NM_CRASH_N, device=dev),
                    memory_budget_bytes=NM_BUDGET)
        crashed = None
    except MemoryError as e:
        crashed = str(e)
    print(f"[nm] n={NM_CRASH_N} under a {NM_BUDGET} B budget: MemoryError "
          f"{crashed!r}; device memory allocated {before} B before, "
          f"{torch.cuda.memory_allocated()} B after", flush=True)
    check(crashed is not None and torch.cuda.memory_allocated() == before,
          f"Nelder-Mead at n={NM_CRASH_N} did not refuse before allocating")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x0 = torch.full((NM_READ_N,), NM_X0, device=dev)
    base = torch.cuda.memory_allocated()
    stats = {}
    t0 = time.perf_counter()
    big = nelder_mead(griewank_naive, x0, max_fe=NM_READ_FE, stats=stats)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    need = simplex_bytes(NM_READ_N)
    read = {"n": NM_READ_N, "max_fe": NM_READ_FE, "fun": big.fun,
            "fe": big.fe, "iterations": big.iterations,
            "host_reads": stats["host_reads"], "wall_s": wall,
            "ms_per_iteration": 1e3 * wall / max(big.iterations, 1),
            "peak_bytes": peak, "simplex_bytes": need}
    print(f"[nm] read, not held: Griewank n={NM_READ_N} from {NM_X0}, "
          f"max_fe {NM_READ_FE}: fun {big.fun!r}, fe {big.fe}, "
          f"{big.iterations} iterations, {stats['host_reads']} host reads "
          f"(one a chunk of 64 and the result's), wall {wall:.2f} s "
          f"({read['ms_per_iteration']:.4f} ms an iteration); peak device "
          f"memory {peak} B = {peak / need:.3f} x simplex_bytes {need} | "
          f"{smi}", flush=True)
    check(math.isfinite(big.fun) and big.iterations > 0,
          "the Nelder-Mead run at n = 1e4 did not run")
    del x0, big
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[nm] phase took {total:.1f} s (limit {NM_PHASE_S} s) | {smi}",
          flush=True)
    check(total <= NM_PHASE_S, f"the Nelder-Mead phase took {total:.1f} s")
    return read


# ---------------------------------------------------------------------------
# phase 20: the port's examples
# ---------------------------------------------------------------------------
# Run in each [examples] child: refuses JAX, the JAX package and its
# benchmarks at import, then runs the example script named by the second
# argument as __main__ with the rest of the arguments (the first is the
# port's source directory).
EXAMPLE_CHILD = r"""
import runpy
import sys
FOREIGN = ("jax", "jaxlib", "repro", "benchmarks")


class NoForeign:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ImportError(f"a chip_smoke child imported {name}")
        return None


sys.meta_path.insert(0, NoForeign())
sys.path.insert(0, sys.argv[1])
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
if foreign:
    raise SystemExit(f"a chip_smoke child imported {foreign[:5]}")
"""


def _printed(out: str, prefix: str) -> str:
    """The rest of the first line of ``out`` that starts with ``prefix``."""
    for line in out.splitlines():
        if line.startswith(prefix):
            return line[len(prefix):]
    fail(f"no line starting {prefix!r} in:\n{out[-2000:]}")


def examples_phase() -> dict:
    """Phase 20 (see EXAMPLE_WATERSHED_N): each examples_torch/ script in a
    child process on the card, all at once. Returns each one's wall and
    what it printed that the phase holds."""
    import shutil
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "examples_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    runs = {"quickstart": [],
            "calibrate_watershed": ["--n", str(EXAMPLE_WATERSHED_N)],
            "solve_service": [],
            "serve_decode": [],
            "train_lm_abo": ["--steps", str(EXAMPLE_TRAIN_STEPS),
                             "--ckpt-dir", os.path.join(root, "train")]}
    procs, logs = {}, {}
    try:
        for name, argv in runs.items():
            logs[name] = open(os.path.join(root, f"{name}.log"), "w+")
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_CHILD,
                 os.path.join(ROOT, "src"),
                 os.path.join(ROOT, "examples_torch", f"{name}.py"), *argv],
                stdout=logs[name], stderr=subprocess.STDOUT, text=True))
        walls, outs = {}, {}
        for name, (t0, proc) in procs.items():
            left = EXAMPLES_PHASE_S - (time.perf_counter() - t_phase)
            try:
                rc = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            walls[name] = time.perf_counter() - t0
            logs[name].seek(0)
            outs[name] = logs[name].read()
            print(f"[examples] {name} {' '.join(runs[name])}: exit {rc} "
                  f"after {walls[name]:.1f} s (beside the other four)",
                  flush=True)
            for line in outs[name].splitlines():
                print(f"[examples]   {line}", flush=True)
            check(rc == 0, f"[examples] {name} exited {rc}:\n"
                  f"{outs[name][-3000:]}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for log in logs.values():
            log.close()
    quick = float(_printed(outs["quickstart"], "  best objective : ")
                  .split()[0])
    water = float(_printed(outs["calibrate_watershed"], "  J(k) residual  : "))
    limit = EXAMPLE_WATERSHED_JAX * 1.001
    steps = [line for line in outs["solve_service"].splitlines()
             if line.startswith("  step ")]
    adamw = float(_printed(outs["train_lm_abo"], "AdamW : loss ").split()[0])
    zo = float(_printed(outs["train_lm_abo"], "ABO-ZO: loss ").split()[0])
    held = {"quickstart_fun": quick, "watershed_residual": water,
            "solve_service_last_step": steps[-1] if steps else None,
            "serve": _printed(outs["serve_decode"], "[serve] "),
            "train_losses": (adamw, zo), "walls": walls}
    print(f"[examples] quickstart fun {quick!r} (limit 1e-6); watershed "
          f"residual {water!r} as printed (limit {limit!r}: the JAX "
          f"package's {EXAMPLE_WATERSHED_JAX!r} x 1.001); solve_service "
          f"{held['solve_service_last_step']!r}; serve_decode "
          f"{held['serve']!r}; train_lm_abo losses AdamW {adamw!r}, ABO-ZO "
          f"{zo!r} | {smi}", flush=True)
    check(quick < 1e-6, f"[examples] quickstart ended at {quick}")
    check(water <= limit, f"[examples] the watershed residual {water} is "
          f"above {limit}")
    check(bool(steps) and "done=12" in steps[-1],
          "[examples] solve_service did not drain its 12 jobs")
    check(held["serve"].startswith("12/12 requests"),
          "[examples] serve_decode did not answer its 12 requests")
    check(math.isfinite(adamw) and math.isfinite(zo),
          "[examples] train_lm_abo's losses are not finite")
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t_phase
    print(f"[examples] phase took {total:.1f} s (limit {EXAMPLES_PHASE_S} "
          f"s) | {smi}", flush=True)
    check(total <= EXAMPLES_PHASE_S, f"the examples phase took {total:.1f} s")
    return held


# ---------------------------------------------------------------------------
# phase 21: whisper-small, the encoder-decoder
# ---------------------------------------------------------------------------
def k3_bound_cross(b, hq, hkv, sq, sk, d, peak=PEAK_BF16_OPS_S,
                   itemsize=2) -> tuple[float, str]:
    """Least time for non-causal attention of sq queries over sk keys: Q,
    K, V and O moved once; 4·d FLOP a (query, key) pair."""
    return bound_ms(itemsize * (2 * b * hq * sq * d + 2 * b * hkv * sk * d),
                    4 * b * hq * d * sq * sk, peak)


@contextlib.contextmanager
def plain_attention_read(layers: list):
    """As ``plain_attention``, appending each call's (kind, overall, per
    row) to ``layers``: kind "encoder" (non-causal, sq = sk), "cross"
    (non-causal, sq != sk) or "self" (causal); overall the max |K3 -
    plain| over the max |plain|, per row ``row_rel_err``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import attention

    def both(q, k, v, *, causal=True, window=None):
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            got = flash_attention(q, k, v, causal=causal, window=window)
            kind = ("self" if causal else
                    "encoder" if q.shape[2] == k.shape[2] else "cross")
            layers.append((kind, float((got.float() - want.float()).abs()
                                       .max() / want.float().abs().max()),
                           row_rel_err(got, want)))
        return want

    saved = attention.flash_attention
    attention.flash_attention = both
    try:
        yield
    finally:
        attention.flash_attention = saved


@contextlib.contextmanager
def mma_attention():
    """The model's attention op on ``flash_attention_mma``, the kernel that
    took whisper's bf16 head_dim 64 calls before the Hopper d = 64 one."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_mma
    from repro_torch.models import attention

    def mma(q, k, v, *, causal=True, window=None):
        return flash_attention_mma(q, k, v, causal=causal, window=window)

    saved = attention.flash_attention
    attention.flash_attention = mma
    try:
        yield
    finally:
        attention.flash_attention = saved


def busy_ms(fn) -> tuple[float, float]:
    """One call of ``fn`` under ``torch.profiler``: (its wall to a
    synchronize, the summed device time of the kernels it ran), in ms. Its
    kernels run on one stream and do not overlap, so the sum is the time
    the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return 1e3 * wall, busy / 1e3


def whisper_forward_turns(step, batch, rounds: int = 4) -> dict:
    """The prefill step in turns on the op's route (the d = 64 kernel) and
    on the mma.sync kernel (``mma_attention``), d64 first in even rounds
    and mma first in odd ones: per route the wall of each step to its
    synchronize, and the first round's step once more under the profiler
    (``busy_ms``): its kernels' device time and its wall there."""
    import torch
    out = {n: {"wall_s": []} for n in ("d64", "mma")}
    for rnd in range(rounds):
        for n in (("d64", "mma") if rnd % 2 == 0 else ("mma", "d64")):
            with (mma_attention() if n == "mma"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                out[n]["wall_s"].append(time.perf_counter() - t0)
                if rnd == 0:
                    wall, busy = busy_ms(lambda: step(batch))
                    out[n].update(traced_wall_ms=wall, busy_ms=busy)
    for r in out.values():
        r["wall_s_mean"] = sum(r["wall_s"]) / len(r["wall_s"])
    return out


def whisper_k3_times(dev, seed: int, cfg) -> dict:
    """K3 at whisper's three shapes, bf16 (B, 12/12, head_dim 64): the
    encoder's 1500 x 1500 and the cross-attention's 448 x 1500,
    non-causal, and the decoder's causal 448 x 448. The Hopper d = 64
    kernel (the op's route) and the mma.sync kernel (called directly) are
    each held to the plain version on float64 copies of the inputs, and
    the d = 64 kernel gives the same bits twice; then both and SDPA are
    timed in turns (d64, mma, SDPA, SDPA, mma, d64), on the device alone
    (``queued``, the host queueing every call while the device sleeps)
    with the host's time to queue a call and the events' reading of
    back-to-back calls beside it, and against the plain version and two
    bounds: the products at 989 TFLOP/s (or the
    bytes; ``k3_bound_cross``) and the exponentials at the MUFU's 16 a
    clock an SM at the card's top SM clock. Returns {"d64": readings,
    "mma": readings}, each {shape: ...} with whether the kernel is held
    (``ok``) and, for the d = 64 kernel, the kernel the op chose and
    whether it beat the mma.sync one; ``whisper_k3_checks`` checks them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    out = {"d64": {}, "mma": {}}
    h, d, te = cfg.n_heads, cfg.head_dim, cfg.encoder_len
    clock = sm_clock_max_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, sq, sk, causal in (("encoder", te, te, False),
                                 ("cross", WHISPER_T, te, False),
                                 ("self", WHISPER_T, WHISPER_T, True)):
        q, k, v = _qkv(dev, seed, WHISPER_B, h, h, sq, sk, d, torch.bfloat16)
        kernel = fa.choose_kernel(q, k, v)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        # the bf16 plain version rounds its scores to bf16, which moves a
        # long row's small outputs by ~0.019 of their max: the kernels
        # (float32 scores) are held to the plain version on float64 copies
        # of the inputs, and to be no further from it than that is
        exact = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                         causal=causal)
        row_plain = row_rel_err(want, exact)
        runs = {"d64": lambda: fa.flash_attention(q, k, v, causal=causal),
                "mma": lambda: fa.flash_attention_mma(q, k, v,
                                                      causal=causal),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)}
        held = {}
        for n in ("d64", "mma"):
            poison_next_output(q)
            got = runs[n]()
            poison_next_output(q)
            again = runs[n]()
            torch.cuda.synchronize()
            held[n] = {
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "row_rel_err_f64_inputs": row_rel_err(got, exact),
                "row_rel_err_bf16_plain": row_rel_err(got, want),
                "repeat": bool(torch.equal(got.view(torch.int16),
                                           again.view(torch.int16)))}
            del got, again
        del exact
        ms = {n: [] for n in runs}
        host = {n: [] for n in runs}
        events = {n: [] for n in runs}
        for n in ("d64", "mma", "sdpa", "sdpa", "mma", "d64"):
            dev_ms, host_ms = queued(runs[n], 20)
            ms[n].append(dev_ms)
            host[n].append(host_ms)
            events[n].append(cuda_ms(runs[n], 20))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), 3)
        if causal:
            bound, by = k3_bound(WHISPER_B, h, h, sq, d, causal=True)
            pairs = WHISPER_B * h * sq * (sq + 1) / 2
        else:
            bound, by = k3_bound_cross(WHISPER_B, h, h, sq, sk, d)
            pairs = WHISPER_B * h * sq * sk
        bound_exp = 1e3 * pairs / (PIPE_RATE["mufu"] * sms * clock)
        mean = {n: sum(x) / len(x) for n, x in ms.items()}
        shape = (f"bf16 ({WHISPER_B}, {h}/{h}, {sq} x {sk}, {d}) "
                 f"{'causal' if causal else 'non-causal'}")
        for n in ("d64", "mma"):
            r = held[n]
            print(f"[whisper] K3 at the {what}'s {shape}, "
                  f"{kernel if n == 'd64' else 'flash_attention_mma (direct)'}"
                  f": max abs err {r['max_abs_err']:.3g} (limit "
                  f"{ATTN_TOL['bfloat16']}), per row "
                  f"{r['row_rel_err_f64_inputs']:.3g} against the plain "
                  f"version on float64 inputs (limit "
                  f"{ATTN_ROW_TOL['bfloat16']}; the bf16 plain version's own "
                  f"{row_plain:.3g}), {r['row_rel_err_bf16_plain']:.3g} "
                  f"against the bf16 plain version (read); the same bits on "
                  f"a repeat {r['repeat']}", flush=True)
            r["ok"] = (r["max_abs_err"] < ATTN_TOL["bfloat16"]
                       and r["row_rel_err_f64_inputs"]
                       < ATTN_ROW_TOL["bfloat16"]
                       and r["row_rel_err_f64_inputs"] <= row_plain
                       and r["repeat"])
        print(f"[whisper] K3 at the {what}'s {shape}, in turns on the device "
              f"alone: flash_attention_sm90_d64 {ms['d64']} ms, "
              f"flash_attention_mma {ms['mma']} ms, SDPA {ms['sdpa']} ms "
              f"(back to back, events: d64 {events['d64']}, mma "
              f"{events['mma']}, SDPA {events['sdpa']}; the host's time "
              f"to queue a call: d64 {host['d64']}, mma {host['mma']}, "
              f"SDPA {host['sdpa']} ms); d64 is "
              f"{mean['mma'] / mean['d64']:.3f}x faster than mma and "
              f"{mean['d64'] / mean['sdpa']:.3f}x SDPA's time; plain "
              f"{plain_ms:.3f} ms; bound {bound:.5f} ms ({by}), "
              f"{bound / mean['d64']:.1%} of it; the exponentials alone "
              f"{bound_exp:.5f} ms ({sms} SMs at {clock / 1e9:.3f} GHz) | "
              f"{nvidia_smi_line()}", flush=True)
        held["d64"]["kernel"] = kernel
        held["d64"]["faster_than_mma"] = mean["d64"] < mean["mma"]
        for n in ("d64", "mma"):
            out[n][what] = {"shape": shape, **held[n], "ms": mean[n],
                            "turns": ms[n], "events_ms": events[n],
                            "host_ms": host[n],
                            "library_ms": mean["sdpa"], "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by,
                            "bound_exp_ms": bound_exp}
        del q, k, v, want, runs
    torch.cuda.empty_cache()
    return out


def whisper_k3_checks(times: dict) -> list[str]:
    """What ``whisper_k3_times``' readings fail: each kernel held at each
    shape, the op's route the d = 64 kernel, and the d = 64 kernel faster
    than the mma.sync one at the encoder and cross shapes."""
    failed = []
    for what, r in times["d64"].items():
        if r["kernel"] != "flash_attention_sm90_d64":
            failed.append(f"K3 at whisper's {what} shape went to "
                          f"{r['kernel']}")
        if what != "self" and not r["faster_than_mma"]:
            failed.append(f"flash_attention_sm90_d64 ({r['ms']:.4f} ms) is "
                          f"not faster than flash_attention_mma "
                          f"({times['mma'][what]['ms']:.4f} ms) at whisper's "
                          f"{what} shape")
    for n, kinds in times.items():
        failed += [f"K3 ({n}) at whisper's {what} shape disagrees with its "
                   "plain version or with itself on a repeat"
                   for what, r in kinds.items() if not r["ok"]]
    return failed


def whisper_agreement(model, tokens, frames) -> dict:
    """K3 on every layer's own q, k, v and the logits at every position,
    against the same forward with the plain attention: the readings and
    whether each is within its limit (``ok_layers``, ``ok_logits``). The
    forward's and the plain run's logits come back too (``full``,
    ``ref``)."""
    import torch
    cfg = model.cfg
    full, _ = model.forward(tokens, frames=frames)
    layers: list = []
    t0 = time.perf_counter()
    with plain_attention_read(layers):
        ref, _ = model.forward(tokens, frames=frames)
    torch.cuda.synchronize()
    kinds = {k: [(a, r) for kk, a, r in layers if kk == k]
             for k in ("encoder", "self", "cross")}
    pos_rel = ((full.float() - ref.float()).abs().amax(-1)
               / ref.float().abs().amax(-1))                      # (b, t)
    same_last = (full[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).tolist()
    abs_max = max(a for _, a, _ in layers)
    row_max = max(r for _, _, r in layers)
    return {
        "full": full, "ref": ref, "kinds": kinds,
        "plain_wall_s": time.perf_counter() - t0,
        "layers_overall_max": abs_max, "layers_max": row_max,
        "pos_rel": pos_rel, "pos_rel_max": float(pos_rel.max()),
        "argmax_equal_share": float((full.argmax(-1) == ref.argmax(-1))
                                    .double().mean()),
        "argmax_last_equal": same_last,
        "ok_layers": ([len(kinds[k]) for k in kinds]
                      == [cfg.encoder_layers, cfg.n_layers, cfg.n_layers]
                      and abs_max < ATTN_TOL["bfloat16"]
                      and row_max < ATTN_ROW_TOL["bfloat16"]),
        "ok_logits": (float(pos_rel.max()) <= LM_REL_TOL_PLAIN
                      and same_last[0])}


def whisper_phase(dev, seed: int) -> tuple[dict, dict]:
    """Phase 21 (see WHISPER_ARCH). Returns the head_dim 64 kernel's
    whisper readings for its entry of the kernels line, its launches those
    of the prefill step, and the mma.sync kernel's (0 launches there)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_mma, flash_attention_sm90,
        flash_attention_sm90_d64, flash_attention_sm90_d256)
    from repro_torch.models.model import Model
    from repro_torch.train.steps import make_prefill_step

    smi = nvidia_smi_line()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = ARCHS[WHISPER_ARCH]
    times = whisper_k3_times(dev, seed, cfg)
    failed = whisper_k3_checks(times)
    check(not failed, "; ".join(failed))
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[whisper] {WHISPER_ARCH}: {n_par} parameters (config n_params "
          f"{cfg.n_params()}; {par_bytes / 1e9:.3f} GB bf16), "
          f"{cfg.encoder_layers} encoder and {cfg.n_layers} decoder layers, "
          f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_T),
                           generator=gen, device=dev)
    frames = torch.randn((WHISPER_B, cfg.encoder_len, cfg.d_model),
                         generator=gen, device=dev).to(cfg.param_dtype)
    batch = {"tokens": tokens, "frames": frames}
    step = make_prefill_step(model)
    step(batch)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_mma.launches = 0
    flash_attention_sm90.launches = flash_attention_sm90_d256.launches = 0
    flash_attention_sm90_d64.launches = 0
    t0 = time.perf_counter()
    last = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_sm90_d64.launches
    others = (flash_attention_sm90.launches + flash_attention_sm90_d256.launches
              + flash_attention_mma.launches)
    peak = torch.cuda.max_memory_allocated()
    want_k3 = cfg.encoder_layers + 2 * cfg.n_layers
    print(f"[whisper] forward (the prefill step), {WHISPER_B} x {WHISPER_T} "
          f"tokens over {WHISPER_B} x {cfg.encoder_len} frames: wall "
          f"{wall:.4f} s, {WHISPER_B * WHISPER_T / wall:.1f} decoder tokens/s "
          f"({WHISPER_B * cfg.encoder_len / wall:.1f} frames/s); K3 launches: "
          f"flash_attention_sm90_d64 {launches} (want {want_k3}), the other "
          f"K3 kernels {others}; peak device memory {peak} B = "
          f"{peak / par_bytes:.4f} x the parameter bytes | {smi}", flush=True)
    check(launches == want_k3 and others == 0
          and flash_attention.launches == want_k3,
          f"the whisper forward launched flash_attention_sm90_d64 {launches} "
          f"times and the other K3 kernels {others}, want {want_k3} and 0")
    check(tuple(last.shape) == (WHISPER_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()),
          "whisper's logits are not finite or of the wrong shape")
    turns = whisper_forward_turns(step, batch)
    label = {"d64": "flash_attention_sm90_d64 (the op's route)",
             "mma": "flash_attention_mma (through the op)"}
    for n, r in turns.items():
        print(f"[whisper] forward in turns on {label[n]}: wall "
              f"{[round(x, 5) for x in r['wall_s']]} s (mean "
              f"{r['wall_s_mean']:.5f}); traced once: kernels "
              f"{r['busy_ms']:.3f} ms of {r['traced_wall_ms']:.3f} ms "
              f"(busy {r['busy_ms'] / r['traced_wall_ms']:.1%}) | {smi}",
              flush=True)
    ratio = {key: turns["d64"][key] / turns["mma"][key]
             for key in ("wall_s_mean", "busy_ms")}
    print(f"[whisper] forward, d64's time over mma's: wall "
          f"{ratio['wall_s_mean']:.4f}, kernels {ratio['busy_ms']:.4f}",
          flush=True)

    # K3 on every layer's own q, k, v, and the logits at every position,
    # against the same forward with the plain attention
    agree = whisper_agreement(model, tokens, frames)
    full, ref, kinds = agree["full"], agree["ref"], agree["kinds"]
    plain_wall, pos_rel = agree["plain_wall_s"], agree["pos_rel"]
    scale = ref.float().abs().amax(-1)
    same_last, same = agree["argmax_last_equal"], agree["argmax_equal_share"]
    abs_max, row_max = agree["layers_overall_max"], agree["layers_max"]
    for k, v in kinds.items():
        print(f"[whisper] K3 vs plain on each {k} layer's own q, k, v "
              f"({len(v)} layers): overall (max abs diff over max |plain|) "
              f"{max(a for a, _ in v):.4g}, per row "
              f"{max(r for _, r in v):.4g} (limits "
              f"{ATTN_TOL['bfloat16']}, {ATTN_ROW_TOL['bfloat16']}); per "
              f"layer {[round(r, 5) for _, r in v]}", flush=True)
    print(f"[whisper] logits max abs diff over max |logit| per position "
          f"(plain run {plain_wall:.2f} s): max {float(pos_rel.max()):.4g} "
          f"(limit {LM_REL_TOL_PLAIN}), last position per row "
          f"{[round(float(x), 5) for x in pos_rel[:, -1]]}; argmax equal at "
          f"{same:.4f} of positions, at the last {same_last}", flush=True)
    check(agree["ok_layers"],
          "K3 disagrees with its plain version on whisper's own q, k, v")
    check(agree["ok_logits"],
          "whisper's forward disagrees with its plain-attention run")
    err = float((last.float() - ref[:, -1].float()).abs().max())
    print(f"[whisper] prefill-step logits vs the plain forward's last "
          f"position: max abs diff {err:.4g}, relative "
          f"{err / float(scale[:, -1].max()):.4g}", flush=True)
    check(err <= LM_REL_TOL_PLAIN * float(scale[:, -1].max()),
          "whisper's prefill step disagrees with its plain-attention run")
    del ref, last, agree

    # serving: fill_cross_cache, then decode against the forward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = model.fill_cross_cache(model.init_cache(WHISPER_B,
                                                    WHISPER_DECODE),
                                   frames)
    torch.cuda.synchronize()
    fill_ms = 1e3 * (time.perf_counter() - t0)
    outs = []
    t0 = time.perf_counter()
    for i in range(WHISPER_DECODE):
        lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
        outs.append(lg[:, 0].float())
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / WHISPER_DECODE
    got = torch.stack(outs, dim=1)                         # (b, 8, V)
    want = full[:, :WHISPER_DECODE].float()
    dec_err = (got - want).abs().amax(-1)
    dec_rel = float(dec_err.max()) / float(want.abs().max())
    dec_same = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    print(f"[whisper] fill_cross_cache {fill_ms:.2f} ms, then "
          f"{WHISPER_DECODE} decode steps vs the forward at positions "
          f"0..{WHISPER_DECODE - 1}: relative {dec_rel:.4g} (limit "
          f"{WHISPER_DECODE_TOL}), max abs diff per position "
          f"{[round(float(x), 4) for x in dec_err.amax(0)]}, argmax equal "
          f"at {dec_same:.4f}; {dec_ms:.2f} ms per decode step | {smi}",
          flush=True)
    check(dec_rel <= WHISPER_DECODE_TOL,
          "whisper's fill_cross_cache + decode disagrees with the forward")
    del model, full, cache, got, want, outs
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"[whisper] phase took {total:.1f} s (limit {WHISPER_PHASE_S} s) "
          f"| {smi}", flush=True)
    check(total <= WHISPER_PHASE_S, f"the whisper phase took {total:.1f} s")
    path = (f"{WHISPER_ARCH} prefill step ({WHISPER_B} x {WHISPER_T} "
            f"tokens, {WHISPER_B} x {cfg.encoder_len} frames)")
    d64 = {"launches": {path: launches},
           "layers_overall_rel_err": abs_max, "layers_row_rel_err": row_max,
           "logits_rel": float(pos_rel.max()), "decode_rel": dec_rel,
           "forward_wall_s": wall, "decode_ms": dec_ms,
           "forward_turns": turns, **times["d64"]}
    mma = {"launches": {path: 0}, **times["mma"]}
    return d64, mma


# ---------------------------------------------------------------------------
# phase 22: qwen2-vl-7b (M-RoPE, the stubbed vision embeddings, int8 KV)
# ---------------------------------------------------------------------------
def vlm_positions(dev, t: int):
    """(1, 3, t) M-RoPE ids: the stubbed image's patches (see VLM_ARCH) and
    text ids (i, i, i) everywhere else."""
    import torch
    pos = torch.arange(t, device=dev)[None, None].repeat(1, 3, 1)
    n = VLM_GRID * VLM_GRID
    patch = torch.arange(n, device=dev)
    span = slice(VLM_IMAGE_AT, VLM_IMAGE_AT + n)
    pos[0, 0, span] = VLM_IMAGE_AT
    pos[0, 1, span] = VLM_IMAGE_AT + patch // VLM_GRID
    pos[0, 2, span] = VLM_IMAGE_AT + patch % VLM_GRID
    return pos


def vlm_embeds(model, tokens, gen):
    """The token embeddings with the image's span replaced by N(0, 1)
    patch embeddings scaled to the embedding table's std (the stubbed
    front end's output)."""
    import torch
    x = model.embed[tokens]
    n = VLM_GRID * VLM_GRID
    std = float(model.embed.float().std())
    patches = torch.randn((tokens.shape[0], n, x.shape[-1]), generator=gen,
                          device=x.device) * std
    x[:, VLM_IMAGE_AT:VLM_IMAGE_AT + n] = patches.to(x.dtype)
    return x


def mrope_f64(x, positions, theta: float, sections):
    """``apply_mrope`` in float64 throughout on the CPU: the frequencies,
    each section's angles, their cos and sin and the rotation."""
    import torch
    x = x.double().cpu()
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64) / half))
    parts, start = [], 0
    for s_i, sec in enumerate(sections):
        pos = positions[:, s_i].cpu().double()
        parts.append(pos[:, None, :, None] * freqs[start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def vlm_rope_reading(model, tokens, embeds, pos) -> dict:
    """Layer 0's own q and k (the forward with ``embeds``) through
    ``apply_mrope`` on the card against :func:`mrope_f64` on the same
    inputs: max abs diff over max |want| for each."""
    import torch
    from repro_torch.models.attention import _split_heads
    from repro_torch.models.layers import apply_mrope, make_norm
    cfg = model.cfg
    lp = model.decoder[0]
    _, norm = make_norm(cfg.norm)
    out = {}
    with torch.no_grad():
        h = norm(lp["norm_mixer"], model._embed(tokens, embeds))
        for name, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads)):
            x = _split_heads(h @ lp["attn"][f"w{name}"], heads, cfg.head_dim)
            got = apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
            want = mrope_f64(x, pos, cfg.rope_theta, cfg.mrope_sections)
            out[name] = float((got.cpu().double() - want).abs().max()
                              / want.abs().max())
            del x, got, want
    return out


def vlm_int8(model, tokens, smi: str) -> None:
    """(f) of phase 22: the int8 KV cache, made as ``Model.init_cache``
    makes it for the config with ``kv_quant="int8"``
    (``transformer.stack_cache_init``) and decoded through this model (the
    decode branches on the cache's scales, as the reference's does)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    qcfg = dataclasses.replace(cfg, kv_quant="int8")
    dev = tokens.device
    t8 = VLM_INT8_T
    toks = tokens[:, :t8]
    full, _ = model.forward(toks)
    want = full[0].float()
    del full

    def decode_all(cache):
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(t8):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
            outs.append(lg[0, 0].float())
        torch.cuda.synchronize()
        return torch.stack(outs), 1e3 * (time.perf_counter() - t0) / t8, cache

    cache8 = tfm.stack_cache_init(qcfg, 1, t8, cfg.param_dtype, device=dev)
    check(all(lc["kv"]["k"].dtype == torch.int8
              and lc["kv"]["k_scale"].dtype == torch.float32
              and tuple(lc["kv"]["k_scale"].shape)
              == (1, cfg.n_kv_heads, t8, 1) for lc in cache8),
          "the int8 cache has the wrong dtypes or shapes")
    got8, ms8, cache8 = decode_all(cache8)
    filled = all(bool((lc["kv"][s] > 0).all()) for lc in cache8
                 for s in ("k_scale", "v_scale"))
    got16, ms16, _ = decode_all(model.init_cache(1, t8))
    del cache8
    scale = float(want.abs().max())
    r = {}
    for name, got in (("int8", got8), ("bf16", got16)):
        r[name] = {"rel": float((got - want).abs().max()) / scale,
                   "agree": float((got.argmax(-1) == want.argmax(-1))
                                  .double().mean())}
    r["int8"]["ms"], r["bf16"]["ms"] = ms8, ms16
    print(f"[vlm] (f) int8 KV cache: {t8} tokens decoded from an empty "
          f"cache vs the forward over them: relative max abs diff "
          f"{r['int8']['rel']:.4g} (limit < {VLM_INT8_REL}), argmax equal at "
          f"{r['int8']['agree']:.4f} of positions (limit > "
          f"{VLM_INT8_AGREE}), every slot's scales written {filled}; the bf16 "
          f"cache's decode of the same tokens: {r['bf16']['rel']:.4g}, "
          f"{r['bf16']['agree']:.4f}; ms a decode step int8 {ms8:.2f}, bf16 "
          f"{ms16:.2f} | {smi}", flush=True)
    check(r["int8"]["rel"] < VLM_INT8_REL
          and r["int8"]["agree"] > VLM_INT8_AGREE and filled,
          "the int8 KV cache's decode disagrees with the forward")
    del got8, got16, want

    # the caches at max_len LM_T + LM_DECODE: bytes, and a decode step's
    # time and transient memory against each (the unwritten slots hold
    # zeros; the step's time, not its output, is read)
    length = LM_T + LM_DECODE
    caches = {"int8": tfm.stack_cache_init(qcfg, 1, length, cfg.param_dtype,
                                           device=dev),
              "bf16": model.init_cache(1, length)}
    nbytes = {n: sum(t.numel() * t.element_size() for lc in c
                     for t in lc["kv"].values()) for n, c in caches.items()}
    want8 = cfg.n_layers * 2 * cfg.n_kv_heads * length * (cfg.head_dim + 4)
    want16 = cfg.n_layers * 2 * cfg.n_kv_heads * length * cfg.head_dim * 2
    # the float32 copy of one layer's int8 k (then v) made for a product,
    # freed after it: its size from the config's shapes (not measured)
    transient = cfg.n_kv_heads * length * cfg.head_dim * 4
    for n, c in caches.items():
        model.decode_step(tokens[:, LM_T:LM_T + 1], c, LM_T)      # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(LM_T, LM_T + VLM_STEPS_8200):
            model.decode_step(tokens[:, i:i + 1], c, i)
        torch.cuda.synchronize()
        r[n]["ms_8200"] = 1e3 * (time.perf_counter() - t0) / VLM_STEPS_8200
        r[n]["step_extra_bytes_8200"] = torch.cuda.max_memory_allocated() - base
    r["int8"]["bytes_8200"], r["bf16"]["bytes_8200"] = (nbytes["int8"],
                                                       nbytes["bf16"])
    print(f"[vlm] (f) caches at max_len {length}: int8 {nbytes['int8']} B "
          f"(want {want8}), bf16 {nbytes['bf16']} B (want {want16}), "
          f"{nbytes['int8'] / nbytes['bf16']:.4f}x; a decode step against "
          f"each: int8 {r['int8']['ms_8200']:.2f} ms, bf16 "
          f"{r['bf16']['ms_8200']:.2f} ms (mean of {VLM_STEPS_8200}); the "
          f"step's memory above the resident: int8 "
          f"{r['int8']['step_extra_bytes_8200']} B (of it the float32 copy "
          f"of one layer's k or v, from the config's shapes: {transient} B), "
          f"bf16 "
          f"{r['bf16']['step_extra_bytes_8200']} B | {smi}", flush=True)
    check(nbytes["int8"] == want8 and nbytes["bf16"] == want16,
          "the KV caches' bytes are not the config's")
    del caches
    torch.cuda.empty_cache()


def vlm_phase(dev, seed: int) -> dict:
    """Phase 22 (see VLM_ARCH). Returns ``flash_attention_sm90``'s
    qwen2-vl-7b readings for its entry of the kernels line: the launches
    of the prefill step, the layer shape's times and K3's agreement with
    the plain attention in the forward. The phase's other readings are in
    its printed lines only."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    smi = nvidia_smi_line()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    parts = {}
    cfg = ARCHS[VLM_ARCH]
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    parts["draw"] = time.perf_counter() - t_phase
    print(f"[vlm] {VLM_ARCH}: {n_par} parameters (config n_params "
          f"{cfg.n_params()}; {par_bytes / 1e9:.3f} GB bf16), "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, M-RoPE sections {cfg.mrope_sections}, theta "
          f"{cfg.rope_theta:g}; drawn on the card in {parts['draw']:.2f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    pos = vlm_positions(dev, LM_T + LM_DECODE)
    pos_pre = pos[:, :, :LM_T]

    # (a) the prefill step over the tokens at the image's ids
    t0 = time.perf_counter()
    batch = {"tokens": tokens[:, :LM_T], "positions": pos_pre}
    pre = prefill_step_reading(
        model, batch["tokens"], f"[vlm] (a) a {VLM_GRID} x {VLM_GRID} "
        f"image's M-RoPE ids at [{VLM_IMAGE_AT}, "
        f"{VLM_IMAGE_AT + VLM_GRID ** 2}),", f" | {smi}", positions=pos_pre)
    launches, last = pre["launches"], pre["last"]
    parts["a"] = time.perf_counter() - t0

    # (b) the forward with the stubbed patch embeddings, K3 against the
    # plain attention
    t0 = time.perf_counter()
    embeds = vlm_embeds(model, batch["tokens"], gen)
    agree, _ = lm_agreement(model, batch["tokens"], positions=pos_pre,
                            embeds=embeds)
    print(f"[vlm] (b) forward with embeds over {LM_T}, K3 vs plain attention "
          f"(plain run {agree['plain_wall']:.2f} s): K3 per row on each "
          f"layer's own q, k, v: max {agree['layers_max']:.4g} (limit "
          f"{ATTN_ROW_TOL['bfloat16']}), per layer "
          f"{[round(e, 5) for e in agree['layer_row_err']]}", flush=True)
    print(f"[vlm] (b) logits max abs diff over max |logit| per position: max "
          f"{agree['pos_rel_max']:.4g} (limit {LM_REL_TOL_PLAIN}), first "
          f"{LM_EARLY} positions {agree['pos_rel_early']:.4g}, last "
          f"{agree['pos_rel_last']:.4g}; argmax equal at "
          f"{agree['argmax_equal_share']:.4f} of positions, at the last "
          f"{agree['argmax_last_equal']}", flush=True)
    check(agree["ok_layers"], "K3 disagrees with its plain version on "
          "qwen2-vl's own q, k, v")
    check(agree["ok_logits"], "qwen2-vl's forward disagrees with its "
          "plain-attention run")
    parts["b"] = time.perf_counter() - t0

    # (c) M-RoPE on the card against float64, and the image's ids moving
    # the logits: the prefill step's (image ids) against text ids
    t0 = time.perf_counter()
    rope = vlm_rope_reading(model, batch["tokens"], embeds, pos_pre)
    del embeds
    text, _ = model.forward(batch["tokens"], last_only=True)
    text = text[0, -1].float()
    move = float((last[0].float() - text).abs().max()) / float(
        text.abs().max())
    print(f"[vlm] (c) M-RoPE on layer 0's own q, k vs a float64 run of it "
          f"on the CPU (mrope_f64): max abs diff over max |want| q "
          f"{rope['q']:.4g}, k {rope['k']:.4g} (limit {VLM_ROPE_TOL}); the "
          f"last position's logits at the image's ids vs at text ids (i, i, "
          f"i): relative max abs diff {move:.4g}, against (b)'s largest K3 "
          f"difference {agree['pos_rel_max']:.4g} (must exceed it); argmax "
          f"{int(last.argmax())} vs {int(text.argmax())}", flush=True)
    check(max(rope.values()) <= VLM_ROPE_TOL,
          "M-RoPE on the card disagrees with its float64 run")
    check(move > agree["pos_rel_max"],
          "the image's M-RoPE ids do not move the logits beyond bf16 noise")
    del last, text, batch, pre
    parts["c"] = time.perf_counter() - t0

    # (d) prefill + decode at the image's ids against the forward
    t0 = time.perf_counter()
    logits_pre, cache = model.prefill(tokens[:, :LM_T],
                                      max_len=LM_T + LM_DECODE,
                                      positions=pos_pre)
    outs = [logits_pre[:, -1].float()]
    del logits_pre
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(LM_T, LM_T + LM_DECODE):
        lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
        outs.append(lg[:, 0].float())
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t1) / LM_DECODE
    del cache
    full, _ = model.forward(tokens, positions=pos)
    want = full[0, LM_T - 1:].float()
    del full
    got = torch.cat(outs)
    err = (got - want).abs().amax(dim=-1)
    scale = float(want.abs().max())
    dec_rel = float(err.max()) / scale
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"[vlm] (d) prefill({LM_T}) + {LM_DECODE} decode steps vs forward "
          f"over {LM_T + LM_DECODE}, the image's ids: max abs diff per "
          f"position {[round(float(x), 5) for x in err]}, max |logit| "
          f"{scale:.4g}, relative {dec_rel:.4g} (limit {LM_REL_TOL_DECODE}), "
          f"argmax equal {same}, {dec_ms:.2f} ms per decode step | {smi}",
          flush=True)
    check(dec_rel <= LM_REL_TOL_DECODE,
          "qwen2-vl's prefill + decode disagrees with the forward")
    del got, want, outs
    parts["d"] = time.perf_counter() - t0

    # (f) the int8 KV cache, through this model
    t0 = time.perf_counter()
    vlm_int8(model, tokens, smi)
    parts["f"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    # (e) the serve launcher (it draws its own model)
    t0 = time.perf_counter()
    outputs = serve.main(["--arch", VLM_ARCH, "--requests", "8",
                          "--batch-slots", "4", "--prompt-len", "16",
                          "--max-new", "16", "--max-len", "256"])
    parts["e"] = time.perf_counter() - t0
    print(f"[vlm] (e) serve.main() took {parts['e']:.2f} s with the model's "
          f"draw", flush=True)
    check(len(outputs) == 8
          and all(len(g) == 16 and all(0 <= x < cfg.vocab_size for x in g)
                  for _, g in outputs),
          "the serve launcher did not answer 8 requests with 16 tokens")
    torch.cuda.empty_cache()

    # (g) K3 at the layer shape in turns with SDPA, on the device alone
    t0 = time.perf_counter()
    k3 = k3_turns(dev, seed, VLM_ATTN_SHAPE, 20, 3)
    print_k3_turns("[vlm] (g)", k3, smi)
    parts["g"] = time.perf_counter() - t0

    total = time.perf_counter() - t_phase
    print(f"[vlm] phase parts (s): "
          f"{ {n: round(x, 2) for n, x in parts.items()} }", flush=True)
    print(f"[vlm] phase took {total:.1f} s (limit {VLM_PHASE_S} s) | {smi}",
          flush=True)
    check(total <= VLM_PHASE_S, f"the qwen2-vl phase took {total:.1f} s")
    return {"launches": {f"{VLM_ARCH} prefill step (1 x {LM_T}, M-RoPE "
                         "image ids)": launches},
            "ms": k3["ms"], "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
            "library_ms": k3["library_ms"], "ms_of": k3["shape"],
            "layers_row_rel_err": agree["layers_max"],
            "logits_rel": agree["pos_rel_max"]}


# ---------------------------------------------------------------------------
# phase 23: the other dense decoders at full width
# ---------------------------------------------------------------------------
def k3_turns(dev, seed: int, shape, reps: int, plain_reps: int) -> dict:
    """``flash_attention_sm90`` at ``shape`` (bf16) in turns with SDPA on
    the device alone (``queued_ms``; kernel, SDPA, SDPA, kernel): SDPA
    causal with ``enable_gqa``, and under a window also with the window as
    a boolean mask, K and V repeated to the query heads first (the same
    function: the kernels line's library call there). Then the plain
    version over ``plain_reps`` calls, the kernel held to it (ATTN_TOL,
    ATTN_ROW_TOL), and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_plain, flash_attention_sm90)
    b, hq, hkv, t, _, d, causal, window = shape
    q, k, v = _qkv(dev, seed, b, hq, hkv, t, t, d, torch.bfloat16)
    runs = {"sm90": (lambda: flash_attention_sm90(q, k, v, causal=causal,
                                                  window=window), reps),
            "sdpa": (lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)}
    library = "sdpa"
    if window:
        kr, vr = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
        pos = torch.arange(t, device=dev)
        mask = ((pos[:, None] >= pos[None])
                & (pos[:, None] - pos[None] < window))
        runs["sdpa_window_mask"] = (lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask), max(2, reps // 4))
        library = "sdpa_window_mask"
    got = runs["sm90"][0]()
    diff = float((got.float() - runs[library][0]().float()).abs().max())
    for fn, _ in runs.values():
        fn()                                              # warm-up
    ms = {n: [] for n in runs}
    order = tuple(runs)
    for turn in (order, order[::-1]):
        for n in turn:
            ms[n].append(queued_ms(*runs[n]))
    mean = {n: sum(x) / len(x) for n, x in ms.items()}
    held = {}
    plain_ms = cuda_ms(lambda: held.update(want=flash_attention_plain(
        q, k, v, causal=causal, window=window)), plain_reps)
    want = held.pop("want")
    err = float((got.float() - want.float()).abs().max())
    row = row_rel_err(got, want)
    bound, by = k3_bound(b, hq, hkv, t, d, window=window)
    del q, k, v, got, want, runs
    torch.cuda.empty_cache()
    out = {"shape": f"bf16 ({b}, {hq}/{hkv}, {t}, {d}) causal"
                    + (f", window {window}" if window else ""),
           "ms": mean["sm90"], "turns": ms["sm90"], "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by,
           "library_ms": mean[library], "library_turns": ms[library],
           "max_abs_err": err, "row_rel_err": row,
           "max_abs_diff_library": diff}
    if window:
        out["library_call"] = ("scaled_dot_product_attention with the "
                               "window as a boolean attn_mask, K and V "
                               f"repeated to {hq} heads")
        out["library_ms_causal_no_window"] = mean["sdpa"]
    check(err < ATTN_TOL["bfloat16"] and row < ATTN_ROW_TOL["bfloat16"],
          f"flash_attention_sm90 disagrees with its plain version at {shape}")
    check(bound <= mean["sm90"], f"flash_attention_sm90 beat its bound at "
          f"{shape}: the bound is not a floor")
    return out


def print_k3_turns(tag: str, r: dict, smi: str) -> None:
    nowin = ("" if "library_ms_causal_no_window" not in r else
             f" (with the window as a boolean mask, K and V repeated); "
             f"SDPA causal without the window "
             f"{r['library_ms_causal_no_window']:.4f} ms")
    print(f"{tag} K3 at {r['shape']}, device alone, in turns: "
          f"flash_attention_sm90 {r['turns']} ms, "
          f"scaled_dot_product_attention {r['library_turns']} ms{nowin}; "
          f"the kernel at {r['ms'] / r['library_ms']:.3f}x SDPA's time; "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
          f"{r['bound_ms'] / r['ms']:.1%} of it); plain version "
          f"{r['plain_ms']:.3f} ms, the kernel against it max abs "
          f"{r['max_abs_err']:.3g} (limit {ATTN_TOL['bfloat16']}), per row "
          f"{r['row_rel_err']:.3g} (limit {ATTN_ROW_TOL['bfloat16']}); max "
          f"abs diff vs SDPA {r['max_abs_diff_library']:.3g} | {smi}",
          flush=True)


def dense_long(model, gen, smi: str) -> dict:
    """granite-20b at DENSE_LONG_T tokens (the assigned prefill_32k length
    at batch 1): one prefill step (``prefill_step_reading``, no warm-up at
    this length), then prefill of all but LM_DECODE tokens into caches of
    DENSE_LONG_T slots and LM_DECODE decode steps at the learned table's
    last rows, against the forward over DENSE_LONG_T."""
    import torch
    cfg, t = model.cfg, DENSE_LONG_T
    tag = f"[dense] {cfg.name} (f)"
    tokens = torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                           device=model.device)
    pre = prefill_step_reading(model, tokens, tag, f" | {smi}",
                               warm_up=False)
    del pre["last"]
    dec = decode_seam(model, tokens, t - LM_DECODE)
    print(f"{tag} prefill({t - LM_DECODE}) into {dec['slots']} slots + "
          f"{LM_DECODE} decode steps at positions {t - LM_DECODE}..{t - 1} "
          f"(the learned table's last rows) vs the forward over {t}: max "
          f"abs diff per position {dec['err']}, max |logit| "
          f"{dec['scale']:.4g}, relative {dec['rel']:.4g} (limit "
          f"{LM_REL_TOL_DECODE}), argmax equal {dec['argmax']}, "
          f"{dec['ms']:.2f} ms per decode step", flush=True)
    check(dec["prefill_launches"] == cfg.n_layers
          and dec["rel"] <= LM_REL_TOL_DECODE,
          f"{cfg.name}'s prefill + decode at the table's end disagrees with "
          "the forward")
    del tokens
    torch.cuda.empty_cache()
    return {**pre, "decode": dec}


def dense_serving(dev, seed: int, arch: str, smi: str, parts: dict) -> dict:
    """One dense decoder of phase 23 (see DENSE_ARCHS): drawn at full
    width, served through ``lm_serving`` (a-c), granite-20b also at
    DENSE_LONG_T (``dense_long``, f); freed; the launcher (d); K3 at its
    layer shape in turns with SDPA (e). Returns the readings."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import Model

    cfg = ARCHS[arch]
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    parts[f"{arch} draw"] = time.perf_counter() - t0
    positions = (f"a learned table of {cfg.max_position} rows"
                 if cfg.pos_embed == "learned"
                 else f"RoPE theta {cfg.rope_theta:g}")
    print(f"[dense] {arch}: {n_par} parameters (config n_params "
          f"{cfg.n_params()}, which leaves out the final norm and LayerNorm "
          f"biases; {par_bytes / 1e9:.3f} GB bf16), {cfg.n_layers} layers "
          f"({cfg.pattern[0]}), d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, window {cfg.window}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, "
          f"{cfg.activation}, {positions}, tied embeddings "
          f"{cfg.tie_embeddings}; drawn on the card in "
          f"{parts[f'{arch} draw']:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_T + LM_DECODE),
                           generator=gen, device=dev)
    r = lm_serving(model, tokens, f"[dense] {arch} (a-c)", f" | {smi}")
    for name, sec in r["seconds"].items():
        parts[f"{arch} {name}"] = sec
    del tokens
    if arch == DENSE_LONG_ARCH:
        t0 = time.perf_counter()
        r["long"] = dense_long(model, gen, smi)
        parts[f"{arch} {DENSE_LONG_T}"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    parts[f"{arch} launcher"] = lm_launcher(arch, f"[dense] {arch} (d)")
    t0 = time.perf_counter()
    r["k3"] = k3_turns(dev, seed, DENSE_ATTN_SHAPES[arch], 20, 2)
    print_k3_turns(f"[dense] {arch} (e)", r["k3"], smi)
    parts[f"{arch} K3 turns"] = time.perf_counter() - t0
    return r


def dense_phase(dev, seed: int) -> dict:
    """Phase 23 (see DENSE_ARCHS). Returns ``flash_attention_sm90``'s
    readings for its entry of the kernels line (each model's layer shape
    and granite-20b's DENSE_LONG_SHAPE: launches, times, bound, SDPA's
    time, the kernel's error) and the Hopper K3-bwd's at granite-20b's
    AdamW shape. The phase's other readings are in its printed lines."""
    import torch

    smi = nvidia_smi_line()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    parts, k3, bwd = {}, {}, {}
    for arch in DENSE_ARCHS:
        r = dense_serving(dev, seed, arch, smi, parts)
        k3[arch] = {**r["k3"], "launches": {
                        f"{arch} prefill step (1 x {LM_T})": r["launches"]},
                    "layers_row_rel_err": r["agree"]["layers_max"],
                    "logits_rel": r["agree"]["pos_rel_max"]}
        if arch != DENSE_LONG_ARCH:
            continue
        # (f) K3 at the long prefill's layer shape, the model freed
        t0 = time.perf_counter()
        long = k3_turns(dev, seed, DENSE_LONG_SHAPE, 4, 1)
        print_k3_turns(f"[dense] {arch} (f)", long, smi)
        k3[f"{arch} {DENSE_LONG_T}"] = {**long, "launches": {
            f"{arch} prefill step (1 x {DENSE_LONG_T})":
                r["long"]["launches"]}}
        parts[f"{arch} {DENSE_LONG_T} K3 turns"] = time.perf_counter() - t0
        # (g) AdamW cut to ADAMW_LAYERS layers, and K3-bwd at its shape
        t0 = time.perf_counter()
        launches = adamw_cut(dev, seed, arch, f"[dense] {arch} (g)")
        b, hq, hkv, t, _, d = DENSE_BWD_SHAPE[:6]
        times = bwd_times(dev, seed, b, hq, hkv, t, d, 20, device_only=True)
        print_bwd_times(f"[dense] {arch} (g)", times)
        bwd = {"shape": times["shape"], "ms": times["ms"]["sm90"],
               "turns": times["turns"]["sm90"],
               "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
               "bound_by": times["bound_by"],
               "library_ms": times["ms"]["sdpa"],
               "mma_ms": times["ms"]["mma"],
               "launches": {f"{arch} {ADAMW_STEPS} AdamW steps at "
                            f"{ADAMW_LAYERS} layers":
                                launches["flash_attention_bwd_sm90"]}}
        k3[arch]["launches"][f"{arch} {ADAMW_STEPS} AdamW steps at "
                             f"{ADAMW_LAYERS} layers"] = launches[
                                 "flash_attention_sm90"]
        parts[f"{arch} AdamW"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"[dense] phase parts (s): "
          f"{ {n: round(x, 2) for n, x in parts.items()} }", flush=True)
    print(f"[dense] phase took {total:.1f} s (limit {DENSE_PHASE_S} s) | "
          f"{smi}", flush=True)
    check(total <= DENSE_PHASE_S, f"the dense phase took {total:.1f} s")
    return {"k3": k3, "bwd": bwd}


# ---------------------------------------------------------------------------
# phase 24: the recurrent families' and whisper-small's training
# ---------------------------------------------------------------------------
def rel_max(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def window_pairs(t: int, window) -> int:
    """The (query, key) pairs causal attention over t tokens keeps, each
    query seeing at most ``window`` keys."""
    w = window or t
    return sum(min(q + 1, w) for q in range(t))


def s_bwd_bound(b, t, d, itemsize) -> tuple[float, str]:
    """Least time for S-bwd on (b, t, d): u, xi, xr and dh read once, du,
    dxi and dxr written once, in the model's type; against its float32
    operations, 32 an element (the gates' 15 of ``scan_bound``, the
    reverse step's 2 and the chain rule's 15), a transcendental counted as
    one."""
    return bound_ms(7 * itemsize * b * t * d, 32 * b * t * d)


W_BWD_STEP_MS = 3.103    # the step form's time at the path's shape, before


def w_bwd_bound(b, t, h, hd, itemsize) -> tuple[float, str]:
    """Least time for W-bwd on (b, t, h, hd) in its chunked form (chunks of
    C = 16 steps): the bytes, r, k, v (the model's type), logw and dy
    (float32) read once, dr, dk, dv and dlogw written once, at the memory
    rate; against the form's operations: its products a chunk and head,
    five of the state (2·C·hd² FLOP each: the forward sweep's K̂ᵀV, dY S0ᵀ,
    V Gᵀ, K̂ G and r̃ᵀ dY) and two of the chunk (2·C²·hd: Aᵀ dY, dY Vᵀ), at
    the TF32 tensor-core rate, three passes each in split TF32, two where
    one side is a bf16 v (exact in TF32); and its decay terms on the CUDA
    cores, 7 an entry (t, s < t) and channel (the two loops' W, x and sums)
    and 16 a step and channel (prefixes, P, Q, r̃, K̂ and the outputs), at
    the float32 rate. The two kinds of operation run on different units, so
    the slower of them counts. The step form this replaced was bound by its
    12 CUDA-core operations an element of the state a step, a bound of the
    form and not of the work."""
    c = 16
    units = b * h * -(-t // c)
    v_pass = 2 if itemsize == 2 else 3
    tc = units * (2 * c * hd * hd * (3 * 3 + 2 * v_pass)
                  + 2 * c * c * hd * (3 + v_pass))
    cuda = units * hd * (7 * c * (c - 1) // 2 + 16 * c)
    t_ops = max(tc / PEAK_TF32_OPS_S, cuda / PEAK_F32_OPS_S)
    t_bytes = b * t * h * hd * (6 * itemsize + 12) / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_bound_cross(b, hq, hkv, sq, sk, d, causal) -> tuple[float, str]:
    """Least time for K3's backward of sq queries over sk keys (bf16):
    q, dO, dQ (b·hq·sq·d each), k, v, dK, dV (b·hkv·sk·d each) and the
    lse moved once (no O: D = rowsum(P ∘ dP)); five products of 2·d FLOP a
    kept pair (causal with sq = sk: the lower triangle)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return bound_ms(2 * (3 * b * hq * sq * d + 4 * b * hkv * sk * d)
                    + 4 * b * hq * sq, 10 * d * b * hq * pairs,
                    PEAK_BF16_OPS_S)


def d256_bwd_bound(b, hq, hkv, t, d, window) -> tuple[float, str]:
    """Least time for K3-bwd at (b, hq/hkv, t, d) causal with a window:
    q, k, v, dO and the lse read once, dQ, dK, dV written once (bf16; no
    O: D = rowsum(P ∘ dP)); five products of 2·d FLOP a kept (query, key)
    pair."""
    return bound_ms(2 * (3 * b * hq * t * d + 4 * b * hkv * t * d)
                    + 4 * b * hq * t,
                    10 * d * b * hq * window_pairs(t, window),
                    PEAK_BF16_OPS_S)


def _plain_fn(fwd, bwd, n_in: int):
    """A torch.autograd.Function whose forward is ``fwd`` and backward
    ``bwd(*inputs, *output_grads)``: a kernel's plain version with its plain
    backward, for the reference runs."""
    import torch

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *inputs):
            ctx.save_for_backward(*inputs)
            return fwd(*inputs)

        @staticmethod
        def backward(ctx, *grads):
            grads = tuple(grads)
            return tuple(bwd(*ctx.saved_tensors, *grads))[:n_in]
    return Plain


@contextlib.contextmanager
def plain_recurrent():
    """Run the model through every kernel's plain version, forward and
    backward: the attention's plain version (autograd through it), S's and
    W's plain forwards with their plain backwards (``rglru_lru_bwd_ref``,
    ``wkv_bwd_ref``). No kernel runs inside."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.rglru_scan.ref import (rglru_lru_bwd_ref,
                                                    rglru_lru_ref)
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref, wkv_ref
    from repro_torch.models import attention, rglru, rwkv6

    def lru_bwd(u, xi, xr, lam, dh, dlast):
        du, dxi, dxr, dlam = rglru_lru_bwd_ref(
            u, xi, xr, lam, torch.zeros_like(u) if dh is None else dh, dlast)
        return du, dxi, dxr, dlam.to(lam.dtype)

    def wkv_bwd(r, k, v, logw, u, dy, dS):
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        return wkv_bwd_ref(r, k, v, logw, u, dy, dS)

    lru = _plain_fn(rglru_lru_ref, lru_bwd, 4)
    wkv = _plain_fn(wkv_ref, wkv_bwd, 5)
    saved = (attention.flash_attention, rglru.rglru_lru, rwkv6.rwkv6_wkv)
    attention.flash_attention = flash_attention_plain
    rglru.rglru_lru = lambda *a: lru.apply(*a)
    rwkv6.rwkv6_wkv = lambda *a: wkv.apply(*a)
    try:
        yield
    finally:
        attention.flash_attention, rglru.rglru_lru, rwkv6.rwkv6_wkv = saved


@contextlib.contextmanager
def plain_calls(counter: dict):
    """Count every call of a kernel's plain version made through the ops
    modules (the wrappers' CPU branch and the backward Functions'), into
    ``counter`` by name: on the card the path must make none."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as s_ops
    from repro_torch.kernels.rwkv6_wkv import ops as w_ops
    names = [(fa, "flash_attention_plain"), (fa, "flash_attention_bwd_plain"),
             (s_ops, "rglru_lru_ref"), (s_ops, "rglru_lru_bwd_ref"),
             (w_ops, "wkv_ref"), (w_ops, "wkv_bwd_ref")]
    saved = [getattr(m, n) for m, n in names]

    def counting(name, fn):
        def run(*a, **kw):
            counter[name] = counter.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    for (m, n), fn in zip(names, saved):
        setattr(m, n, counting(n, fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def rtrain_counted() -> dict:
    """The wrappers a recurrent or whisper training step can launch, by
    direction."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.perturb.ops import abo_zo_perturb
    from repro_torch.kernels.rglru_scan.ops import rglru_lru, rglru_lru_bwd
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv, rwkv6_wkv_bwd
    return {"forward": (rglru_lru, rwkv6_wkv, fa.flash_attention_sm90_d256,
                        fa.flash_attention_sm90_d64, fa.flash_attention_sm90,
                        fa.flash_attention_mma),
            "backward": (rglru_lru_bwd, rwkv6_wkv_bwd, fa.flash_attention_bwd,
                         fa.flash_attention_bwd_mma,
                         fa.flash_attention_bwd_sm90,
                         fa.flash_attention_bwd_sm90_d64,
                         fa.flash_attention_bwd_sm90_d256),
            "perturb": (abo_zo_perturb,)}


def _counts(counted: dict) -> dict:
    return {d: {w.__name__: w.launches for w in ws}
            for d, ws in counted.items()}


def _moved(before: dict, after: dict) -> dict:
    return {d: {n: after[d][n] - c for n, c in ws.items()
                if after[d][n] != c} for d, ws in before.items()}


def s_bwd_readings(dev, seed: int) -> dict:
    """(a) S-bwd at S_BWD_SHAPES against its plain version on the card,
    twice; the kernel timed at the first shape beside its plain version's
    held call. Returns its reading for the kernels line."""
    import torch
    from repro_torch.kernels.rglru_scan.ops import rglru_lru_bwd
    from repro_torch.kernels.rglru_scan.ref import rglru_lru_bwd_ref
    from repro_torch.models.rglru import log_lambda_init
    err, out = 0.0, {}
    for b, t, d, name in S_BWD_SHAPES[::-1]:        # the path's shape last
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(seed + t)
        u, xi, xr, dh = (torch.randn((b, t, d), generator=g, device=dev)
                         .to(dtype) for _ in range(4))
        dlast = torch.randn((b, d), generator=g, device=dev)
        lam = log_lambda_init(d, dev).to(dtype)
        before = rglru_lru_bwd.launches
        got = rglru_lru_bwd(u, xi, xr, lam, dh, dlast)
        again = rglru_lru_bwd(u, xi, xr, lam, dh, dlast)
        moved = rglru_lru_bwd.launches - before
        want = []
        plain_ms = cuda_ms(lambda: want.extend(rglru_lru_bwd_ref(
            u, xi, xr, lam, dh, dlast)), 1)
        rel = {n: rel_max(a, w) for n, a, w in
               zip(("du", "dxi", "dxr", "dlam"), got, want)}
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        lim = {n: RTRAIN_TOL[name if n != "dlam" else "float32"]
               for n in rel}
        print(f"[rtrain] (a) S-bwd ({b}, {t}, {d}) {name}, dlast given: "
              f"max |err| / max |plain| {rel} (limits {lim}); a second run "
              f"the same bits {same}; launches {moved}", flush=True)
        check(same and moved == 2 and all(rel[n] <= lim[n] for n in rel)
              and all(bool(torch.isfinite(a).all()) for a in got),
              f"S-bwd disagrees with its plain version at ({b}, {t}, {d}) "
              f"{name}, or gave other bits on a repeat")
        err = max(err, max(float((a.float() - w.float()).abs().max())
                           for a, w in zip(got, want)))
        out = {"shape": (b, t, d), "rel": rel}
    # the plain version's time is its held call's, just above
    t_ms = {"kernel": [queued_ms(lambda: rglru_lru_bwd(u, xi, xr, lam, dh),
                                 20) for _ in range(2)], "plain": [plain_ms]}
    ms = {n: sum(v) / len(v) for n, v in t_ms.items()}
    bound, by = s_bwd_bound(b, t, d, 2)
    print(f"[rtrain] (a) S-bwd ({b}, {t}, {d}) bf16: kernel "
          f"{t_ms['kernel']} ms (device alone, queued_ms, twice), plain "
          f"version {t_ms['plain']} ms (events, its held call above, dlast "
          f"given); bound {bound:.4f} ms ({by}), "
          f"{bound / ms['kernel']:.1%} of it; no library call computes the "
          f"RG-LRU's gradient | {nvidia_smi_line()}", flush=True)
    check(bound <= ms["kernel"], "S-bwd beat its bound")
    del u, xi, xr, dh, got, again, want
    torch.cuda.empty_cache()
    return {"name": "rglru_lru_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
            "replaces": "port only: stands for the autodiff of _gates and "
                        "jax.lax.associative_scan at "
                        "src/repro/models/rglru.py:37-46,74",
            "launches": 0, "max_abs_err": err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": None, "max_rel_err": out["rel"],
            "ms_of": f"bf16 at {out['shape']}"}


def w_bwd_readings(dev, seed: int) -> dict:
    """(a) W-bwd at W_BWD_SHAPES against its plain version on the card,
    overall and per head, twice; the kernel timed at the first shape beside
    its plain version's held call. Returns its reading for the kernels
    line."""
    import torch
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_bwd
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_bwd_ref
    err, out = 0.0, {}
    for b, t, h, hd, name, shift in W_BWD_SHAPES[::-1]:
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(seed + t + hd)
        r, k, v, logw, u = wkv_inputs(dev, g, (b, t, h, hd), dtype, shift)
        dy = torch.randn((b, t, h, hd), generator=g, device=dev)
        dS = torch.randn((b, h, hd, hd), generator=g, device=dev)
        before = rwkv6_wkv_bwd.launches
        got = rwkv6_wkv_bwd(r, k, v, logw, u, dy, dS)
        again = rwkv6_wkv_bwd(r, k, v, logw, u, dy, dS)
        moved = rwkv6_wkv_bwd.launches - before
        want = []
        plain_ms = cuda_ms(lambda: want.extend(wkv_bwd_ref(
            r, k, v, logw, u, dy, dS)), 1)
        names = ("dr", "dk", "dv", "dlogw", "du")
        rel = {n: rel_max(a, w) for n, a, w in zip(names, got, want)}
        head = {n: float(((a.float() - w.float()).abs().amax((0, 1, 3))
                          / w.float().abs().amax((0, 1, 3)).clamp_min(1e-30))
                         .max()) for n, a, w in zip(names[:3], got, want)}
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        lim = {n: RTRAIN_TOL[name if n in names[:3] else "float32"]
               for n in names}
        print(f"[rtrain] (a) W-bwd ({b}, {t}, {h}, {hd}) {name}, decay "
              f"shift {shift}, dS given: max |err| / max |plain| {rel}, "
              f"worst head {head} (limits {lim}); a second run the same bits "
              f"{same}; launches {moved}", flush=True)
        check(same and moved == 2 and all(rel[n] <= lim[n] for n in rel)
              and all(head[n] <= lim[n] for n in head)
              and all(bool(torch.isfinite(a).all()) for a in got),
              f"W-bwd disagrees with its plain version at ({b}, {t}, {h}, "
              f"{hd}) {name}, or gave other bits on a repeat")
        err = max(err, max(float((a.float() - w.float()).abs().max())
                           for a, w in zip(got, want)))
        out = {"shape": (b, t, h, hd), "rel": rel}
    # the plain version's time is its held call's, just above
    t_ms = {"kernel": [queued_ms(lambda: rwkv6_wkv_bwd(r, k, v, logw, u, dy),
                                 10) for _ in range(2)], "plain": [plain_ms]}
    ms = {n: sum(x) / len(x) for n, x in t_ms.items()}
    bound, by = w_bwd_bound(b, t, h, hd, 2)
    print(f"[rtrain] (a) W-bwd ({b}, {t}, {h}, {hd}) bf16: kernel "
          f"{t_ms['kernel']} ms (device alone, twice; the chunked form), "
          f"earlier {W_BWD_STEP_MS} ms (the step form it replaced, NVIDIA "
          f"H100 80GB HBM3 at 700 W), plain version "
          f"{t_ms['plain']} ms (events, its held call above, dS given); "
          f"bound {bound:.4f} ms ({by}, the chunked form's), "
          f"{bound / ms['kernel']:.1%} of it; no library call computes "
          f"RWKV6's gradient | {nvidia_smi_line()}", flush=True)
    check(bound <= ms["kernel"], "W-bwd beat its bound")
    del r, k, v, logw, dy, dS, got, again, want
    torch.cuda.empty_cache()
    return {"name": "rwkv6_wkv_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu",
            "replaces": "port only: stands for the autodiff of the "
                        "jax.lax.scan at src/repro/models/rwkv6.py:97-111",
            "launches": 0, "max_abs_err": err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": None, "max_rel_err": out["rel"],
            "ms_of": f"bf16 at {out['shape']}"}


def d256_bwd_readings(dev, seed: int) -> dict:
    """(a) K3-bwd at head_dim 256 at D256_BWD_SHAPES through
    ``flash_attention``'s gradient (the d = 256 Hopper forward's lse, the
    d = 256 Hopper backward) against the plain backward, per row, twice;
    then the kernel, the mma.sync kernel, SDPA's backward (the window as a
    boolean mask, and causal without it) timed in turns at the path's
    shape, and the plain version. Returns the readings for the kernels
    line of the Hopper kernel and of the mma.sync kernel at 256."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    first = None
    for shape in D256_BWD_SHAPES:
        b, hq, hkv, sq, sk, d, causal, window, name = shape
        q, k, v = (_model_layout(x).requires_grad_(True)
                   for x in _qkv(dev, seed, b, hq, hkv, sq, sk, d,
                                 torch.bfloat16))
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        dout = torch.randn((b, hq, sq, d), generator=g, device=dev).to(
            torch.bfloat16)
        before = _bwd_counts()
        got = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        ran = _bwd_ran(before)
        again = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        want = fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        r = bwd_reading(got, again, want, name, ran,
                        bwd_kernel_for(name, d), shape)
        print(f"[rtrain] (a) K3-bwd {r['shape']} bf16: ran {r['kernel']} "
              f"(want {r['want_kernel']}); max |err| / max |want| "
              f"{r['rel']} (limit {BWD_TOL[name]}), per row {r['row']} "
              f"(limit {BWD_ROW_TOL[name]}), max abs {r['abs']:.4g}; a "
              f"second run the same bits {r['same_bits']}", flush=True)
        check(r["ok"], f"K3-bwd at head_dim 256 disagrees with its plain "
              f"version at {r['shape']}, gave other bits on a repeat, or "
              f"ran {r['kernel']}")
        first = first or r
        del q, k, v, dout, got, again, want
    b, hq, hkv, t, _, d, causal, window, _ = D256_BWD_SHAPES[0]
    q, k, v = (_model_layout(x) for x in _qkv(dev, seed, b, hq, hkv, t, t,
                                              d, torch.bfloat16))
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    dout = torch.randn((b, hq, t, d), generator=g, device=dev).to(
        torch.bfloat16)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
    o = fa.flash_attention_sm90_d256(q, k, v, causal=causal, window=window,
                                     lse=lse)
    qs, krs, vrs = (x.detach().clone().requires_grad_(True) for x in (
        q, k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv,
                                                                  1)))
    pos = torch.arange(t, device=dev)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    o_mask = F.scaled_dot_product_attention(qs, krs, vrs, attn_mask=mask)
    o_causal = F.scaled_dot_product_attention(qs, krs, vrs, is_causal=True)
    runs = {"kernel": (lambda: fa.flash_attention_bwd_sm90_d256(
                q, k, v, o, dout, lse, causal=causal, window=window), 10),
            "mma": (lambda: fa.flash_attention_bwd_mma(
                q, k, v, o, dout, lse, causal=causal, window=window), 3),
            "sdpa_window_mask": (lambda: torch.autograd.grad(
                o_mask, (qs, krs, vrs), dout, retain_graph=True), 3),
            "sdpa_causal": (lambda: torch.autograd.grad(
                o_causal, (qs, krs, vrs), dout, retain_graph=True), 10)}
    for fn, _ in runs.values():
        fn()                                               # warm-up
    t_ms = {n: [] for n in runs}
    for order in (("kernel", "mma", "sdpa_window_mask", "sdpa_causal"),
                  ("sdpa_causal", "sdpa_window_mask", "mma", "kernel")):
        for n in order:
            t_ms[n].append(queued_ms(*runs[n]))
    ms = {n: sum(x) / len(x) for n, x in t_ms.items()}
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, causal=causal, window=window), 1)
    bound, by = d256_bwd_bound(b, hq, hkv, t, d, window)
    print(f"[rtrain] (a) K3-bwd at {D256_BWD_SHAPES[0][:8]} bf16 "
          f"({window_pairs(t, window) * hq} kept pairs), in turns, device "
          f"alone: flash_attention_bwd_sm90_d256 {t_ms['kernel']} ms, "
          f"flash_attention_bwd_mma {t_ms['mma']} ms, SDPA's "
          f"backward with the window as a boolean mask "
          f"{t_ms['sdpa_window_mask']} ms, causal without the window "
          f"{t_ms['sdpa_causal']} ms (K and V repeated to the {hq} heads); "
          f"plain version {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}), "
          f"{bound / ms['kernel']:.1%} of it | {nvidia_smi_line()}",
          flush=True)
    check(bound <= ms["kernel"], "K3-bwd at head_dim 256 beat its bound")
    check(ms["kernel"] < ms["mma"] and ms["kernel"] < ms["sdpa_window_mask"],
          f"the Hopper K3-bwd at head_dim 256 ({ms['kernel']:.4f} ms) is not "
          f"faster than the mma.sync one ({ms['mma']:.4f}) and SDPA's masked "
          f"backward ({ms['sdpa_window_mask']:.4f})")
    del q, k, v, dout, lse, o, qs, krs, vrs, mask, o_mask, o_causal, runs
    torch.cuda.empty_cache()
    hopper = {
        "name": "flash_attention_bwd_sm90_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  "flash_attention_bwd_sm90_d256.cu",
        "replaces": None,
        "note": "port only: stands for the autodiff of "
                "src/repro/kernels/flash_attention/ref.py::attention_ref at "
                "head_dim 256",
        "launches": 0, "max_abs_err": first["abs"], "ms": ms["kernel"],
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": ms["sdpa_window_mask"],
        "library": "scaled_dot_product_attention's backward with the "
                   "window as a boolean attn_mask",
        "library_ms_causal_no_window": ms["sdpa_causal"],
        "mma_ms": ms["mma"], "max_rel_err": first["rel"],
        "row_rel_err": first["row"],
        "ms_of": f"bf16 at {D256_BWD_SHAPES[0][:8]}"}
    return hopper, {"name": "flash_attention_bwd_mma_d256", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": None,
            "note": "port only: stands for the autodiff of "
                    "src/repro/kernels/flash_attention/ref.py::attention_ref"
                    " at head_dim 256; the mma.sync K3-bwd's bf16 pairs of "
                    "warps (the same wrapper and launch count as "
                    "flash_attention_bwd_mma); off the main path since the "
                    "Hopper kernel at 256 (unaligned bf16 at 256 reaches it)",
            "launches": 0, "max_abs_err": None, "ms": ms["mma"],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": ms["sdpa_window_mask"],
            "library": "scaled_dot_product_attention's backward with the "
                       "window as a boolean attn_mask",
            "library_ms_causal_no_window": ms["sdpa_causal"],
            "ms_of": f"bf16 at {D256_BWD_SHAPES[0][:8]}"}


def d64_bwd_readings(dev, seed: int) -> dict:
    """(a) K3-bwd at head_dim 64 at WHISPER_BWD_SHAPES through
    ``flash_attention``'s gradient (the d = 64 Hopper forward's lse, the
    d = 64 Hopper backward) against the plain backward (the decoder's
    causal self-attention against the plain backward on float64 copies),
    per row, twice; then the kernel, the mma.sync kernel and SDPA's
    backward timed in turns on the device alone at each shape, and the
    plain version at the encoder's shape. Returns the Hopper kernel's
    reading for the kernels line, with every shape's times (the mma.sync
    kernel's among them)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    shapes = {}
    for shape, part in zip(WHISPER_BWD_SHAPES, ("encoder", "cross", "self")):
        b, hq, hkv, sq, sk, d, causal, window, name = shape
        q, k, v = (_model_layout(x).requires_grad_(True)
                   for x in _qkv(dev, seed, b, hq, hkv, sq, sk, d,
                                 torch.bfloat16))
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        dout = torch.randn((b, hq, sq, d), generator=g, device=dev).to(
            torch.bfloat16)
        before = _bwd_counts()
        got = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        ran = _bwd_ran(before)
        again = torch.autograd.grad(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        against = "the plain backward"
        if causal:                   # the decoder: float64 copies
            want = fa.flash_attention_bwd_plain(
                *(x.detach().double() for x in (q, k, v, dout)),
                causal=causal, window=window)
            against = "the plain backward in float64"
        else:
            want = fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                                window=window)
        torch.cuda.synchronize()
        r = bwd_reading(got, again, want, name, ran, bwd_kernel_for(name, d),
                        shape)
        print(f"[rtrain] (a) K3-bwd {part} {r['shape']} bf16: ran "
              f"{r['kernel']} (want {r['want_kernel']}); against {against}: "
              f"max |err| / max |want| {r['rel']} (limit {BWD_TOL[name]}), "
              f"per row {r['row']} (limit {BWD_ROW_TOL[name]}), max abs "
              f"{r['abs']:.4g}; a second run the same bits {r['same_bits']}",
              flush=True)
        check(r["ok"], f"K3-bwd at head_dim 64 disagrees with {against} at "
              f"{r['shape']}, gave other bits on a repeat, or ran "
              f"{r['kernel']}")
        del got, again, want
        qd, kd, vd = (x.detach() for x in (q, k, v))
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        o = fa.flash_attention_sm90_d64(qd, kd, vd, causal=causal, lse=lse)
        o_sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        runs = {"kernel": lambda: fa.flash_attention_bwd_sm90_d64(
                    qd, kd, vd, o, dout, lse, causal=causal),
                "mma": lambda: fa.flash_attention_bwd_mma(
                    qd, kd, vd, o, dout, lse, causal=causal),
                "sdpa": lambda: torch.autograd.grad(
                    o_sdpa, (q, k, v), dout, retain_graph=True)}
        for fn in runs.values():
            fn()                                           # warm-up
        t_ms = {n: [] for n in runs}
        for n in ("kernel", "mma", "sdpa", "sdpa", "mma", "kernel"):
            t_ms[n].append(queued_ms(runs[n], 10))
        ms = {n: sum(x) / len(x) for n, x in t_ms.items()}
        # the plain version timed at the kernels line's shape alone
        plain_ms = (cuda_ms(lambda: fa.flash_attention_bwd_plain(
            qd, kd, vd, dout, causal=causal), 1) if part == "encoder"
            else None)
        bound, by = bwd_bound_cross(b, hq, hkv, sq, sk, d, causal)
        print(f"[rtrain] (a) K3-bwd {part} {shape[:8]} bf16, in turns, device "
              f"alone: flash_attention_bwd_sm90_d64 {t_ms['kernel']} ms, "
              f"flash_attention_bwd_mma {t_ms['mma']} ms "
              f"({ms['mma'] / ms['kernel']:.2f}x the Hopper kernel's), SDPA's "
              f"backward {t_ms['sdpa']} ms (the Hopper kernel "
              f"{ms['kernel'] / ms['sdpa']:.3f}x of it); "
              + (f"plain version {plain_ms:.3f} ms; " if plain_ms else "")
              + f"bound {bound:.4f} ms ({by}), the Hopper "
              f"kernel at {bound / ms['kernel']:.1%} of it, mma.sync "
              f"{bound / ms['mma']:.1%} | {nvidia_smi_line()}", flush=True)
        check(bound <= ms["kernel"], "K3-bwd at head_dim 64 beat its bound")
        check(ms["kernel"] < ms["mma"], f"the Hopper K3-bwd at head_dim 64 "
              f"({ms['kernel']:.4f} ms) is not faster than the mma.sync one "
              f"({ms['mma']:.4f}) at the {part} shape")
        shapes[part] = {"shape": shape[:8], "ms": ms["kernel"],
                        "turns": t_ms["kernel"], "mma_ms": ms["mma"],
                        "mma_turns": t_ms["mma"], "library_ms": ms["sdpa"],
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "max_abs_err": r["abs"],
                        "max_rel_err": r["rel"], "row_rel_err": r["row"],
                        "against": against}
        del q, k, v, qd, kd, vd, dout, lse, o, o_sdpa, runs
        torch.cuda.empty_cache()
    enc = shapes["encoder"]
    return {"name": "flash_attention_bwd_sm90_d64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": None,
            "note": "port only: stands for the autodiff of "
                    "src/repro/kernels/flash_attention/ref.py::attention_ref"
                    " at head_dim 64; the head_dim 64 instantiation of the "
                    "Hopper K3-bwd's template, software-pipelined",
            "launches": 0,
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "ms": enc["ms"], "plain_ms": enc["plain_ms"],
            "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
            "library_ms": enc["library_ms"],
            "library": "scaled_dot_product_attention's backward",
            "ms_of": f"bf16 at {enc['shape']}", "whisper": shapes}


def held_step1(model, batch, tag: str, hold: bool) -> dict:
    """Step 1's loss and every gradient through the kernels against the
    same with ``plain_recurrent``; checked against ADAMW_LOSS_TOL and
    ADAMW_GRAD_TOL where ``hold``, printed either way."""
    import torch
    counted = rtrain_counted()
    before = _counts(counted)
    t0 = time.perf_counter()
    loss_k, g_k = _loss_grads(model, batch)
    moved = _moved(before, _counts(counted))
    t1 = time.perf_counter()
    with plain_recurrent():
        loss_p, g_p = _loss_grads(model, batch)
    t2 = time.perf_counter()
    rel = {n: rel_max(g_k[n], g_p[n]) for n in g_k}
    zero = [n for n in g_k if float(g_k[n].abs().max()) == 0.0]
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{tag} step 1 through the kernels: loss {loss_k:.6f}, with every "
          f"plain version {loss_p:.6f} (relative {loss_rel:.3g}, limit "
          f"{ADAMW_LOSS_TOL}); gradients, max |diff| / max |plain| per "
          f"tensor: worst {worst} {rel[worst]:.4g} (limit {ADAMW_GRAD_TOL}), "
          f"median {sorted(rel.values())[len(rel) // 2]:.4g}; zero gradients "
          f"{zero}; {'held' if hold else 'read, not held'}; launches "
          f"{moved}; walls {t1 - t0:.2f} s, the plain run {t2 - t1:.2f} s",
          flush=True)
    if hold:
        check(loss_rel <= ADAMW_LOSS_TOL and rel[worst] <= ADAMW_GRAD_TOL
              and not zero and all(bool(torch.isfinite(g).all())
                                   for g in g_k.values()),
              f"{tag} step 1 through the kernels disagrees with the plain "
              "versions', or a gradient is zero")
    del g_k, g_p
    torch.cuda.empty_cache()
    return {"loss": loss_k, "plain_loss": loss_p, "loss_rel": loss_rel,
            "worst": worst, "worst_rel": rel[worst], "launches": moved}


def timed_adamw(model, batches, tag: str) -> dict:
    """AdamW through make_train_step (remat) over ``batches``: each step's
    wall and launches (forward and backward apart), the peak over the
    parameter bytes, no plain version called."""
    import torch
    from repro_torch.train import steps as steps_mod
    counted = rtrain_counted()
    step = steps_mod.make_train_step(model, optimizer="adamw", remat=True)
    state = steps_mod.init_opt_state(model)
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, launches, plain = [], [], [], {}
    with plain_calls(plain):
        for batch in batches:
            before = _counts(counted)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(_moved(before, _counts(counted)))
            losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} AdamW, {len(batches)} steps, remat: wall per step "
          f"{[round(w, 4) for w in walls]} s, losses {losses}; launches a "
          f"step {launches[-1]}; peak device memory {peak} B = "
          f"{peak / par_bytes:.3f} x the parameter bytes {par_bytes}; plain "
          f"versions called {plain} | {nvidia_smi_line()}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"{tag} AdamW's loss is "
          "not finite")
    check(not plain, f"{tag} the AdamW steps called a plain version: "
          f"{plain}")
    del step, state
    torch.cuda.empty_cache()
    return {"walls": walls, "losses": losses, "launches": launches[-1],
            "peak": peak, "par_bytes": par_bytes}


def abo_zo_step(model, batch, tag: str) -> dict:
    """One ABO-ZO step on the whole model: the loss at or below the
    incumbent; peak memory against what was allocated before (the
    parameters, the batch), one probe buffer of the parameters' bytes and
    one forward's own peak (measured first, no grad)."""
    import numpy as np
    import torch
    from repro_torch.train import abo_zo
    from repro_torch.train import steps as steps_mod
    counted = rtrain_counted()
    model.requires_grad_(False)
    par_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()          # the parameters and batch
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model.loss(batch)
    torch.cuda.synchronize()
    fwd_extra = torch.cuda.max_memory_allocated() - base
    step = steps_mod.make_train_step(model, optimizer="abo_zo", remat=True)
    state = steps_mod.init_opt_state(model, "abo_zo")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = _counts(counted)
    t0 = time.perf_counter()
    state, met = step(state, batch, abo_zo.fold_in(abo_zo.prng_key(1), 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = _moved(before, _counts(counted))
    peak = torch.cuda.max_memory_allocated()
    limit = base + par_bytes + 1.1 * fwd_extra + 64 * 2**20
    loss, inc = float(met["loss"]), float(met["incumbent"])
    print(f"{tag} ABO-ZO, one step of {met['fe']} forwards: wall {wall:.3f} "
          f"s, incumbent {inc:.6f}, loss {loss:.6f} (candidate "
          f"{met['best']}); launches {moved}; peak {peak} B = "
          f"{peak / par_bytes:.3f} x the parameter bytes (limit: what was "
          f"allocated before, {base} B, the probe buffer's parameter bytes "
          f"and 1.1 x one forward's own peak {fwd_extra} B, = "
          f"{limit / par_bytes:.3f} x)", flush=True)
    check(math.isfinite(loss) and np.float32(loss) <= np.float32(inc)
          and peak <= limit, f"{tag} ABO-ZO's loss is not finite or above "
          f"its incumbent, or its peak {peak} exceeds {limit}")
    del step, state
    torch.cuda.empty_cache()
    return {"wall": wall, "loss": loss, "incumbent": inc, "peak": peak,
            "par_bytes": par_bytes, "launches": moved}


def rtrain_phase(dev, seed: int) -> list[dict]:
    """Phase 24 (see RTRAIN_T). Returns S-bwd's, W-bwd's and the Hopper
    K3-bwd at head_dim 256's and 64's entries of the kernels line, their
    launches those of one AdamW step at full width, and the mma.sync
    K3-bwd at 256's (off the path, no launch)."""
    import dataclasses
    import io

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import BigramStream, StreamConfig
    from repro_torch.models.model import Model

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    s_entry = s_bwd_readings(dev, seed)
    w_entry = w_bwd_readings(dev, seed)
    k_entry, mma_d256 = d256_bwd_readings(dev, seed)
    d64_entry = d64_bwd_readings(dev, seed)
    print(f"[rtrain] (a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    steps = {}
    for arch in RTRAIN_ARCHS:
        t_arch = time.perf_counter()
        tag = f"[rtrain] (b) {arch}"
        cfg = ARCHS[arch]
        stream = BigramStream(StreamConfig(
            vocab_size=cfg.vocab_size, seq_len=RTRAIN_T, global_batch=1))
        batches = [{"tokens": stream.torch_batch(s, dev)}
                   for s in range(RTRAIN_STEPS)]
        if arch == "rwkv6-3b":          # float32 held, bf16 read
            for dtype in ("float32", "bfloat16"):
                cut = dataclasses.replace(cfg, dtype=dtype,
                                          n_layers=RWKV_HOLD_LAYERS)
                model = Model(cut, device=dev).init(seed).requires_grad_(True)
                held_step1(model, batches[0], f"{tag} {dtype} cut to "
                           f"{RWKV_HOLD_LAYERS} of {cfg.n_layers} layers",
                           dtype == "float32")
                del model
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = Model(cfg, device=dev).init(seed).requires_grad_(True)
        torch.cuda.synchronize()
        n_par = sum(p.numel() for p in model.parameters())
        print(f"{tag}: {n_par} parameters at full width, {cfg.n_layers} "
              f"layers, bf16, drawn in {time.perf_counter() - t0:.2f} s; 1 x "
              f"{RTRAIN_T} tokens a step", flush=True)
        if arch != "rwkv6-3b":
            held_step1(model, batches[0], f"{tag} bf16", True)
        steps[arch] = timed_adamw(model, batches, tag)
        kinds = [cfg.mixer_kind(i) for i in range(cfg.n_layers)]
        bwd = steps[arch]["launches"]["backward"]
        want = ({"rglru_lru_bwd": kinds.count("rglru"),
                 "flash_attention_bwd": kinds.count("swa"),
                 "flash_attention_bwd_sm90_d256": kinds.count("swa")}
                if arch == "recurrentgemma-2b" else
                {"rwkv6_wkv_bwd": kinds.count("rwkv6")})
        check(bwd == want, f"{tag}: an AdamW step's backward launched {bwd}, "
              f"want {want}")
        abo = abo_zo_step(model, batches[0], f"[rtrain] (c) {arch}")
        steps[arch]["abo"] = abo
        del model
        torch.cuda.empty_cache()
        print(f"{tag} and (c) took {time.perf_counter() - t_arch:.1f} s",
              flush=True)

    # (e) the launcher, as a user trains: AdamW on recurrentgemma-2b and
    # ABO-ZO on rwkv6-3b, RTRAIN_STEPS steps of 1 x RTRAIN_T tokens each
    from repro_torch.launch import train as train_launch
    for arch, opt in zip(RTRAIN_ARCHS, ("adamw", "abo_zo")):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            final = train_launch.main([
                "--arch", arch, "--optimizer", opt, "--steps",
                str(RTRAIN_STEPS), "--seq-len", str(RTRAIN_T), "--batch", "1",
                "--log-every", "1"])
        torch.cuda.empty_cache()
        lines = [ln for ln in out.getvalue().splitlines() if "step" in ln]
        print(f"[rtrain] (e) launch.train --arch {arch} --optimizer {opt} "
              f"--steps {RTRAIN_STEPS} --seq-len {RTRAIN_T} --batch 1: "
              f"final loss {final:.6f} in {time.perf_counter() - t0:.1f} s; "
              f"{lines}", flush=True)
        check(math.isfinite(final), f"the launcher's {opt} run on {arch} "
              "ended with a loss that is not finite")

    # (d) whisper-small
    cfg = ARCHS[WHISPER_ARCH]
    model = Model(cfg, device=dev).init(seed).requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wb = []
    for _ in range(RTRAIN_STEPS):
        wb.append({"tokens": torch.randint(0, cfg.vocab_size,
                                           (WHISPER_B, WHISPER_T + 1),
                                           generator=gen, device=dev),
                   "frames": torch.randn((WHISPER_B, cfg.encoder_len,
                                          cfg.d_model), generator=gen,
                                         device=dev).to(cfg.param_dtype)})
    tag = f"[rtrain] (d) {WHISPER_ARCH}"
    print(f"{tag}: {WHISPER_B} x {WHISPER_T} tokens over {WHISPER_B} x "
          f"{cfg.encoder_len} stub frames a step", flush=True)
    held_step1(model, wb[0], tag, True)
    wsteps = timed_adamw(model, wb, tag)
    n_k3 = cfg.encoder_layers + 2 * cfg.n_layers
    bwd = wsteps["launches"]["backward"]
    check(bwd == {"flash_attention_bwd": n_k3,
                  "flash_attention_bwd_sm90_d64": n_k3},
          f"{tag}: an AdamW step's backward launched {bwd}, want {n_k3} of "
          "the Hopper K3-bwd at head_dim 64 and no other")
    abo_zo_step(model, wb[0], f"[rtrain] (c) {WHISPER_ARCH}")
    del model
    torch.cuda.empty_cache()

    total_s = time.perf_counter() - t_phase
    print(f"[rtrain] phase took {total_s:.1f} s (limit {RTRAIN_PHASE_S} s)",
          flush=True)
    check(total_s <= RTRAIN_PHASE_S, f"the recurrent training phase took "
          f"{total_s:.1f} s")
    rg, rw = steps["recurrentgemma-2b"], steps["rwkv6-3b"]
    s_entry["launches"] = rg["launches"]["backward"]["rglru_lru_bwd"]
    w_entry["launches"] = rw["launches"]["backward"]["rwkv6_wkv_bwd"]
    k_entry["launches"] = rg["launches"]["backward"][
        "flash_attention_bwd_sm90_d256"]
    d64_entry["launches"] = bwd["flash_attention_bwd_sm90_d64"]
    for e, arch in ((s_entry, "recurrentgemma-2b"), (w_entry, "rwkv6-3b"),
                    (k_entry, "recurrentgemma-2b")):
        e["launches_of"] = f"one AdamW step of {arch} at full width"
        e["step"] = {"arch": arch, "walls": steps[arch]["walls"],
                     "peak_over_params": steps[arch]["peak"]
                     / steps[arch]["par_bytes"]}
    d64_entry["launches_of"] = f"one AdamW step of {WHISPER_ARCH}"
    d64_entry["step"] = {"arch": WHISPER_ARCH, "walls": wsteps["walls"],
                         "peak_over_params": wsteps["peak"]
                         / wsteps["par_bytes"]}
    return [s_entry, w_entry, k_entry, d64_entry, mma_d256]


def sm_clock_max_hz() -> float:
    """The card's top SM clock, as nvidia-smi reads it, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return 1e6 * float(out.stdout.split()[0])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    import_port()
    from repro_torch.core import ABOConfig, abo_minimize
    from repro_torch.kernels import _build
    from repro_torch.kernels.coord_sweep.ops import (max_active_clusters,
                                                     sweep_pass)
    from repro_torch.kernels.coord_sweep.ref import (abo_minimize_kernel_ref,
                                                     sweep_pass_ref)
    from repro_torch.kernels.griewank.ops import (
        griewank_aggregates, griewank_shortcut_mismatches)
    from repro_torch.kernels.griewank.ref import griewank_aggregates_ref
    from repro_torch.objectives import GRIEWANK, SPHERE

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def uniform(n):
        return torch.rand(n, generator=gen, device=dev) * 1200.0 - 600.0

    # ---- 1. device -----------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)

    # ---- 2. build ------------------------------------------------------
    info = _build.build_all()
    print(f"[build] {len(info['built'])} kernels built in "
          f"{info['seconds']:.1f} s into {_build.build_dir()}", flush=True)
    for name, log in info["log"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = []

    # ---- 3. K2 against its plain version ---------------------------------
    # The kernel adds in the plain version's order, so it is held to its
    # bits (torch.equal), with the relative 1e-5 beside it; a ragged case
    # puts inf and NaN past n_valid, where the plain version selects zeros.
    k2_err = 0.0

    def k2_case(x, n_valid, what):
        before = griewank_aggregates.launches
        got = griewank_aggregates(x, n_valid)
        check(griewank_aggregates.launches == before + 1,
              "a griewank_aggregates call is not one launch")
        want = griewank_aggregates_ref(x, n_valid=n_valid)
        g, w = got[0, :3].double(), want[0, :3].double()
        err = (g - w).abs()
        rel = err / w.abs().clamp(min=1e-30)
        bits = bool(torch.equal(got, want))
        print(f"[K2] {what} n={x.numel()} n_valid={n_valid}: kernel "
              f"{g.tolist()} plain {w.tolist()} rel {rel.tolist()}, "
              f"bit-identical {bits}", flush=True)
        check(bool(rel[0] <= 1e-5) and bool(rel[1] <= 1e-5)
              and bool(err[2] <= max(1.0, 1e-5 * float(w[2].abs()))),
              f"K2 disagrees with its plain version at n={x.numel()}")
        check(bits and bool(torch.isfinite(got).all()),
              f"K2 is not its plain version's bits at n={x.numel()}, "
              f"n_valid={n_valid}")
        return float(err.max())

    for n in (3 * 4096 + 5, MAIN_N + 17):
        x = uniform(n)
        for n_valid in (n, n - 3):
            k2_err = max(k2_err, k2_case(x, n_valid, "uniform"))
        if n < MAIN_N:
            xr = x.clone()
            xr[n - 7:n - 4] = torch.tensor([math.inf, math.nan, -math.inf],
                                           device=dev)
            k2_err = max(k2_err, k2_case(xr, n - 7, "inf/NaN past n_valid"))
    check(torch.equal(griewank_aggregates(x), griewank_aggregates(x)),
          "K2 gave other bits on a repeat")
    t0 = time.perf_counter()
    mismatches = griewank_shortcut_mismatches(dev)
    print(f"[K2] shortcuts against the library calls they replace, inputs "
          f"that differ over each whole domain: {mismatches} "
          f"({time.perf_counter() - t0:.2f} s) | {smi}", flush=True)
    check(not any(mismatches.values()),
          f"a K2 shortcut differs from its library call: {mismatches}")
    griewank_aggregates(x)                                   # warm-up
    k2_ms = cuda_ms(lambda: griewank_aggregates(x), 20)
    k2_plain_ms = cuda_ms(lambda: griewank_aggregates_ref(
        x, n_valid=x.numel()), 2)
    k2_bound, k2_by, k2_parts = k2_bound_ms(x)
    print(f"[K2] n={x.numel()}: kernel {k2_ms:.4f} ms (20 launches after a "
          f"warm-up), plain "
          f"{k2_plain_ms:.2f} ms, bound {k2_bound:.4f} ms ({k2_by}), "
          f"{k2_bound / k2_ms:.1%} of it; instructions a coordinate: "
          f"function {k2_parts['function_instructions_per_coordinate']:.2f},"
          f" build {k2_parts['build_instructions_per_coordinate']:.2f} | "
          f"{smi}", flush=True)
    print(f"[K2] bound parts: {k2_parts}", flush=True)
    check(k2_bound <= k2_ms, f"K2 took {k2_ms} ms, under its bound "
          f"{k2_bound} ms: the bound is not a floor")
    del x, xr

    # ---- 4. K1 against its plain version ---------------------------------
    # sweep_pass runs a cluster of 16 CTAs by default; cluster=1 is the
    # single-CTA kernel, and the two must give the same bits.
    print(f"[K1] clusters the card can hold at once for blocks of 4096: "
          f"{max_active_clusters(4096, 16)} of 16 CTAs, "
          f"{max_active_clusters(4096, 8)} of 8", flush=True)

    def k1_case(n_blocks, block, m, lam, is_first, timed=False):
        """One pass of the kernel (cluster of 16 and of 1) and of its plain
        version from the same start, compared; returns (max aggregate
        error, x identical share, C = 16 ms, C = 1 ms, plain ms)."""
        n = n_blocks * block - 17                 # padding coordinates
        x2d = uniform(n_blocks * block).view(n_blocks, block)
        aggs = griewank_aggregates_ref(x2d, n_valid=n)
        kw = dict(m=m, n_valid=n, half_width=37.5, lam=lam,
                  is_first=is_first)
        xk, x1, xr, out = x2d.clone(), x2d.clone(), x2d.clone(), {}
        ms = [cuda_ms(lambda: out.update(k=sweep_pass(xk, aggs, **kw)), 1)]
        ms1 = cuda_ms(lambda: out.update(k1=sweep_pass(x1, aggs, cluster=1,
                                                       **kw)), 1)
        if timed:   # in turns: C = 16, C = 1, C = 16 on the same start
            xt = x2d.clone()
            ms.append(cuda_ms(lambda: sweep_pass(xt, aggs, **kw), 1))
            check(torch.equal(xt, xk), "K1 gave other bits on a second run")
        plain_ms = cuda_ms(lambda: out.update(r=sweep_pass_ref(
            xr, aggs, lower=-600.0, upper=600.0, **kw)), 1)
        ak, a1, ar = out["k"][1], out["k1"][1], out["r"][1]
        bits = bool(torch.equal(xk, x1)) and bool(torch.equal(ak, a1))
        same = float((xk == xr).double().mean())
        a_in, dk = aggs[0, :3].double(), (ak - ar)[0, :3].double().abs()
        frozen = bool((xk.view(-1)[n:] == x2d.view(-1)[n:]).all())
        print(f"[K1] {n_blocks}x{block} m={m} lam={lam} first={is_first}: "
              f"cluster 16 vs 1 bit-identical (x and aggregates) {bits}; vs "
              f"plain: x identical {same:.6f}, aggs diff {dk.tolist()}, "
              f"padding frozen {frozen}; cluster 16 {ms} ms, cluster 1 "
              f"{ms1:.2f} ms, plain {plain_ms:.1f} ms", flush=True)
        check(bits, "K1 with a cluster of 16 differs from one CTA")
        check(same >= 0.999 and frozen
              and bool((dk <= 1e-3 * (1 + a_in.abs())).all()),
              "K1 disagrees with its plain version")
        return float(dk.max()), same, sum(ms) / len(ms), ms1, plain_ms

    k1_err, k1_same = 0.0, 1.0
    for lam, is_first in ((0.0, True), (0.5, False), (1.0, False)):
        err, same, *_ = k1_case(64, 4096, 50, lam, is_first)
        k1_err, k1_same = max(k1_err, err), min(k1_same, same)
    err, same, *_ = k1_case(16, 4097, 50, 0.5, False)   # not a 1024 multiple
    k1_err, k1_same = max(k1_err, err), min(k1_same, same)
    main_blocks = -(-MAIN_N // 4096)
    err, same, k1_ms, k1_ms1, k1_plain_ms = k1_case(main_blocks, 4096, 50,
                                                    0.5, False, timed=True)
    k1_err, k1_same = max(k1_err, err), min(k1_same, same)
    k1_bound, k1_by = bound_ms(8 * main_blocks * 4096 + 2 * 4 * 128,
                               K1_OPS_PER_PROBE * 50 * main_blocks * 4096)
    print(f"[K1] one pass at {main_blocks}x4096 m=50: cluster of 16 "
          f"{k1_ms:.1f} ms, one CTA {k1_ms1:.1f} ms ({k1_ms1 / k1_ms:.2f}x), "
          f"plain {k1_plain_ms:.1f} ms, bound {k1_bound:.3f} ms ({k1_by})",
          flush=True)
    check(k1_ms1 >= 5 * k1_ms, "K1 with a cluster of 16 is not 5x faster "
          "than one CTA")

    # ---- 5. main path, kernel route --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep_pass.launches = griewank_aggregates.launches = 0
    t0 = time.perf_counter()
    r = abo_minimize(GRIEWANK, MAIN_N, config=ABOConfig(use_kernel=True),
                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep_pass": sweep_pass.launches,
                "griewank_aggregates": griewank_aggregates.launches}
    peak = torch.cuda.max_memory_allocated()
    sol_bytes = 4 * MAIN_N
    print(f"[main/kernel] n={MAIN_N}: fun {r.fun!r} (one CTA a pass: "
          f"{ONE_CTA_MAIN_FUN!r}; equal {r.fun == ONE_CTA_MAIN_FUN}), wall "
          f"{wall:.2f} s, "
          f"{r.fe / wall:.4g} probes/s, {wall / 5:.2f} s per pass (wall/5), "
          f"launches {launches}, peak {peak} B = {peak / sol_bytes:.4f} x "
          f"solution bytes {sol_bytes}", flush=True)
    print(f"[main/kernel] history {r.history.tolist()}", flush=True)
    check(tuple(r.x.shape) == (MAIN_N,) and bool(torch.isfinite(r.x).all())
          and math.isfinite(r.fun), "kernel-route x or fun is not finite")
    check(launches == {"sweep_pass": 5, "griewank_aggregates": 2},
          f"kernel route launched {launches}, want 5 and 2")
    check(peak <= 1.25 * sol_bytes + 64 * 2**20,
          f"peak device memory {peak} > 1.25 x {sol_bytes} + 64 MiB")
    # Quality. The route carries float32 aggregates with no per-pass resync,
    # as the JAX package's kernel route does, and that algorithm itself
    # misses 1e-6 from n ~ 2e6 on (benchmarks/kernel_route_quality.py). So
    # at n it is held to the same route with the kernels' plain versions on
    # the card, from the same start: x identical on >= 99.9% of coordinates
    # and fun within a relative 1e-5 (measured at MAIN_N: all of x, the same
    # fun; at other n the trajectories can part at near-ties, e.g. 99.58% of
    # x at n = 2e6, benchmarks_torch/kernel_route_quality.py). At n = 1e6,
    # where the JAX package reaches 2.6e-8, it is held to the 1e-6 of
    # tests/test_abo.py.
    t0 = time.perf_counter()
    plain = abo_minimize_kernel_ref(MAIN_N, device=dev)
    same = float((plain.x == r.x).double().mean())
    print(f"[main/kernel] plain versions at n={MAIN_N}: fun {plain.fun!r}, "
          f"{time.perf_counter() - t0:.1f} s; x identical {same:.6f}",
          flush=True)
    check(same >= 0.999
          and abs(r.fun - plain.fun) <= 1e-5 * abs(plain.fun) + 1e-6,
          f"kernel-route fun {r.fun} (x identical {same}) disagrees with "
          f"its plain versions' {plain.fun}")
    del r, plain
    r = abo_minimize(GRIEWANK, 10**6, config=ABOConfig(use_kernel=True),
                     device=dev)
    print(f"[main/kernel] n=1000000: fun {r.fun!r}", flush=True)
    check(r.fun < 1e-6, f"kernel-route fun {r.fun} >= 1e-6 at n = 1e6")
    # the same route on a small input against the plain versions on the CPU
    small = ABOConfig(block_size=512, samples_per_pass=64, use_kernel=True)
    rk = abo_minimize(GRIEWANK, 4096, config=small, device=dev)
    rc = abo_minimize(GRIEWANK, 4096, config=small, device="cpu")
    same = float((rk.x.cpu() == rc.x).double().mean())
    print(f"[main/kernel] n=4096 card {rk.fun!r} cpu {rc.fun!r}, x identical "
          f"{same:.6f}", flush=True)
    check(abs(rk.fun - rc.fun) <= 1e-6 and same >= 0.999,
          "kernel route on the card disagrees with the plain route on the CPU")

    # ---- 6. plain tensor route ---------------------------------------------
    sweep_pass.launches = griewank_aggregates.launches = 0
    for obj in (GRIEWANK, SPHERE):
        t0 = time.perf_counter()
        r = abo_minimize(obj, PLAIN_N, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tol = PLAIN_TOL.get(obj.name, 1e-6)
        print(f"[main/plain] {obj.name} n={PLAIN_N}: fun {r.fun!r} "
              f"(limit {tol!r}), wall {wall:.2f} s, {r.fe / wall:.4g} "
              f"probes/s", flush=True)
        check(r.fun < tol, f"plain-route {obj.name} fun {r.fun} >= {tol}")
        check(bool(torch.isfinite(r.x).all()), "plain-route x not finite")
    print(f"[main/plain] kernel launches {sweep_pass.launches}, "
          f"{griewank_aggregates.launches} (the plain route has none)")
    del r, rk, rc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 7. the solve engine ----------------------------------------------
    uninterrupted = engine_phase(dev, args.seed)

    # ---- 8. float64 solves --------------------------------------------------
    f64_phase(dev)

    # ---- 9. kill, fsck and resume ------------------------------------------
    ckpt_phase(dev, uninterrupted)

    # ---- 10. the serving tier ---------------------------------------------
    http_phase(dev, uninterrupted)
    del uninterrupted

    # ---- 11-14. K3 and the LM serving path --------------------------------
    k3, mma_model, d256_err, d64_err = attention_phase(dev, args.seed)
    k3["launches"] = lm_phase(dev, args.seed)
    k3_mma = mma_path_phase(dev, args.seed)
    k3_mma.update(mma_model)

    # ---- 15. the LM training path -------------------------------------------
    train_kernels = train_phase(dev, args.seed)

    # ---- 16. the mixture-of-experts family ----------------------------------
    moe = moe_phase(dev, args.seed)

    # ---- 17. the hybrid family -----------------------------------------------
    scan, k3_d256 = hybrid_phase(dev, args.seed)
    k3_d256.update(d256_err)

    # ---- 18. RWKV6 ----------------------------------------------------------
    wkv = rwkv6_phase(dev, args.seed)

    # ---- 19. Nelder-Mead, the paper's baseline ------------------------------
    nm_phase(dev, args.seed)

    # ---- 20. the examples -----------------------------------------------------
    examples_phase()

    # ---- 21. whisper-small, the encoder-decoder -----------------------------
    whisper, k3_mma["whisper"] = whisper_phase(dev, args.seed)

    # ---- 22. qwen2-vl-7b: M-RoPE, the stubbed embeddings, the int8 cache --
    k3["qwen2_vl"].update(vlm_phase(dev, args.seed))

    # ---- 23. granite-20b, internlm2-20b, h2o-danube-3-4b ---------------------
    dense = dense_phase(dev, args.seed)

    # ---- 24. the recurrent families' and whisper-small's training -----------
    rtrain = rtrain_phase(dev, args.seed)

    foreign = sorted(m for m in sys.modules if m.split(".")[0]
                     in ("jax", "jaxlib", "repro", "benchmarks"))
    check(not foreign, f"the smoke imported {foreign[:5]}: JAX, the JAX "
          "package or its benchmarks")

    # ---- 25. kernels line ---------------------------------------------------
    # each kernel's MoE readings beside those of its first path: K3 and
    # K3-bwd at the MoE models' MHA layer shape, P over the whole olmoe;
    # K3's at the dense decoders' layer shapes and granite-20b's at
    # DENSE_LONG_T, K3-bwd's at granite-20b's AdamW shape
    bwd, _, perturb = train_kernels
    k3["dense"] = dense["k3"]
    bwd[DENSE_LONG_ARCH].update(dense["bwd"])
    k3["moe"] = {**moe["k3"], "launches": {
        **{f"{a} prefill step": n for a, n in moe["prefill_launches"].items()},
        f"{MOE_TRAIN_ARCH} {ABO_STEPS} ABO-ZO steps":
            moe["abo_launches"]["flash_attention_sm90"],
        f"{MOE_TRAIN_ARCH} {ADAMW_STEPS} AdamW steps at {ADAMW_LAYERS} "
        "layers": moe["adamw_launches"]["flash_attention_sm90"]}}
    bwd["moe"] = {**moe["bwd"], "launches": {
        f"{MOE_TRAIN_ARCH} {ADAMW_STEPS} AdamW steps at {ADAMW_LAYERS} "
        "layers": moe["adamw_launches"]["flash_attention_bwd_sm90"]}}
    perturb["moe"] = {**moe["p"], "launches": {
        f"{MOE_TRAIN_ARCH} {ABO_STEPS} ABO-ZO steps":
            moe["abo_launches"]["abo_zo_perturb"]}}
    kernels.append({
        "name": "sweep_pass", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sweep_pass.cu",
        "replaces": "src/repro/kernels/coord_sweep/kernel.py:123",
        "launches": launches["sweep_pass"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None,
        "max_abs_err_of": "aggregates", "x_identical": k1_same,
        "cluster": 16, "ms_one_cta": k1_ms1})
    kernels.append({
        "name": "griewank_aggregates", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/griewank_aggregates.cu",
        "replaces": "src/repro/kernels/griewank/kernel.py:48",
        "launches": launches["griewank_aggregates"], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
        "bound_by": k2_by, "library_ms": None})
    kernels.append(k3)
    kernels.append(k3_d256)
    enc = whisper["encoder"]
    kernels.append({
        "name": "flash_attention_sm90_d64", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90_d64.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": sum(whisper["launches"].values()),
        "max_abs_err": max(d64_err["abs"], *(whisper[w]["max_abs_err"]
                                             for w in ("encoder", "cross",
                                                       "self"))),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"],
        "ms_of": enc["shape"], "attn_shapes_row_rel_err": d64_err["row"],
        "whisper": whisper})
    kernels.append(k3_mma)
    d64_bwd = next(e for e in rtrain
                   if e["name"] == "flash_attention_bwd_sm90_d64")
    train_kernels[1]["whisper_d64"] = {
        part: {"shape": x["shape"], "ms": x["mma_ms"],
               "library_ms": x["library_ms"], "bound_ms": x["bound_ms"],
               "bound_by": x["bound_by"]}
        for part, x in d64_bwd["whisper"].items()}
    kernels.extend(train_kernels)
    kernels.append(scan)
    kernels.append(wkv)
    kernels.extend(rtrain)
    print(json.dumps({"kernels": kernels}))

    # ---- 26. result -------------------------------------------------------
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
