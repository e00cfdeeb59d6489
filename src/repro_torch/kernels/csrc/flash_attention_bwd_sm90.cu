// K3-bwd for Hopper: the gradient of K3 (flash attention), dQ, dK and dV,
// in bf16 with TMA loads, rings of shared-memory stages and wgmma, for head
// dims 64, 120 and 128 (one template over the head dim, HD = 64 or 128).
// Port only: the TPU package has no backward kernel (its gradient through
// attention is autodiff of
// src/repro/kernels/flash_attention/ref.py::attention_ref), so this stands
// for that autodiff on the training path. It serves what the forward sends
// to flash_attention_sm90.cu (head_dim 120 or 128) and to
// flash_attention_sm90_d64.cu (head_dim 64): bf16, 16-byte-aligned pointers
// and strides, O and dO too; flash_attention_bwd.cu serves everything else
// but head_dim 256 (kernels/flash_attention/ops.py::choose_bwd_kernel).
//
// What it computes: that of flash_attention_bwd.cu. Per (batch, query
// head), with S = Q·Kᵀ · sm_scale under K3's masks (k < sk, causal q >= k,
// window q - k < window) and the forward's log-sum-exp L of each query row,
// P = exp(S - L) (0 where masked), dP = dO·Vᵀ, D = rowsum(P ∘ dP) in
// float32, dS = P ∘ (dP - D) · sm_scale:
//   dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K,
// dK and dV summed over the hq / hkv query heads that read a kv head. P and
// dS are rounded to bf16 before their products; every sum is float32. The
// exponent runs in base 2: exp2(s · sm_scale · log2(e) - L · log2(e)), by
// ex2.approx.ftz.
//
// D. Mathematically rowsum(P ∘ dP) = rowsum(dO ∘ O), but O here is the
// forward's output rounded to bf16, and that rounding (2^-9 of |O|) stays
// in D while dP - D, which every dS of the row multiplies, can be far
// smaller: where values share a large common part, D from the rounded O put
// dQ 19% off the float64 gradient at head_dim 128 (PERF.md). So D is the
// sum of the same float32 P and dP that dS is built from, and neither D nor
// what it cancels against passes through a bf16 rounding.
//
// Design, two launches on the caller's stream; each output element is
// written by one thread and every sum runs in a fixed order (two runs give
// the same bits):
//   * dQ (first), head dim 120 or 128: one CTA per (batch·query head, 128
//     query rows), the longest rows first; the forward's structure: Q and
//     dO resident, K and V tiles of 128 keys through a ring of kStagesQ
//     stages, two sweeps over the kv blocks the rows see. Sweep 1: S = Q·Kᵀ
//     and dP = dO·Vᵀ (m64n128k16 from shared memory), P, and each thread's
//     share of rowsum(P ∘ dP) in key order; the four threads of a row then
//     add their shares by two shuffles, and the row's D and L · log2(e) go
//     into (b·hq, sq_pad) float32 scratch (sq_pad = sq rounded up to 128,
//     zeros past sq) for the dK/dV pass. Sweep 2: S and dP again, dS,
//     dQ += dS·K (dS in registers, K MN-major). Five products a pair here,
//     four in dK/dV: nine, 1.8x the FLOP floor of five. With one writer an
//     element, the alternative to recomputing S and dP is a float32 dQ
//     partial for each kv block, summed in order afterwards (268 MB at the
//     AdamW shape).
//   * dQ, head dim 64 (whisper-small): one CTA per (batch·query head, 64
//     query rows), whose kv blocks of 64 keys the two consumer warpgroups
//     split in halves, each through a ring of its own; after sweep 1 the
//     halves' D are added in a fixed order through shared memory, after
//     sweep 2 their dQ. At whisper's 448 rows that is 48 x 7 CTAs, against
//     48 x 4 of 128 rows, the last half empty.
//   * dK, dV: one CTA per (batch·kv head, 128 keys), key block 0 first
//     (under causal masking the heaviest). Warpgroup 0 is the producer: one
//     thread issues every TMA load, setmaxnreg lowers its registers.
//     Warpgroups 1 and 2 are consumers, each owning 64 keys (wgmma's M).
//     K and V load once; 64-row tiles of Q and dO, with their rows' L and
//     D, stream through a ring of kStagesKV stages with full and empty
//     mbarriers, over the group's query heads in order and, for each, the
//     q blocks that see the keys in order. Per step four products and no
//     transposed copy: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n64k16, both operands
//     K-major in shared memory), dV += Pᵀ·dO and dK += dSᵀ·Q (m64nHDk16,
//     Pᵀ and dSᵀ converted in registers from the accumulator layout to the
//     bf16 A fragment, dO and Q read MN-major through the descriptor's
//     transpose). dK and dV stay in registers (HD/2 + HD/2 a thread).
//   * Head dim 64: every tile is one 64-dim box, the products with N = HD
//     are m64n64k16, and the halved accumulators (32 + 32 registers for dK
//     and dV) leave room to software-pipeline both passes: a step issues
//     its dP with the next step's S as one group, its exponentials run
//     while that group is on the tensor cores, and its dQ (dV, dK) products
//     run under the next step's wait. Every wgmma of a loop body is issued
//     on every pass (the last step is peeled), so that ptxas keeps the
//     products asynchronous; steps are not skipped, and a stage is freed a
//     step late, so the rings hold four stages.
//   * Masks: only a block that crosses a mask edge (needs_mask) compares
//     keys, each row against its own [lo, hi) bounds (keys_of_row,
//     rows_of_key); a block inside the masks takes a branch without a
//     compare. (A per-element test of every mask, predicated on every
//     block, cost more than the products at head dim 64.) Head dims 120
//     and 128 also skip the steps whose every pair is masked.
//   * TMA: 4-D tensor maps (d, s, h, b) over the caller's strided views,
//     128-byte swizzle. Rows past sq / sk and dims 120..127 at d = 120 come
//     from TMA's zero fill and the masks; nothing is padded in device
//     memory but the scratch.
//
// Bound on an H100 at the AdamW training shape (b = 8, 32 query / 8 kv
// heads, T = 512, d = 128, causal): operations. The five products of 2·d
// FLOP a kept (query, key) pair take 0.0435 ms at 989 TFLOP/s, this
// kernel's nine 0.078 ms; q, dO, dQ (b·hq·T·d each), k, v, dK, dV
// (b·hkv·T·d each) in bf16 and L are 135 MB, 0.0402 ms at 3.35 TB/s (O is
// not read: D comes from P ∘ dP). At whisper-small's
// encoder (4, 12/12, 1500 x 1500, 64, non-causal) operations: the five
// products 0.0699 ms, this kernel's nine 0.126, and its three exponentials
// a pair ~0.08 ms at the MUFU's 16 a clock an SM. What the design does
// about it: every tile is read by TMA, so that loads overlap the tensor
// cores, and each product is a wgmma; the two consumer warpgroups
// interleave on the tensor cores, and at 64 each overlaps its own
// exponentials with its next products. Not done yet (PERF.md has the
// measured time): ping-pong of the consumers, a split of MQA's group over
// CTAs at 128, and dQ without the recompute.
#include "sm90.cuh"
#include "k3_bwd_sm90.cuh"

#include <type_traits>

namespace {

constexpr int kBN = 128;             // keys a dK/dV CTA
constexpr int kBM = 64;              // query rows a dK/dV step
constexpr int kBMQ = 128;            // query rows a dQ CTA
constexpr int kPad = 128;            // sq_pad is a multiple of this
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kBox128 = 128 * 128;   // bytes of a 64-dim x 128-row box
constexpr int kBox64 = 64 * 128;     // bytes of a 64-dim x 64-row box
constexpr float kLog2e = 1.4426950408889634f;

// The shared memory of head dim HD (64 or 128): kNB boxes of 64 dims a row.
template <int HD>
struct Plan {
  static constexpr int kNB = HD / 64;
  static constexpr int kTile128 = kNB * kBox128;
  static constexpr int kTile64 = kNB * kBox64;
  // dK, dV: K and V, then the stages (Q, dO), then each stage's L and D
  static constexpr int kStagesKV = HD == 64 ? 4 : 3;
  static constexpr int kKVStage = 2 * kTile128;
  static constexpr int kKVRows = kKVStage + kStagesKV * 2 * kTile64;
  static constexpr int kKVBar = kKVRows + kStagesKV * 2 * kBM * 4;
  static constexpr int kKVSmem = kKVBar + 8 * (1 + 2 * kStagesKV) + 1024;
};

struct Geom {
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int hq, hkv, group;     // group = hq / hkv
  int sq, sk, d, sq_pad;
  int causal, window;     // window <= 0: no window
  float scale;            // sm_scale
  float scale_log2;       // sm_scale · log2(e)
};

// A 64-row x HD-column float32 accumulator of a consumer warpgroup, rows
// from row0 (warp w's rows r0 + 16 w + gr and + 8), into a (rows, d) bf16
// view with row stride ss; rows >= nrows and columns >= d are not written.
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, long long ss,
                                          const float (&acc)[HD / 2],
                                          int row0, int nrows, int d,
                                          int tg) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (col >= d) continue;
    if (row0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(p + row0 * ss + col) =
          __floats2bfloat162_rn(acc[4 * nt], acc[4 * nt + 1]);
    if (row1 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(p + row1 * ss + col) =
          __floats2bfloat162_rn(acc[4 * nt + 2], acc[4 * nt + 3]);
  }
}

// --------------------------------------------------------------------- dQ --
// The D sweep's end: the row's four threads add their shares of D (two
// shuffles; the same bits in each).
__device__ __forceinline__ void quad_sum(float& a, float& b) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
}

// Head dim 120 or 128.
constexpr int kStagesQ = 2;
constexpr int kTileQ = 2 * kBox128;          // 128 rows x 128 dims
constexpr int kQBar = 2 * kTileQ + kStagesQ * 2 * kTileQ;
constexpr int kQSmem = kQBar + 8 * (1 + 2 * kStagesQ) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,       // 128-row boxes
            const __grid_constant__ CUtensorMap tdo,      // 128-row boxes
            const __grid_constant__ CUtensorMap tk,       // 128-row boxes
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse, float* __restrict__ l2,
            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
            Geom g) {
  constexpr int kStages = kStagesQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kQBar));
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s) { return smem + 2 * kTileQ + s * 2 * kTileQ; };
  auto v_tile = [&](int s) { return k_tile(s) + kTileQ; };

  const int bh = blockIdx.x;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBMQ;   // longest rows first
  int kb0, kb1;
  kv_range(g, q0, kBMQ, kBN, &kb0, &kb1);
  const int n = kb1 - kb0;                     // kv blocks a sweep
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kTileQ);
      for (int j = 0; j < 2; ++j) {
        tma_load(smem + j * kBox128, &tq, q_full, 64 * j, q0, h, b);
        tma_load(smem + kTileQ + j * kBox128, &tdo, q_full, 64 * j, q0, h,
                 b);
      }
      for (int i = 0; i < 2 * n; ++i) {        // two sweeps
        const int s = i % kStages;
        const int k0 = (kb0 + i % n) * kBN;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTileQ);
        for (int j = 0; j < 2; ++j) {
          tma_load(k_tile(s) + j * kBox128, &tk, full(s), 64 * j, k0, kvh, b);
          tma_load(v_tile(s) + j * kBox128, &tv, full(s), 64 * j, k0, kvh, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                       // rows [qw0, qw0 + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const int row0 = qw0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
    const int2 kr0 = keys_of_row(g, row0), kr1 = keys_of_row(g, row1);
    const unsigned char* q_base = smem + cw * 64 * 128;
    const unsigned char* do_base = smem + kTileQ + cw * 64 * 128;
    const long long base = static_cast<long long>(bh) * g.sq_pad;
    const long long lbase = static_cast<long long>(bh) * g.sq;
    const float l20 = row0 < g.sq ? lse[lbase + row0] * kLog2e : 0.0f;
    const float l21 = row1 < g.sq ? lse[lbase + row1] * kLog2e : 0.0f;
    float dl0 = 0.0f, dl1 = 0.0f;              // D of rows row0, row1

    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int j = 0; j < n; ++j) {
        const int i = sweep * n + j;
        const int s = i % kStages;
        const int k0 = (kb0 + j) * kBN;
        mbar_wait(full(s), (i / kStages) & 1);
        if (!all_masked(g, qw0, 64, k0, kBN)) {
          const unsigned char* ks = k_tile(s);
          const unsigned char* vs = v_tile(s);
          float sc[64], dp[64];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {      // S = Q·Kᵀ
            const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
            wgmma_ss(sc, smem_desc(q_base + off, 16, 1024),
                     smem_desc(ks + off, 16, 1024), kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {      // dP = dO·Vᵀ
            const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
            wgmma_ss(dp, smem_desc(do_base + off, 16, 1024),
                     smem_desc(vs + off, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();                      // S is done
          fence_acc(sc);
          exp_masked<16, true>(sc, g.scale_log2, l20, l21, nullptr,
                               needs_mask(g, qw0, 64, k0, kBN), k0, kr0, kr1,
                               tg);
          wgmma_wait<0>();                      // dP is done
          fence_acc(dp);
          if (sweep == 0) {
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {   // D += P ∘ dP, key order
              dl0 = fmaf(sc[4 * nt + 0], dp[4 * nt + 0], dl0);
              dl0 = fmaf(sc[4 * nt + 1], dp[4 * nt + 1], dl0);
              dl1 = fmaf(sc[4 * nt + 2], dp[4 * nt + 2], dl1);
              dl1 = fmaf(sc[4 * nt + 3], dp[4 * nt + 3], dl1);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {   // dS = P ∘ (dP - D) · scale
#pragma unroll
              for (int e = 0; e < 4; ++e)
                dp[4 * nt + e] = sc[4 * nt + e] *
                                 (dp[4 * nt + e] - (e < 2 ? dl0 : dl1)) *
                                 g.scale;
            }
            uint32_t sf[8][4];
            to_frags<16>(sf, dp);
            fence_acc(dqa);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)      // dQ += dS·K, K MN-major
              wgmma_rs(dqa, sf[kk],
                       smem_desc(ks + kk * 16 * 128, kBox128, 1024));
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(dqa);
          }
        }
        mbar_arrive(empty(s));
      }
      if (sweep == 0) {
        quad_sum(dl0, dl1);
        if (tg == 0) {                          // rows past sq: zeros
          delta[base + row0] = dl0;
          delta[base + row1] = dl1;
          l2[base + row0] = l20;
          l2[base + row1] = l21;
        }
      }
    }
    store_acc<128>(dq + b * g.dq_sb + h * g.dq_sh, g.dq_ss, dqa, row0, g.sq,
                   g.d, tg);
  }
}

// Head dim 64: 64 query rows a CTA, whose kv blocks the two consumers split
// in halves, each through a ring of its own (an exchange through shared
// memory adds the halves' D, then their dQ, in a fixed order).
constexpr int kStages64 = 4;
constexpr int kRing64 = kStages64 * 2 * kBox64;       // one consumer's K, V
constexpr int kXQ64 = 2 * kBox64 + 2 * kRing64;        // dQ, 32 x 128 floats
constexpr int kXD64 = kXQ64 + 32 * 128 * 4;            // D, 2 x 64 floats
constexpr int kBar64 = kXD64 + 2 * 64 * 4;
constexpr int kQSmem64 = kBar64 + 8 * (1 + 4 * kStages64) + 1024;
constexpr int kBarD = 1, kBarDQ = 2;                   // named barriers

__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_d64(const __grid_constant__ CUtensorMap tq,        // 64-row boxes
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ lse, float* __restrict__ l2,
           float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
           Geom g) {
  constexpr int kStages = kStages64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kBar64));
  const uint32_t q_full = bars;
  auto full = [&](int c, int s) { return bars + 8 * (1 + c * kStages + s); };
  auto empty = [&](int c, int s) {
    return bars + 8 * (1 + (2 + c) * kStages + s);
  };
  auto k_tile = [&](int c, int s) {
    return smem + 2 * kBox64 + c * kRing64 + s * 2 * kBox64;
  };
  auto v_tile = [&](int c, int s) { return k_tile(c, s) + kBox64; };
  float* xq = reinterpret_cast<float*>(smem + kXQ64);
  float* xd = reinterpret_cast<float*>(smem + kXD64);

  const int bh = blockIdx.x;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;     // longest rows first
  int kb0, kb1;
  kv_range(g, q0, 64, 64, &kb0, &kb1);
  const int half = (kb1 - kb0 + 1) / 2;        // consumer 0's kv blocks
  const int nblk[2] = {half, kb1 - kb0 - half};
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2 * kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + 2 * kStages + s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kBox64);
      tma_load(smem, &tq, q_full, 0, q0, h, b);
      tma_load(smem + kBox64, &tdo, q_full, 0, q0, h, b);
      for (int t = 0; t < 2 * half; ++t) {     // both rings, two sweeps each
        for (int c = 0; c < 2; ++c) {
          if (t >= 2 * nblk[c]) continue;
          const int s = t % kStages;
          const int k0 = (kb0 + c * half + t % nblk[c]) * 64;
          mbar_wait(empty(c, s), ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(full(c, s), 2 * kBox64);
          tma_load(k_tile(c, s), &tk, full(c, s), 0, k0, kvh, b);
          tma_load(v_tile(c, s), &tv, full(c, s), 0, k0, kvh, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                        // kv blocks [kbc, kbc + n)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int r0 = (wtid >> 5) * 16 + gr;        // rows q0 + r0, + 8
    const int row0 = q0 + r0, row1 = row0 + 8;
    const int2 kr0 = keys_of_row(g, row0), kr1 = keys_of_row(g, row1);
    const int kbc = kb0 + c * half, n = nblk[c];
    const unsigned char* q_base = smem;
    const unsigned char* do_base = smem + kBox64;
    const long long lbase = static_cast<long long>(bh) * g.sq;
    const float l20 = row0 < g.sq ? lse[lbase + row0] * kLog2e : 0.0f;
    const float l21 = row1 < g.sq ? lse[lbase + row1] * kLog2e : 0.0f;
    float dl0 = 0.0f, dl1 = 0.0f;              // D of rows row0, row1

    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.0f;
    fence_acc(dqa);
    mbar_wait(q_full, 0);

    // Each sweep software-pipelined: a step issues its dP with the next
    // step's S as one group, and its exponentials run while that group is
    // on the tensor cores; its dQ product runs under the next step's wait.
    // Every wgmma of a loop body is issued on every pass (the last step is
    // peeled), so that ptxas keeps the products asynchronous. Steps are not
    // skipped (the masks zero what is masked); a stage is freed a step late.
    float sc0[32], sc1[32], dp[32];
    auto wait_full = [&](int i) {
      mbar_wait(full(c, i % kStages), (i / kStages) & 1);
    };
    auto issue_s = [&](int i, float (&sc)[32]) {
      const unsigned char* ks = k_tile(c, i % kStages);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)            // S = Q·Kᵀ
        wgmma_ss_n64(sc, smem_desc(q_base + kk * 32, 16, 1024),
                     smem_desc(ks + kk * 32, 16, 1024), kk > 0);
    };
    auto body = [&](auto second, auto next, int i0, int j, float (&sc)[32],
                    float (&scn)[32]) {
      const int i = i0 + j, s = i % kStages;
      if constexpr (decltype(next)::value) wait_full(i + 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)            // dP = dO·Vᵀ
        wgmma_ss_n64(dp, smem_desc(do_base + kk * 32, 16, 1024),
                     smem_desc(v_tile(c, s) + kk * 32, 16, 1024), kk > 0);
      if constexpr (decltype(next)::value) issue_s(i + 1, scn);
      wgmma_commit();
      wgmma_wait<1>();                          // S, the last dQ product
      fence_acc(sc);
      if (j > 0) mbar_arrive(empty(c, (i - 1) % kStages));
      const int k0 = (kbc + j) * 64;
      exp_masked<8, true>(sc, g.scale_log2, l20, l21, nullptr,
                          needs_mask(g, q0, 64, k0, 64), k0, kr0, kr1, tg);
      wgmma_wait<0>();                          // dP (and the next S)
      fence_acc(dp);
      if constexpr (!decltype(second)::value) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {        // D += P ∘ dP, key order
          dl0 = fmaf(sc[4 * nt + 0], dp[4 * nt + 0], dl0);
          dl0 = fmaf(sc[4 * nt + 1], dp[4 * nt + 1], dl0);
          dl1 = fmaf(sc[4 * nt + 2], dp[4 * nt + 2], dl1);
          dl1 = fmaf(sc[4 * nt + 3], dp[4 * nt + 3], dl1);
        }
      } else {
        uint32_t sf[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {        // dS = P ∘ (dP - D) · scale
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = sc[4 * nt + e] * (dp[4 * nt + e] - (e < 2 ? dl0 : dl1)) *
                    g.scale;
          sf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          sf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)          // dQ += dS·K, K MN-major
          wgmma_rs_n64(dqa, sf[kk],
                       smem_desc(k_tile(c, s) + kk * 16 * 128, kBox64, 1024));
        wgmma_commit();
      }
    };
    auto sweep = [&](auto second) {
      const int i0 = decltype(second)::value ? n : 0;
      if (n == 0) return;
      wait_full(i0);
      wgmma_fence();
      issue_s(i0, sc0);
      wgmma_commit();
      int j = 0;
      for (; j + 2 < n; j += 2) {
        body(second, std::true_type{}, i0, j, sc0, sc1);
        body(second, std::true_type{}, i0, j + 1, sc1, sc0);
      }
      if (j + 1 < n) {
        body(second, std::true_type{}, i0, j, sc0, sc1);
        body(second, std::false_type{}, i0, j + 1, sc1, sc0);
      } else {
        body(second, std::false_type{}, i0, j, sc0, sc1);
      }
      wgmma_wait<0>();
      mbar_arrive(empty(c, (i0 + n - 1) % kStages));
    };

    sweep(std::false_type{});
    quad_sum(dl0, dl1);                         // this consumer's keys
    if (tg == 0) {
      xd[c * 64 + r0] = dl0;
      xd[c * 64 + r0 + 8] = dl1;
    }
    named_sync(kBarD);
    dl0 = xd[r0] + xd[64 + r0];                 // both halves, in order
    dl1 = xd[r0 + 8] + xd[64 + r0 + 8];
    if (c == 0 && tg == 0) {                    // rows past sq: zeros
      const long long base = static_cast<long long>(bh) * g.sq_pad;
      delta[base + row0] = dl0;
      delta[base + row1] = dl1;
      l2[base + row0] = l20;
      l2[base + row1] = l21;
    }
    sweep(std::true_type{});
    fence_acc(dqa);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xq[i * 128 + wtid] = dqa[i];
    }
    named_sync(kBarDQ);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] += xq[i * 128 + wtid];
      store_acc<64>(dq + b * g.dq_sb + h * g.dq_sh, g.dq_ss, dqa, row0, g.sq,
                    g.d, tg);
    }
  }
}

// ----------------------------------------------------------------- dK, dV --
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,     // 64-row boxes
              const __grid_constant__ CUtensorMap tdo,    // 64-row boxes
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ l2, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              Geom g) {
  using P = Plan<HD>;
  constexpr int kStages = P::kStagesKV;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + P::kKVBar));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto q_tile = [&](int s) { return smem + P::kKVStage + s * 2 * P::kTile64; };
  auto do_tile = [&](int s) { return q_tile(s) + P::kTile64; };
  auto l2_row = [&](int s) {
    return reinterpret_cast<float*>(smem + P::kKVRows + s * 2 * kBM * 4);
  };
  auto dl_row = [&](int s) { return l2_row(s) + kBM; };

  const int bkv = blockIdx.x;
  const int b = bkv / g.hkv, kvh = bkv % g.hkv;
  const int k0 = blockIdx.y * kBN;            // key block 0 first
  int qb0, qb1;
  q_range(g, k0, kBN, kBM, &qb0, &qb1);
  const int nq = qb1 - qb0;
  const int n = g.group * nq;                 // steps: (head, q block)
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * P::kTile128);
#pragma unroll
      for (int j = 0; j < P::kNB; ++j) {
        tma_load(smem + j * kBox128, &tk, kv_full, 64 * j, k0, kvh, b);
        tma_load(smem + P::kTile128 + j * kBox128, &tv, kv_full, 64 * j, k0,
                 kvh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int h = kvh * g.group + i / nq;
        const int q0 = (qb0 + i % nq) * kBM;
        const long long row = (static_cast<long long>(b) * g.hq + h) *
                                  g.sq_pad + q0;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * P::kTile64 + 2 * kBM * 4);
#pragma unroll
        for (int j = 0; j < P::kNB; ++j) {
          tma_load(q_tile(s) + j * kBox64, &tq, full(s), 64 * j, q0, h, b);
          tma_load(do_tile(s) + j * kBox64, &tdo, full(s), 64 * j, q0, h, b);
        }
        bulk_load(l2_row(s), l2 + row, kBM * 4, full(s));
        bulk_load(dl_row(s), delta + row, kBM * 4, full(s));
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                    // keys [kw0, kw0 + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int kw0 = k0 + 64 * cw;
    const int key0 = kw0 + (wtid >> 5) * 16 + gr, key1 = key0 + 8;
    const int2 qr0 = rows_of_key(g, key0), qr1 = rows_of_key(g, key1);
    const unsigned char* k_base = smem + cw * 64 * 128;
    const unsigned char* v_base = smem + P::kTile128 + cw * 64 * 128;

    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.0f;

    mbar_wait(kv_full, 0);
    if constexpr (HD == 64) {
      // Software-pipelined as the dQ pass: a step issues its dPᵀ with the
      // next step's Sᵀ as one group, its exponentials run under that group,
      // and its dV and dK products under the next step's wait; the last
      // step is peeled; no step is skipped; a stage is freed a step late.
      float st0[32], st1[32], dpt[32];
      auto wait_full = [&](int i) {
        mbar_wait(full(i % kStages), (i / kStages) & 1);
      };
      auto issue_s = [&](int i, float (&st)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)          // Sᵀ = K·Qᵀ
          wgmma_ss_n64(st, smem_desc(k_base + kk * 32, 16, 1024),
                       smem_desc(q_tile(i % kStages) + kk * 32, 16, 1024),
                       kk > 0);
      };
      auto body = [&](auto next, int i, float (&st)[32], float (&stn)[32]) {
        const int s = i % kStages;
        if constexpr (decltype(next)::value) wait_full(i + 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)          // dPᵀ = V·dOᵀ
          wgmma_ss_n64(dpt, smem_desc(v_base + kk * 32, 16, 1024),
                       smem_desc(do_tile(s) + kk * 32, 16, 1024), kk > 0);
        if constexpr (decltype(next)::value) issue_s(i + 1, stn);
        wgmma_commit();
        wgmma_wait<1>();                        // Sᵀ, the last dV and dK
        fence_acc(st);
        if (i > 0) mbar_arrive(empty((i - 1) % kStages));
        const int q0 = (qb0 + i % nq) * kBM;
        // Pᵀ: rows are keys key0 / key1, columns query rows q0 + c
        exp_masked<8, false>(st, g.scale_log2, 0.0f, 0.0f, l2_row(s),
                             needs_mask(g, q0, kBM, kw0, 64), q0, qr0, qr1,
                             tg);
        uint32_t pf[4][4], sf[4][4];
        to_frags<8>(pf, st);
        wgmma_wait<0>();                        // dPᵀ (and the next Sᵀ)
        fence_acc(dpt);
        const float* dls = dl_row(s);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {        // dSᵀ = Pᵀ ∘ (dPᵀ - D) · scale
          const float2 dl =
              *reinterpret_cast<const float2*>(dls + nt * 8 + 2 * tg);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = st[4 * nt + e] *
                    (dpt[4 * nt + e] - ((e & 1) ? dl.y : dl.x)) * g.scale;
          sf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          sf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)          // dV += Pᵀ·dO, dO MN-major
          wgmma_rs_n64(dva, pf[kk],
                       smem_desc(do_tile(s) + kk * 16 * 128, kBox64, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)          // dK += dSᵀ·Q, Q MN-major
          wgmma_rs_n64(dka, sf[kk],
                       smem_desc(q_tile(s) + kk * 16 * 128, kBox64, 1024));
        wgmma_commit();
      };
      fence_acc(dva);
      fence_acc(dka);
      if (n > 0) {
        wait_full(0);
        wgmma_fence();
        issue_s(0, st0);
        wgmma_commit();
        int i = 0;
        for (; i + 2 < n; i += 2) {
          body(std::true_type{}, i, st0, st1);
          body(std::true_type{}, i + 1, st1, st0);
        }
        if (i + 1 < n) {
          body(std::true_type{}, i, st0, st1);
          body(std::false_type{}, i + 1, st1, st0);
        } else {
          body(std::false_type{}, i, st0, st1);
        }
        wgmma_wait<0>();
        mbar_arrive(empty((n - 1) % kStages));
      }
      fence_acc(dva);
      fence_acc(dka);
    } else {
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int q0 = (qb0 + i % nq) * kBM;
        mbar_wait(full(s), (i / kStages) & 1);
        if (!all_masked(g, q0, kBM, kw0, 64)) {
          const unsigned char* qs = q_tile(s);
          const unsigned char* dos = do_tile(s);
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {   // Sᵀ = K·Qᵀ over HD dims
            const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
            const int offq = (kk >> 2) * kBox64 + (kk & 3) * 32;
            wgmma_ss_n64(st, smem_desc(k_base + off, 16, 1024),
                         smem_desc(qs + offq, 16, 1024), kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {   // dPᵀ = V·dOᵀ
            const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
            const int offq = (kk >> 2) * kBox64 + (kk & 3) * 32;
            wgmma_ss_n64(dpt, smem_desc(v_base + off, 16, 1024),
                         smem_desc(dos + offq, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();                      // Sᵀ is done
          fence_acc(st);
          // Pᵀ: rows are keys key0 / key1, columns query rows q0 + c
          exp_masked<8, false>(st, g.scale_log2, 0.0f, 0.0f, l2_row(s),
                               needs_mask(g, q0, kBM, kw0, 64), q0, qr0, qr1,
                               tg);
          const float* dls = dl_row(s);
          uint32_t pf[4][4];
          to_frags<8>(pf, st);
          wgmma_wait<0>();                      // dPᵀ is done
          fence_acc(dpt);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {      // dSᵀ = Pᵀ ∘ (dPᵀ - D) · scale
            const float2 dl =
                *reinterpret_cast<const float2*>(dls + nt * 8 + 2 * tg);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * nt + e] = st[4 * nt + e] *
                                (dpt[4 * nt + e] - ((e & 1) ? dl.y : dl.x)) *
                                g.scale;
          }
          uint32_t sf[4][4];
          to_frags<8>(sf, dpt);
          fence_acc(dva);
          fence_acc(dka);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)        // dV += Pᵀ·dO, dO MN-major
            wgmma_rs(dva, pf[kk],
                            smem_desc(dos + kk * 16 * 128, kBox64, 1024));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)        // dK += dSᵀ·Q, Q MN-major
            wgmma_rs(dka, sf[kk],
                            smem_desc(qs + kk * 16 * 128, kBox64, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dva);
          fence_acc(dka);
        }
        mbar_arrive(empty(s));
      }

    }

    store_acc<HD>(dk + b * g.dk_sb + kvh * g.dk_sh, g.dk_ss, dka, key0, g.sk,
                  g.d, tg);
    store_acc<HD>(dv + b * g.dv_sb + kvh * g.dv_sh, g.dv_ss, dva, key0, g.sk,
                  g.d, tg);
  }
}

// The two launches at head dim HD (see flash_attention_bwd_sm90_launch).
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, float* scratch, void* dq, void* dk, void* dv,
           int batch, int sq, int sk, long long q_sb, long long q_sh,
           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, long long do_sb,
           long long do_sh, long long do_ss, const Geom& g,
           cudaStream_t s) {
  using P = Plan<HD>;
  // the dQ pass's rows and keys a box: 64 at head dim 64, else 128
  constexpr int kRowsQ = HD == 64 ? 64 : kBMQ;
  auto* dq_kernel = HD == 64 ? bwd_dq_d64 : bwd_dq_sm90;
  const int dq_smem = HD == 64 ? kQSmem64 : kQSmem;
  // Runtime calls first: they make the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs (autograd runs the
  // backward on a thread of its own, where none may be current yet).
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dkdv_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kKVSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  CUtensorMap tq64, tdo64, tqq, tdoq, tk, tv, tkq, tvq;
  int err = encode(&tq64, q, batch, g.hq, sq, g.d, q_sb, q_sh, q_ss, kBM);
  if (err == 0)
    err = encode(&tdo64, dout, batch, g.hq, sq, g.d, do_sb, do_sh, do_ss,
                 kBM);
  if (err == 0)
    err = encode(&tqq, q, batch, g.hq, sq, g.d, q_sb, q_sh, q_ss, kRowsQ);
  if (err == 0)
    err = encode(&tdoq, dout, batch, g.hq, sq, g.d, do_sb, do_sh, do_ss,
                 kRowsQ);
  if (err == 0)
    err = encode(&tk, k, batch, g.hkv, sk, g.d, k_sb, k_sh, k_ss, kBN);
  if (err == 0)
    err = encode(&tv, v, batch, g.hkv, sk, g.d, v_sb, v_sh, v_ss, kBN);
  if (err == 0)
    err = encode(&tkq, k, batch, g.hkv, sk, g.d, k_sb, k_sh, k_ss, kRowsQ);
  if (err == 0)
    err = encode(&tvq, v, batch, g.hkv, sk, g.d, v_sb, v_sh, v_ss, kRowsQ);
  if (err != 0) return err;
  float* l2 = scratch;
  float* delta = l2 + static_cast<long long>(batch) * g.hq * g.sq_pad;
  const dim3 grid_q(batch * g.hq, (sq + kRowsQ - 1) / kRowsQ);
  dq_kernel<<<grid_q, kThreads, dq_smem, s>>>(
      tqq, tdoq, tkq, tvq, static_cast<const float*>(lse), l2, delta,
      static_cast<__nv_bfloat16*>(dq), g);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid_kv(batch * g.hkv, (sk + kBN - 1) / kBN);
  bwd_dkdv_sm90<HD><<<grid_kv, kThreads, P::kKVSmem, s>>>(
      tq64, tdo64, tk, tv, l2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k and v (b, hkv, sk, d), dout (b, hq, sq, d), all
// bf16, each with its (batch, head, sequence) strides in elements and the
// last dimension contiguous; d is 64, 120 or 128; the base pointers of q,
// k, v, dout are 16-byte aligned and their strides multiples of 8
// elements; sq and sk > 0. dq, dk, dv shaped as q, k, v (any strides, last
// dimension contiguous). lse: the forward's natural-log log-sum-exp of each
// row, contiguous (b, hq, sq) float32. scratch: 2 · b · hq · sq_pad
// float32, 16-byte aligned, sq_pad = sq rounded up to 128 (each row's
// L · log2(e), then its D; written by the dQ pass). window <= 0: none.
// Returns 0 on success, the cudaError_t of the first launch that failed, or
// kEncodeError plus the CUresult of a failed tensor-map encoding; the
// wrapper checks shapes, types and alignment.
int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* scratch, void* dq, void* dk, void* dv, int batch,
    int hq, int hkv, int sq, int sk, int d, int sq_pad, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  if (sq_pad < sq || sq_pad % kPad != 0 ||
      !(d == 64 || d == 120 || d == 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{dq_sb, dq_sh, dq_ss, dk_sb,  dk_sh,  dk_ss,  dv_sb,
               dv_sh, dv_ss, hq,    hkv,    hq / hkv, sq, sk,
               d,     sq_pad, causal, window, scale, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l2 = static_cast<float*>(scratch);
  if (d == 64)
    return launch<64>(q, k, v, dout, lse, l2, dq, dk, dv, batch, sq, sk,
                      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                      do_sb, do_sh, do_ss, g, s);
  return launch<128>(q, k, v, dout, lse, l2, dq, dk, dv, batch, sq, sk, q_sb,
                     q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb,
                     do_sh, do_ss, g, s);
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
