// K3-bwd for Hopper at head_dim 256: the gradient of K3 (flash attention),
// dQ, dK and dV, in bf16 with TMA loads and wgmma, laid out for
// recurrentgemma-2b's local attention (1 x 10 query heads over one kv head,
// T = 4096, causal, window 2048). Port only: the TPU package has no
// backward kernel (its gradient through attention is autodiff of
// src/repro/kernels/flash_attention/ref.py::attention_ref), so this stands
// for that autodiff on the training path. It serves what the forward sends
// to flash_attention_sm90_d256.cu (bf16, head_dim 256, 16-byte-aligned
// pointers and strides, O and dO too); flash_attention_bwd.cu serves
// float32 and unaligned bf16 at 256
// (kernels/flash_attention/ops.py::choose_bwd_kernel).
//
// What it computes: that of flash_attention_bwd_sm90.cu, whose header says
// why D = rowsum(P ∘ dP) in float32 from the same P and dP as dS: per
// (batch, query head), S = Q·Kᵀ · sm_scale under K3's masks, P = exp(S - L),
// dP = dO·Vᵀ, dS = P ∘ (dP - D) · sm_scale, dV = Pᵀ·dO, dK = dSᵀ·Q,
// dQ = dS·K, dK and dV summed over the query heads of a kv head. P and dS
// round to bf16 before their products; every sum is float32.
//
// What the head dim costs, and the design's answer:
//   * Registers. A 64-row x 256-column float32 accumulator is 128 registers
//     a thread of a warpgroup: dK and dV of 64 keys (or dQ of 64 rows)
//     cannot sit in one warpgroup under the 255 cap. So two consumer
//     warpgroups split the head dim: each holds dims [128 c, 128 c + 128)
//     of dK and dV (of dQ). S and dP are computed once, not twice: consumer
//     0 computes S (16 wgmma m64n64k16 over the 256 dims) and P, consumer
//     1 dP and, from 0's P, dS (and in the D sweep P ∘ dP). They exchange P
//     in float32 and dS as its bf16 A fragments through shared memory, each
//     in the accumulator's thread order (thread t of one warpgroup holds
//     the same elements as thread t of the other), ordered by two named
//     barriers a step: consumer 0 arrives on 1 when P is written and syncs
//     on 2 for dS; consumer 1 syncs on 1 and arrives on 2 when dS is
//     written. Each barrier also keeps a writer from overwriting what the
//     other has not read (P is read before 2's arrival, dS before the next
//     step's 1).
//   * Shared memory (one 64-row x 256-dim tile is 32 KB, four 64-dim boxes
//     of 128-byte swizzled rows): two resident tiles (K and V, or Q and dO),
//     two stages of two streamed tiles (Q and dO, or K and V), the
//     exchange (16 KB of P, 8 KB of dS) and the stages' rows of L and D:
//     ~218 KB of the 227.
//   * MQA, one kv head for 10 query heads: 64-key blocks give 64 dK/dV CTAs
//     for 132 SMs. So a kv head's query heads are split over `splits` CTAs
//     a key block (the wrapper's d256_bwd_plan: 2 at the path's shape, 5
//     heads each); each writes float32 partials of dK and dV, and a third
//     pass adds them in split order (16.8 MB at 2 splits). One split writes
//     bf16 straight away.
//   * Window: a key block sees the query blocks [k0, k0 + 64 + window) and
//     a query block the key blocks (q0 - window, q0 + 64); steps whose every
//     pair is masked are skipped, and only steps across a mask edge compute
//     the mask.
//
// Launches on the caller's stream; each output element is written by one
// thread and every sum runs in a fixed order (two runs give the same bits):
//   * dQ (first): one CTA per (batch·query head, 64 query rows), the longest
//     rows first; Q and dO resident, K and V of 64 keys through two stages,
//     two sweeps over the key blocks. Sweep 1: S, P, dP and each thread's
//     share of rowsum(P ∘ dP) in key order, added over the row's four
//     threads by two shuffles; each row's D and L · log2(e) go into (b·hq,
//     sq_pad) float32 scratch (sq_pad = sq rounded up to 64). Sweep 2: S,
//     P, dP, dS, and dQ += dS·K (m64n128k16, dS from registers, K MN-major),
//     each consumer its half of the dims.
//   * dK, dV: one CTA per (key block of 64, batch·kv head, split), key block
//     0 first; K and V resident, Q and dO of 64 rows with their rows' L and
//     D through two stages, over the split's query heads in order and, for
//     each, the query blocks that see the keys in order. Per step Sᵀ = K·Qᵀ
//     and dPᵀ = V·dOᵀ (m64n64k16, both K-major), then dV += Pᵀ·dO and dK +=
//     dSᵀ·Q (m64n128k16, Pᵀ and dSᵀ from registers, dO and Q MN-major), each
//     consumer its half of the dims.
//   * the partials' sum, where splits > 1: four dims a thread, the splits
//     in order, into the bf16 outputs.
//
// Bound on an H100 at the path's shape (1, 10/1, 4096, 256, causal, window
// 2048: 62,924,800 kept pairs): five products of 2·256 FLOP a kept pair,
// 1.61e11 FLOP, 0.163 ms at 989 TFLOP/s: operations (q, k, v, dO, L in
// and dQ, dK, dV out, 71 MB, take 0.021 ms; the partials add 16.8 MB
// written and read). This kernel computes nine products a
// pair (S and dP three times: the D sweep, dQ's sweep, dK/dV), 1.8x the
// floor. Not done yet (PERF.md has the measured time): overlapping one
// step's exponentials with the next step's products, and the D sweep
// without S and dP again.
#include "sm90.cuh"
#include "k3_bwd_sm90.cuh"

namespace {

constexpr int kB = 64;               // keys or rows of a block, a step, a CTA
constexpr int kPad = 64;             // sq_pad is a multiple of this
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kBox = 64 * 128;       // bytes of a 64-dim x 64-row box
constexpr int kTile = 4 * kBox;      // 64 rows x 256 dims
constexpr int kStages = 2;
constexpr int kStageOff = 2 * kTile;                    // resident tiles
constexpr int kXP = kStageOff + kStages * 2 * kTile;    // P, float32
constexpr int kXS = kXP + 32 * 128 * 4;                 // dS, bf16 pairs
constexpr int kRows = kXS + 16 * 128 * 4;               // L, D of a stage
constexpr int kBar = kRows + kStages * 2 * kB * 4;
constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;   // + align
constexpr int kBarP = 1, kBarDS = 2;                    // named barriers
constexpr float kLog2e = 1.4426950408889634f;

struct Geom {
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int hq, hkv, group;     // group = hq / hkv
  int sq, sk, sq_pad;
  int causal, window;     // window <= 0: no window
  int splits, per;        // a kv head's query heads: splits of per each
  float scale;            // sm_scale
  float scale_log2;       // sm_scale · log2(e)
};

// A 64-row x 128-column float32 accumulator of a consumer warpgroup, rows
// from row0 (warp w's rows r0 + 16 w + gr and + 8), into a bf16 view with
// row stride ss (columns from p); rows >= nrows are not written.
__device__ __forceinline__ void store_half(__nv_bfloat16* p, long long ss,
                                           const float (&acc)[64], int row0,
                                           int nrows, int tg) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (row0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(p + row0 * ss + col) =
          __floats2bfloat162_rn(acc[4 * nt], acc[4 * nt + 1]);
    if (row1 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(p + row1 * ss + col) =
          __floats2bfloat162_rn(acc[4 * nt + 2], acc[4 * nt + 3]);
  }
}

// The same half as float32 into a (rows, 256) partial (columns from p).
__device__ __forceinline__ void store_half_f32(float* p,
                                               const float (&acc)[64],
                                               int row0, int nrows, int tg) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (row0 < nrows)
      *reinterpret_cast<float2*>(p + row0 * 256 + col) =
          make_float2(acc[4 * nt], acc[4 * nt + 1]);
    if (row1 < nrows)
      *reinterpret_cast<float2*>(p + row1 * 256 + col) =
          make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
  }
}

// 64 x 64 (+)= A (64 x 256) · Bᵀ (256 x 64), both K-major tiles of four
// 64-dim boxes.
__device__ __forceinline__ void product_256(float (&acc)[32],
                                            const unsigned char* a,
                                            const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_ss_n64(acc, smem_desc(a + off, 16, 1024),
                 smem_desc(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// acc (64 x 128) += A (64 x 64, four fragments) · B (64 x 128), B the dims
// [128 c, 128 c + 128) of a tile read MN-major. Issued, not waited for.
__device__ __forceinline__ void product_half(float (&acc)[64],
                                             const uint32_t (&a)[4][4],
                                             const unsigned char* tile,
                                             int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, a[kk],
             smem_desc(tile + 2 * c * kBox + kk * 16 * 128, kBox, 1024));
}

// --------------------------------------------------------------------- dQ --
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_d256(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse, float* __restrict__ l2,
            float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
            Geom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kBar));
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s) { return smem + kStageOff + s * 2 * kTile; };
  auto v_tile = [&](int s) { return k_tile(s) + kTile; };
  float* xp = reinterpret_cast<float*>(smem + kXP);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kXS);

  const int bh = blockIdx.x;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;     // longest rows first
  int kb0, kb1;
  kv_range(g, q0, kB, kB, &kb0, &kb1);
  const int n = kb1 - kb0;                     // key blocks a sweep
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
      mbar_expect_tx(q_full, 2 * kTile);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tma_load(smem + j * kBox, &tq, q_full, 64 * j, q0, h, b);
        tma_load(smem + kTile + j * kBox, &tdo, q_full, 64 * j, q0, h, b);
      }
      for (int i = 0; i < 2 * n; ++i) {        // two sweeps
        const int s = i % kStages;
        const int k0 = (kb0 + i % n) * kB;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tma_load(k_tile(s) + j * kBox, &tk, full(s), 64 * j, k0, kvh, b);
          tma_load(v_tile(s) + j * kBox, &tv, full(s), 64 * j, k0, kvh, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;       // 0: S and P; 1: dP, dS, D. Dims [128 c, +128)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int row0 = q0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
    const int2 kr0 = keys_of_row(g, row0), kr1 = keys_of_row(g, row1);
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
        const int k0 = (kb0 + j) * kB;
        mbar_wait(full(s), (i / kStages) & 1);
        if (!all_masked(g, q0, kB, k0, kB)) {
          float acc[32];
          uint32_t sf[4][4];
          if (c == 0) {
            product_256(acc, smem, k_tile(s));          // S = Q·Kᵀ
            exp_masked<8, true>(acc, g.scale_log2, l20, l21, nullptr,
                                needs_mask(g, q0, kB, k0, kB), k0, kr0, kr1,
                                tg);
#pragma unroll
            for (int x = 0; x < 32; ++x) xp[x * 128 + wtid] = acc[x];
            named_arrive(kBarP);
            named_sync(kBarDS);
            if (sweep == 1) {
#pragma unroll
              for (int x = 0; x < 16; ++x) sf[x / 4][x % 4] = xs[x * 128 + wtid];
            }
          } else {
            product_256(acc, smem + kTile, v_tile(s));  // dP = dO·Vᵀ
            named_sync(kBarP);
            if (sweep == 0) {
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {          // D += P ∘ dP
                dl0 = fmaf(xp[(4 * nt + 0) * 128 + wtid], acc[4 * nt + 0], dl0);
                dl0 = fmaf(xp[(4 * nt + 1) * 128 + wtid], acc[4 * nt + 1], dl0);
                dl1 = fmaf(xp[(4 * nt + 2) * 128 + wtid], acc[4 * nt + 2], dl1);
                dl1 = fmaf(xp[(4 * nt + 3) * 128 + wtid], acc[4 * nt + 3], dl1);
              }
            } else {
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {  // dS = P ∘ (dP - D) · scale
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[4 * nt + e] = xp[(4 * nt + e) * 128 + wtid] *
                                    (acc[4 * nt + e] - (e < 2 ? dl0 : dl1)) *
                                    g.scale;
              }
              to_frags<8>(sf, acc);
#pragma unroll
              for (int x = 0; x < 16; ++x) xs[x * 128 + wtid] = sf[x / 4][x % 4];
            }
            named_arrive(kBarDS);
          }
          if (sweep == 1) {                     // dQ += dS·K, this half
            fence_acc(dqa);
            wgmma_fence();
            product_half(dqa, sf, k_tile(s), c);
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(dqa);
          }
        }
        mbar_arrive(empty(s));
      }
      if (sweep == 0) {
        const long long base = static_cast<long long>(bh) * g.sq_pad;
        if (c == 1) {
          // the row's four threads add their shares: the same bits in each
          dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
          dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
          dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
          dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
          if (tg == 0) {                      // rows past sq: zeros
            delta[base + row0] = dl0;
            delta[base + row1] = dl1;
          }
        } else if (tg == 0) {
          l2[base + row0] = l20;
          l2[base + row1] = l21;
        }
      }
    }
    store_half(dq + b * g.dq_sb + h * g.dq_sh + 128 * c, g.dq_ss, dqa, row0,
               g.sq, tg);
  }
}

// ----------------------------------------------------------------- dK, dV --
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_d256(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ l2, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              float* __restrict__ part, Geom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kBar));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto q_tile = [&](int s) { return smem + kStageOff + s * 2 * kTile; };
  auto do_tile = [&](int s) { return q_tile(s) + kTile; };
  auto l2_row = [&](int s) {
    return reinterpret_cast<float*>(smem + kRows + s * 2 * kB * 4);
  };
  auto dl_row = [&](int s) { return l2_row(s) + kB; };
  float* xp = reinterpret_cast<float*>(smem + kXP);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kXS);

  const int bkv = blockIdx.x / g.splits, z = blockIdx.x % g.splits;
  const int b = bkv / g.hkv, kvh = bkv % g.hkv;
  const int k0 = blockIdx.y * kB;              // key block 0 first
  const int h0 = kvh * g.group + z * g.per;    // the split's query heads
  const int nh = min(g.per, g.group - z * g.per);
  int qb0, qb1;
  q_range(g, k0, kB, kB, &qb0, &qb1);
  const int nq = qb1 - qb0;
  const int n = nh * nq;                       // steps: (head, q block)
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
      mbar_expect_tx(kv_full, 2 * kTile);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tma_load(smem + j * kBox, &tk, kv_full, 64 * j, k0, kvh, b);
        tma_load(smem + kTile + j * kBox, &tv, kv_full, 64 * j, k0, kvh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int h = h0 + i / nq;
        const int q0 = (qb0 + i % nq) * kB;
        const long long row = (static_cast<long long>(b) * g.hq + h) *
                                  g.sq_pad + q0;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile + 2 * kB * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tma_load(q_tile(s) + j * kBox, &tq, full(s), 64 * j, q0, h, b);
          tma_load(do_tile(s) + j * kBox, &tdo, full(s), 64 * j, q0, h, b);
        }
        bulk_load(l2_row(s), l2 + row, kB * 4, full(s));
        bulk_load(dl_row(s), delta + row, kB * 4, full(s));
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;       // 0: Sᵀ and Pᵀ; 1: dPᵀ, dSᵀ. Dims [128 c, +128)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int key0 = k0 + (wtid >> 5) * 16 + gr, key1 = key0 + 8;
    const int2 qr0 = rows_of_key(g, key0), qr1 = rows_of_key(g, key1);

    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int q0 = (qb0 + i % nq) * kB;
      mbar_wait(full(s), (i / kStages) & 1);
      if (!all_masked(g, q0, kB, k0, kB)) {
        const unsigned char* qs = q_tile(s);
        const unsigned char* dos = do_tile(s);
        float acc[32];
        uint32_t pf[4][4], sf[4][4];
        if (c == 0) {
          product_256(acc, smem, qs);                   // Sᵀ = K·Qᵀ
          // Pᵀ: rows are keys key0 / key1, columns query rows q0 + col
          exp_masked<8, false>(acc, g.scale_log2, 0.0f, 0.0f, l2_row(s),
                               needs_mask(g, q0, kB, k0, kB), q0, qr0, qr1,
                               tg);
#pragma unroll
          for (int x = 0; x < 32; ++x) xp[x * 128 + wtid] = acc[x];
          named_arrive(kBarP);
          to_frags<8>(pf, acc);
          named_sync(kBarDS);
#pragma unroll
          for (int x = 0; x < 16; ++x) sf[x / 4][x % 4] = xs[x * 128 + wtid];
        } else {
          product_256(acc, smem + kTile, dos);          // dPᵀ = V·dOᵀ
          named_sync(kBarP);
          const float* dls = dl_row(s);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {    // dSᵀ = Pᵀ ∘ (dPᵀ - D) · scale
            const float2 dl =
                *reinterpret_cast<const float2*>(dls + nt * 8 + 2 * tg);
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = xp[(4 * nt + e) * 128 + wtid];
              acc[4 * nt + e] = p[e] *
                                (acc[4 * nt + e] - ((e & 1) ? dl.y : dl.x)) *
                                g.scale;
            }
            pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
            pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          }
          to_frags<8>(sf, acc);
#pragma unroll
          for (int x = 0; x < 16; ++x) xs[x * 128 + wtid] = sf[x / 4][x % 4];
          named_arrive(kBarDS);
        }
        fence_acc(dva);
        fence_acc(dka);
        wgmma_fence();
        product_half(dva, pf, dos, c);                  // dV += Pᵀ·dO
        product_half(dka, sf, qs, c);                   // dK += dSᵀ·Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dva);
        fence_acc(dka);
      }
      mbar_arrive(empty(s));
    }

    if (g.splits == 1) {
      store_half(dk + b * g.dk_sb + kvh * g.dk_sh + 128 * c, g.dk_ss, dka,
                 key0, g.sk, tg);
      store_half(dv + b * g.dv_sb + kvh * g.dv_sh + 128 * c, g.dv_ss, dva,
                 key0, g.sk, tg);
    } else {
      const long long slab = static_cast<long long>(gridDim.x) * g.sk * 256;
      float* pk = part + (static_cast<long long>(z) * (gridDim.x / g.splits) +
                          bkv) * g.sk * 256 + 128 * c;
      store_half_f32(pk, dka, key0, g.sk, tg);
      store_half_f32(pk + slab, dva, key0, g.sk, tg);
    }
  }
}

// ------------------------------------------------------------ partials' sum --
// part: dK's partials (splits, b·hkv, sk, 256), then dV's; each output
// element the sum of its splits in order.
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
bwd_sum_d256(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, Geom g, int bkvs) {
  const long long quads = static_cast<long long>(bkvs) * g.sk * 64;
  const long long idx = static_cast<long long>(blockIdx.x) * kSumThreads +
                        threadIdx.x;
  if (idx >= 2 * quads) return;
  const int which = idx >= quads;              // 0: dK, 1: dV
  const long long r = idx - which * quads;
  const int c4 = static_cast<int>(r % 64);
  const long long kr = r / 64;                 // bkv · sk + key
  const int key = static_cast<int>(kr % g.sk);
  const int bkv = static_cast<int>(kr / g.sk);
  const long long slab = quads * 4;            // one split's floats
  const float* src = part + which * g.splits * slab + kr * 256 + 4 * c4;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int z = 1; z < g.splits; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(src + z * slab);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int b = bkv / g.hkv, kvh = bkv % g.hkv;
  __nv_bfloat16* dst =
      which ? dv + b * g.dv_sb + kvh * g.dv_sh + key * g.dv_ss
            : dk + b * g.dk_sb + kvh * g.dk_sh + key * g.dk_ss;
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + 4 * c4);
  d2[0] = __floats2bfloat162_rn(acc.x, acc.y);
  d2[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

}  // namespace

extern "C" {

// q (b, hq, sq, 256), k and v (b, hkv, sk, 256), dout (b, hq, sq, 256),
// all bf16, each with its (batch, head, sequence) strides in elements and
// the last dimension contiguous; the base pointers 16-byte aligned and the
// strides multiples of 8 elements; sq and sk > 0. dq, dk, dv shaped as q,
// k, v (any strides that keep 4-byte alignment, last dimension contiguous).
// lse: the forward's natural-log log-sum-exp of each row, contiguous (b,
// hq, sq) float32. scratch: 2 · b · hq · sq_pad float32, 16-byte aligned,
// sq_pad = sq rounded up to 64 (each row's L · log2(e), then its D). A kv
// head's hq / hkv query heads go in `splits` runs of `per` (the last one
// shorter); with splits > 1, part: 2 · splits · b · hkv · sk · 256 float32,
// 16-byte aligned, else unused. window <= 0: none. Returns 0 on success,
// the cudaError_t of the first launch that failed, or kEncodeError plus
// the CUresult of a failed tensor-map encoding; the wrapper checks shapes,
// types and alignment.
int flash_attention_bwd_sm90_d256_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* scratch, void* part, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int sk, int sq_pad,
    int splits, int per, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, int causal, int window, float scale,
    void* stream) {
  const int group = hq / hkv;
  if (sq_pad < sq || sq_pad % kPad != 0 || splits < 1 || per < 1 ||
      (splits - 1) * per >= group || splits * per < group ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // Runtime calls first: they make the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs (autograd runs the
  // backward on a thread of its own, where none may be current yet).
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dq_d256, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(
      bwd_dkdv_d256, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  CUtensorMap tq, tdo, tk, tv;
  int err = encode(&tq, q, batch, hq, sq, 256, q_sb, q_sh, q_ss, kB);
  if (err == 0)
    err = encode(&tdo, dout, batch, hq, sq, 256, do_sb, do_sh, do_ss, kB);
  if (err == 0) err = encode(&tk, k, batch, hkv, sk, 256, k_sb, k_sh, k_ss, kB);
  if (err == 0) err = encode(&tv, v, batch, hkv, sk, 256, v_sb, v_sh, v_ss, kB);
  if (err != 0) return err;
  const Geom g{dq_sb,  dq_sh,  dq_ss, dk_sb,  dk_sh, dk_ss,  dv_sb,
               dv_sh,  dv_ss,  hq,    hkv,    group, sq,     sk,
               sq_pad, causal, window, splits, per,  scale,  scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l2 = static_cast<float*>(scratch);
  float* delta = l2 + static_cast<long long>(batch) * hq * sq_pad;
  const dim3 grid_q(batch * hq, sq_pad / kB);
  bwd_dq_d256<<<grid_q, kThreads, kSmem, s>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), l2, delta,
      static_cast<__nv_bfloat16*>(dq), g);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid_kv(splits * batch * hkv, (sk + kB - 1) / kB);
  bwd_dkdv_d256<<<grid_kv, kThreads, kSmem, s>>>(
      tq, tdo, tk, tv, l2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(part), g);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess || splits == 1) return static_cast<int>(cerr);
  const long long threads = 2LL * batch * hkv * sk * 64;
  bwd_sum_d256<<<static_cast<unsigned>((threads + kSumThreads - 1) /
                                       kSumThreads),
                 kSumThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, batch * hkv);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
