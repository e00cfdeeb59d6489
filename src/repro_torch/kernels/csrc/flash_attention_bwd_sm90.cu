// K3-bwd for Hopper: the gradient of K3 (flash attention), dQ, dK and dV,
// in bf16 with TMA loads, rings of shared-memory stages and wgmma, for head
// dims 120 and 128. Port only: the TPU package has no backward kernel (its
// gradient through attention is autodiff of
// src/repro/kernels/flash_attention/ref.py::attention_ref), so this stands
// for that autodiff on the training path. It serves what the forward sends
// to flash_attention_sm90.cu (bf16, head_dim 120 or 128, 16-byte-aligned
// pointers and strides, O and dO too); flash_attention_bwd.cu serves
// everything else (kernels/flash_attention/ops.py::choose_bwd_kernel).
//
// What it computes: that of flash_attention_bwd.cu. Per (batch, query
// head), with S = Q·Kᵀ · sm_scale under K3's masks (k < sk, causal q >= k,
// window q - k < window) and the forward's log-sum-exp L of each query row,
// P = exp(S - L) (0 where masked), D = rowsum(dO ∘ O),
// dS = P ∘ (dO·Vᵀ - D) · sm_scale:
//   dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K,
// dK and dV summed over the hq / hkv query heads that read a kv head. P and
// dS are rounded to bf16 before their products; every sum is float32. The
// exponent runs in base 2: exp2(s · sm_scale · log2(e) - L · log2(e)).
//
// Design, three launches on the caller's stream; each output element is
// written by one thread and every sum runs in a fixed order (two runs give
// the same bits):
//   * prep: half a warp per query row (16-byte loads) writes D and
//     L · log2(e) into (b·hq, sq_pad) float32 scratch, sq_pad = sq rounded
//     up to 128, zeros past sq, so that each 64-row slice is one 256-byte
//     bulk copy.
//   * dK, dV: one CTA per (batch·kv head, 128 keys), key block 0 first
//     (under causal masking the heaviest). Warpgroup 0 is the producer: one
//     thread issues every TMA load, setmaxnreg lowers its registers.
//     Warpgroups 1 and 2 are consumers, each owning 64 keys (wgmma's M).
//     K and V load once; 64-row tiles of Q and dO, with their rows' L and
//     D, stream through a ring of kStagesKV stages with full and empty
//     mbarriers, over the group's query heads in order and, for each, the
//     q blocks that see the keys in order. Per step four products and no
//     transposed copy: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n64k16, both operands
//     K-major in shared memory), dV += Pᵀ·dO and dK += dSᵀ·Q (m64n128k16,
//     Pᵀ and dSᵀ converted in registers from the accumulator layout to the
//     bf16 A fragment, dO and Q read MN-major through the descriptor's
//     transpose). dK and dV stay in registers (64 + 64 a thread) to the end.
//   * dQ: one CTA per (batch·query head, 128 query rows), the longest rows
//     first; the forward's structure: Q and dO resident, K and V tiles of
//     128 keys through a ring of kStagesQ stages. S = Q·Kᵀ and dP = dO·Vᵀ
//     (m64n128k16 from shared memory), dQ += dS·K (dS in registers, K
//     MN-major). S and dP are recomputed here: seven products instead of
//     five, 1.4x the FLOP floor. With one writer an element, the
//     alternative is a float32 dQ partial for each kv block, summed in
//     order afterwards: 268 MB at the AdamW shape, 8.6 GB at T = 8192.
//   * TMA: 4-D tensor maps (d, s, h, b) over the caller's strided views,
//     128-byte swizzle. Rows past sq / sk and dims 120..127 at d = 120 come
//     from TMA's zero fill and the masks; nothing is padded in device
//     memory but the prep's scratch.
//   * Per consumer, steps whose every (row, key) is masked are skipped;
//     only steps that cross a mask edge compute the mask.
//
// Bound on an H100 at the AdamW training shape (b = 8, 32 query / 8 kv
// heads, T = 512, d = 128, causal): bytes. q, O, dO, dQ (b·hq·T·d each), k,
// v, dK, dV (b·hkv·T·d each) in bf16 and L are 168 MB, 0.0502 ms at 3.35
// TB/s; the five products of 2·d FLOP a kept (query, key) pair take
// 0.044 ms at 989 TFLOP/s, this kernel's seven 0.061 ms. What the design
// does about it: every tile is read by TMA, so that loads overlap the
// tensor cores, and each product is a wgmma; the two consumer warpgroups
// interleave on the tensor cores. Not done yet (PERF.md has the measured
// time): ping-pong of the consumers, a split of MQA's group over CTAs, and
// dQ without the recompute.
#include "sm90.cuh"

namespace {

constexpr int kBN = 128;             // keys a dK/dV CTA, keys a dQ step
constexpr int kBM = 64;              // query rows a dK/dV step
constexpr int kBMQ = 128;            // query rows a dQ CTA
constexpr int kPad = 128;            // sq_pad is a multiple of this
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kBox128 = 128 * 128;   // bytes of a 64-dim x 128-row box
constexpr int kBox64 = 64 * 128;     // bytes of a 64-dim x 64-row box
constexpr int kTile128 = 2 * kBox128;
constexpr int kTile64 = 2 * kBox64;
constexpr float kLog2e = 1.4426950408889634f;

// dK, dV: K and V, then the stages (Q, dO), then each stage's L and D
constexpr int kStagesKV = 3;
constexpr int kKVStage = 2 * kTile128;
constexpr int kKVRows = kKVStage + kStagesKV * 2 * kTile64;
constexpr int kKVBar = kKVRows + kStagesKV * 2 * kBM * 4;
constexpr int kKVSmem = kKVBar + 8 * (1 + 2 * kStagesKV) + 1024;   // + align
// dQ: Q and dO, then the stages (K, V)
constexpr int kStagesQ = 2;
constexpr int kQStage = 2 * kTile128;
constexpr int kQBar = kQStage + kStagesQ * 2 * kTile128;
constexpr int kQSmem = kQBar + 8 * (1 + 2 * kStagesQ) + 1024;

struct Geom {
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int hq, hkv, group;     // group = hq / hkv
  int sq, sk, d, sq_pad;
  int causal, window;     // window <= 0: no window
  float scale;            // sm_scale
  float scale_log2;       // sm_scale · log2(e)
};

// Whether query row `row` sees key `col`.
__device__ __forceinline__ bool key_ok(const Geom& g, int row, int col) {
  return row < g.sq && col < g.sk && (!g.causal || row >= col) &&
         (g.window <= 0 || row - col < g.window);
}

// Whether some (row, key) of the q block x kv block is masked.
__device__ __forceinline__ bool needs_mask(const Geom& g, int q0, int bm,
                                           int k0, int bn) {
  return q0 + bm > g.sq || k0 + bn > g.sk ||
         (g.causal && k0 + bn - 1 > q0) ||
         (g.window > 0 && (q0 + bm - 1) - k0 >= g.window);
}

// Whether every (row, key) of the q block x kv block is masked.
__device__ __forceinline__ bool all_masked(const Geom& g, int q0, int bm,
                                           int k0, int bn) {
  return k0 >= g.sk || q0 >= g.sq || (g.causal && k0 > q0 + bm - 1) ||
         (g.window > 0 && q0 - (k0 + bn - 1) >= g.window);
}

// The kv blocks [kb0, kb1) holding a key some row of [q0, q0 + bm) sees.
__device__ __forceinline__ void kv_range(const Geom& g, int q0, int bm,
                                         int bn, int* kb0, int* kb1) {
  int hi = g.sk;
  if (g.causal) hi = min(hi, q0 + bm);
  int lo = 0;
  if (g.window > 0) lo = max(0, q0 - g.window + 1);
  *kb0 = lo / bn;
  *kb1 = hi > lo ? (hi + bn - 1) / bn : *kb0;
}

// The q blocks [qb0, qb1) holding a row that sees some key of
// [k0, k0 + bn).
__device__ __forceinline__ void q_range(const Geom& g, int k0, int bn,
                                        int bm, int* qb0, int* qb1) {
  const int lo = g.causal ? k0 : 0;
  int hi = g.sq;
  if (g.window > 0) hi = min(hi, k0 + bn - 1 + g.window);
  *qb0 = lo / bm;
  *qb1 = hi > lo ? (hi + bm - 1) / bm : *qb0;
}

// Bytes [src, src + bytes) into shared memory at dst, completing on bar.
// 16-byte aligned addresses and a multiple of 16 bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An accumulator of 64 rows x 8·NT columns rounded to bf16 as the A operand
// of the next product (its 8·NT columns become that product's k).
template <int NT>
__device__ __forceinline__ void to_frags(uint32_t (&a)[NT / 2][4],
                                         const float (&c)[4 * NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(c[4 * nt + 0], c[4 * nt + 1]);
    a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(c[4 * nt + 2], c[4 * nt + 3]);
  }
}

// A 64-row x 128-column float32 accumulator of a consumer warpgroup, rows
// from r0 (warp w's rows r0 + 16 w + gr and + 8), into a (rows, d) bf16
// view with row stride ss; rows >= nrows and columns >= d are not written.
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, long long ss,
                                          const float (&acc)[64], int row0,
                                          int nrows, int d, int tg) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
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

// ------------------------------------------------------------------- prep --
constexpr int kPrepRows = 16;      // half a warp a row, 16 bytes a thread

__global__ void __launch_bounds__(16 * kPrepRows)
bwd_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ l2,
         float* __restrict__ delta, Geom g, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * kPrepRows +
                      threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  const int row = static_cast<int>(r % g.sq_pad);
  const long long bh = r / g.sq_pad;
  float acc = 0.0f;
  if (r < rows && row < g.sq && 8 * lane < g.d) {
    const int b = static_cast<int>(bh / g.hq), h = static_cast<int>(bh % g.hq);
    // 16-byte aligned: the wrapper sends O and dO with 16-byte strides
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * g.o_sb + h * g.o_sh + row * g.o_ss + 8 * lane);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * g.do_sb + h * g.do_sh + row * g.do_ss + 8 * lane);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]);
      const float2 df = __bfloat1622float2(dp[i]);
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane == 0) {
    delta[r] = row < g.sq ? acc : 0.0f;
    l2[r] = row < g.sq ? lse[bh * g.sq + row] * kLog2e : 0.0f;
  }
}

// ----------------------------------------------------------------- dK, dV --
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,     // 64-row boxes
              const __grid_constant__ CUtensorMap tdo,    // 64-row boxes
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ l2, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              Geom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kKVBar));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStagesKV + s); };
  auto q_tile = [&](int s) { return smem + kKVStage + s * 2 * kTile64; };
  auto do_tile = [&](int s) { return q_tile(s) + kTile64; };
  auto l2_row = [&](int s) {
    return reinterpret_cast<float*>(smem + kKVRows + s * 2 * kBM * 4);
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
    for (int s = 0; s < kStagesKV; ++s) {
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
      mbar_expect_tx(kv_full, 2 * kTile128);
      tma_load(smem, &tk, kv_full, 0, k0, kvh, b);
      tma_load(smem + kBox128, &tk, kv_full, 64, k0, kvh, b);
      tma_load(smem + kTile128, &tv, kv_full, 0, k0, kvh, b);
      tma_load(smem + kTile128 + kBox128, &tv, kv_full, 64, k0, kvh, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStagesKV;
        const int h = kvh * g.group + i / nq;
        const int q0 = (qb0 + i % nq) * kBM;
        const long long row = (static_cast<long long>(b) * g.hq + h) *
                                  g.sq_pad + q0;
        mbar_wait(empty(s), ((i / kStagesKV) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile64 + 2 * kBM * 4);
        tma_load(q_tile(s), &tq, full(s), 0, q0, h, b);
        tma_load(q_tile(s) + kBox64, &tq, full(s), 64, q0, h, b);
        tma_load(do_tile(s), &tdo, full(s), 0, q0, h, b);
        tma_load(do_tile(s) + kBox64, &tdo, full(s), 64, q0, h, b);
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
    const unsigned char* k_base = smem + cw * 64 * 128;
    const unsigned char* v_base = smem + kTile128 + cw * 64 * 128;

    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStagesKV;
      const int q0 = (qb0 + i % nq) * kBM;
      mbar_wait(full(s), (i / kStagesKV) & 1);
      if (!all_masked(g, q0, kBM, kw0, 64)) {
        const unsigned char* qs = q_tile(s);
        const unsigned char* dos = do_tile(s);
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {      // Sᵀ = K·Qᵀ over 128 dims
          const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
          const int offq = (kk >> 2) * kBox64 + (kk & 3) * 32;
          wgmma_ss_n64(st, smem_desc(k_base + off, 16, 1024),
                       smem_desc(qs + offq, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {      // dPᵀ = V·dOᵀ
          const int off = (kk >> 2) * kBox128 + (kk & 3) * 32;
          const int offq = (kk >> 2) * kBox64 + (kk & 3) * 32;
          wgmma_ss_n64(dpt, smem_desc(v_base + off, 16, 1024),
                       smem_desc(dos + offq, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();                      // Sᵀ is done
        fence_acc(st);
        // Pᵀ: rows are keys key0 / key1, columns query rows q0 + c
        const bool masked = needs_mask(g, q0, kBM, kw0, 64);
        const float* l2s = l2_row(s);
        const float* dls = dl_row(s);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 lv =
              *reinterpret_cast<const float2*>(l2s + nt * 8 + 2 * tg);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * tg + (e & 1);
            float p = exp2f(fmaf(st[4 * nt + e], g.scale_log2,
                                 -((e & 1) ? lv.y : lv.x)));
            if (masked && !key_ok(g, q0 + c, e < 2 ? key0 : key1)) p = 0.0f;
            st[4 * nt + e] = p;
          }
        }
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
          wgmma_rs(dva, pf[kk], smem_desc(dos + kk * 16 * 128, kBox64, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)        // dK += dSᵀ·Q, Q MN-major
          wgmma_rs(dka, sf[kk], smem_desc(qs + kk * 16 * 128, kBox64, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dva);
        fence_acc(dka);
      }
      mbar_arrive(empty(s));
    }

    store_acc(dk + b * g.dk_sb + kvh * g.dk_sh, g.dk_ss, dka, key0, g.sk,
              g.d, tg);
    store_acc(dv + b * g.dv_sb + kvh * g.dv_sh, g.dv_ss, dva, key0, g.sk,
              g.d, tg);
  }
}

// --------------------------------------------------------------------- dQ --
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,       // 128-row boxes
            const __grid_constant__ CUtensorMap tdo,      // 128-row boxes
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ l2, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, Geom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kQBar));
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStagesQ + s); };
  auto k_tile = [&](int s) { return smem + kQStage + s * 2 * kTile128; };
  auto v_tile = [&](int s) { return k_tile(s) + kTile128; };

  const int bh = blockIdx.x;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBMQ;   // longest rows first
  int kb0, kb1;
  kv_range(g, q0, kBMQ, kBN, &kb0, &kb1);
  const int n = kb1 - kb0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesQ; ++s) {
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
      mbar_expect_tx(q_full, 2 * kTile128);
      tma_load(smem, &tq, q_full, 0, q0, h, b);
      tma_load(smem + kBox128, &tq, q_full, 64, q0, h, b);
      tma_load(smem + kTile128, &tdo, q_full, 0, q0, h, b);
      tma_load(smem + kTile128 + kBox128, &tdo, q_full, 64, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStagesQ;
        const int k0 = (kb0 + i) * kBN;
        mbar_wait(empty(s), ((i / kStagesQ) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile128);
        tma_load(k_tile(s), &tk, full(s), 0, k0, kvh, b);
        tma_load(k_tile(s) + kBox128, &tk, full(s), 64, k0, kvh, b);
        tma_load(v_tile(s), &tv, full(s), 0, k0, kvh, b);
        tma_load(v_tile(s) + kBox128, &tv, full(s), 64, k0, kvh, b);
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
    const unsigned char* q_base = smem + cw * 64 * 128;
    const unsigned char* do_base = smem + kTile128 + cw * 64 * 128;
    const long long base = (static_cast<long long>(b) * g.hq + h) * g.sq_pad;
    const float l20 = l2[base + row0], l21 = l2[base + row1];
    const float dl0 = delta[base + row0], dl1 = delta[base + row1];

    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStagesQ;
      const int k0 = (kb0 + i) * kBN;
      mbar_wait(full(s), (i / kStagesQ) & 1);
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
        const bool masked = needs_mask(g, qw0, 64, k0, kBN);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(sc[4 * nt + e], g.scale_log2,
                                 -(e < 2 ? l20 : l21)));
            if (masked && !key_ok(g, e < 2 ? row0 : row1,
                                  k0 + nt * 8 + 2 * tg + (e & 1)))
              p = 0.0f;
            sc[4 * nt + e] = p;
          }
        }
        wgmma_wait<0>();                      // dP is done
        fence_acc(dp);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {     // dS = P ∘ (dP - D) · scale
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * nt + e] = sc[4 * nt + e] *
                             (dp[4 * nt + e] - (e < 2 ? dl0 : dl1)) * g.scale;
        }
        uint32_t sf[8][4];
        to_frags<16>(sf, dp);
        fence_acc(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)        // dQ += dS·K, K MN-major
          wgmma_rs(dqa, sf[kk], smem_desc(ks + kk * 16 * 128, kBox128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dqa);
      }
      mbar_arrive(empty(s));
    }
    store_acc(dq + b * g.dq_sb + h * g.dq_sh, g.dq_ss, dqa, row0, g.sq, g.d,
              tg);
  }
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k and v (b, hkv, sk, d), o and dout (b, hq, sq, d), all
// bf16, each with its (batch, head, sequence) strides in elements and the
// last dimension contiguous; d is 120 or 128; the base pointers of q, k, v,
// o, dout are 16-byte aligned and their strides multiples of 8 elements; sq
// and sk > 0. dq, dk, dv shaped as q, k, v (any strides, last dimension
// contiguous). lse: the forward's natural-log log-sum-exp of each row,
// contiguous (b, hq, sq) float32. scratch: 2 · b · hq · sq_pad float32,
// 16-byte aligned, sq_pad = sq rounded up to 128. window <= 0: none.
// Returns 0 on success, the cudaError_t of the first launch that failed, or
// kEncodeError plus the CUresult of a failed tensor-map encoding; the
// wrapper checks shapes, types and alignment.
int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int sk, int d, int sq_pad,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  if (sq_pad < sq || sq_pad % kPad != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Runtime calls first: they make the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs (autograd runs the
  // backward on a thread of its own, where none may be current yet).
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dkdv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kKVSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(
      bwd_dq_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  CUtensorMap tq64, tdo64, tq128, tdo128, tk, tv;
  int err = encode(&tq64, q, batch, hq, sq, d, q_sb, q_sh, q_ss, kBM);
  if (err == 0)
    err = encode(&tdo64, dout, batch, hq, sq, d, do_sb, do_sh, do_ss, kBM);
  if (err == 0)
    err = encode(&tq128, q, batch, hq, sq, d, q_sb, q_sh, q_ss, kBMQ);
  if (err == 0)
    err = encode(&tdo128, dout, batch, hq, sq, d, do_sb, do_sh, do_ss, kBMQ);
  if (err == 0) err = encode(&tk, k, batch, hkv, sk, d, k_sb, k_sh, k_ss, kBN);
  if (err == 0) err = encode(&tv, v, batch, hkv, sk, d, v_sb, v_sh, v_ss, kBN);
  if (err != 0) return err;
  Geom g{o_sb,  o_sh,  o_ss,  do_sb, do_sh, do_ss, dq_sb,  dq_sh,
         dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,  hq,
         hkv,   hq / hkv, sq, sk,    d,     sq_pad, causal, window,
         scale, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l2 = static_cast<float*>(scratch);
  const long long rows = static_cast<long long>(batch) * hq * sq_pad;
  float* delta = l2 + rows;
  const unsigned blocks =
      static_cast<unsigned>((rows + kPrepRows - 1) / kPrepRows);
  bwd_prep<<<blocks, 16 * kPrepRows, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      l2, delta, g, rows);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid_kv(batch * hkv, (sk + kBN - 1) / kBN);
  bwd_dkdv_sm90<<<grid_kv, kThreads, kKVSmem, s>>>(
      tq64, tdo64, tk, tv, l2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid_q(batch * hq, (sq + kBMQ - 1) / kBMQ);
  bwd_dq_sm90<<<grid_q, kThreads, kQSmem, s>>>(
      tq128, tdo128, tk, tv, l2, delta, static_cast<__nv_bfloat16*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
