// K3-bwd: the gradient of K3 (flash attention), dQ, dK and dV, bf16 on the
// tensor cores and float32 on the CUDA cores. Port only: the TPU package has
// no backward kernel (its gradient through attention is autodiff of
// src/repro/kernels/flash_attention/ref.py::attention_ref), so this stands
// for that autodiff on the training path
// (kernels/flash_attention/ops.py::flash_attention_bwd).
//
// What it computes, per (batch, query head): with S = Q·Kᵀ · sm_scale under
// K3's masks (k < sk, causal q >= k, window q - k < window) and the
// forward's log-sum-exp L of each query row, P = exp(S - L) (0 where
// masked), D = rowsum(dO ∘ O), dS = P ∘ (dO·Vᵀ - D) · sm_scale:
//   dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K,
// summed for dK and dV over the hq / hkv query heads that read a kv head
// (GQA/MQA: query head h reads kv head h / (hq / hkv)). P and dS are
// rounded to bf16 before their products in bf16, as the forward rounds P;
// every sum is float32.
//
// Design, three launches on the caller's stream, no atomics, every sum in
// a fixed order (two runs give the same bits):
//   * delta: one warp per query row, D = rowsum(dO ∘ O) in float32.
//   * dK, dV: one CTA per (kv block, batch·kv head). The CTA's keys stay in
//     shared memory and their dK, dV accumulators in registers while it
//     walks the group's query heads in order and, for each, the q blocks
//     that can see its keys in order (causal: from the block's first key;
//     window: up to its last key + window).
//   * dQ: one CTA per (q block, batch·query head), walking the kv blocks
//     its rows can see in order (K3's forward's range).
//   * bf16 (head_dim zero-padded to 32, 64 or 128 in shared memory): 4 warps
//     of mma.sync m16n8k16, 16 keys (dK, dV) or 16 query rows (dQ) a warp.
//     For dK and dV the warp computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly,
//     so that Pᵀ and dSᵀ come out in the accumulator layout that converts
//     in registers to the A operand of Pᵀ·dO and dSᵀ·Q; Q and dO are staged
//     both row-major and transposed. For dQ, K is staged transposed.
//   * float32: 8 threads a row (key rows for dK, dV; query rows for dQ),
//     each holding d / 8 interleaved dimensions, the other operand staged
//     in shared memory, dot products reduced across the 8 lanes by
//     shuffles; CUDA-core FMAs throughout.
//   * Ragged edges are masked in the kernel; nothing is padded in device
//     memory. Strides are arguments: dO usually arrives as the transposed
//     view of a (b, t, h, d) buffer, and dQ, dK, dV are written into such
//     views.
//
// Bound on an H100 at the AdamW training shape (b = 8, 32 query / 8 kv
// heads, T = 512, d = 128, causal): bytes. q, O, dO, dQ (b·hq·T·d each),
// k, v, dK, dV (b·hkv·T·d each) in bf16 and L are 168 MB, 0.050 ms at
// 3.35 TB/s; five products of 2·d FLOP a kept (query, key) pair (S
// recomputed, dP, dV, dK, dQ), 10·d·b·hq·T(T+1)/2 = 4.3e10 bf16
// tensor-core FLOP, take 0.044 ms at 989 TFLOP/s. This first version
// (mma.sync, synchronous loads, S and dP recomputed in the dQ pass) is far
// from either; PERF.md has its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int hq, hkv, group;     // group = hq / hkv
  int sq, sk, d;
  int causal, window;     // window <= 0: no window
  float scale;
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------------ delta --
constexpr int kDeltaRows = 8;       // one warp a row

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaRows)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, Geom g, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * kDeltaRows +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int row = static_cast<int>(r % g.sq);
  const long long bh = r / g.sq;
  const int b = static_cast<int>(bh / g.hq), h = static_cast<int>(bh % g.hq);
  const T* op = o + b * g.o_sb + h * g.o_sh + row * g.o_ss;
  const T* dp = dout + b * g.do_sb + h * g.do_sh + row * g.do_ss;
  float acc = 0.0f;
  for (int c = lane; c < g.d; c += 32) acc = fmaf(to_f(dp[c]), to_f(op[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------- bf16 --
constexpr int kBM = 64;        // query rows a step (dK, dV) or a CTA (dQ)
constexpr int kBN = 64;        // keys a CTA (dK, dV) or a step (dQ)
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 of row `row`, columns [col, col + 8), or zeros past the edge.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, long long ss,
                                       int row, int nrows, int col, int d,
                                       int vec16) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (row < nrows && col < d) {
    const __nv_bfloat16* p = src + row * ss + col;
    if (vec16) {
      val = *reinterpret_cast<const uint4*>(p);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
      val.x = s[0] | (static_cast<uint32_t>(s[1]) << 16);
      val.y = s[2] | (static_cast<uint32_t>(s[3]) << 16);
      val.z = s[4] | (static_cast<uint32_t>(s[5]) << 16);
      val.w = s[6] | (static_cast<uint32_t>(s[7]) << 16);
    }
  }
  return val;
}

// Rows [r0, r0 + ROWS) of src into dst[ROWS][ld], row-major.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           long long ss, int r0, int nrows,
                                           int d, int vec16) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + col) =
        load8(src, ss, r0 + r, nrows, col, d, vec16);
  }
}

// Rows [r0, r0 + ROWS) of src into dst[DP][ld], transposed.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows_t(__nv_bfloat16* dst, int ld,
                                             const __nv_bfloat16* src,
                                             long long ss, int r0, int nrows,
                                             int d, int vec16) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const uint4 val = load8(src, ss, r0 + r, nrows, col, d, vec16);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * ld + r] = h[i];
  }
}

// The A fragment (16 rows x 16 columns at column 16 kk) of a warp's rows in
// a row-major shared tile.
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int ld, int r0, int kk, int gr,
                                       int tg) {
  const __nv_bfloat16* p0 = t + (r0 + gr) * ld + kk * 16 + 2 * tg;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// acc[NT][4] (16 rows x 8 NT columns) += A (16 x 16 KS, row-major shared
// tile at rows r0) · Bᵀ, B's 8 NT rows of 16 KS stored row-major in bs.
template <int KS, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const __nv_bfloat16* as, int lda,
                                         int r0, const __nv_bfloat16* bs,
                                         int ldb, int gr, int tg) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    frag_a(a, as, lda, r0, kk, gr, tg);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* br = bs + (nt * 8 + gr) * ldb + kk * 16 + 2 * tg;
      mma_bf16(acc[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc[NT][4] += A (16 x 16 KS, bf16 fragments in registers) · Bᵀ, B's 8 NT
// rows of 16 KS stored row-major in bs.
template <int KS, int NT>
__device__ __forceinline__ void mma_frags(float (&acc)[NT][4],
                                          const uint32_t (&a)[KS][4],
                                          const __nv_bfloat16* bs, int ldb,
                                          int gr, int tg) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* br = bs + (nt * 8 + gr) * ldb + kk * 16 + 2 * tg;
      mma_bf16(acc[nt], a[kk], ld32(br), ld32(br + 8));
    }
  }
}

// A 16 x 8 NT accumulator rounded to bf16 as the A operand of the next
// product (8 NT becomes its k dimension).
template <int NT>
__device__ __forceinline__ void to_frags(uint32_t (&a)[NT / 2][4],
                                         const float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              Geom g, int vec16) {
  constexpr int kLd = DP + 8;      // row-major tiles, +16 bytes a row
  constexpr int kLdt = kBM + 8;    // transposed tiles
  constexpr int kKS = DP / 16;
  constexpr int kTilesQ = kBM / 8;
  constexpr int kTilesD = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBN * kLd;        // [kBN][kLd]
  __nv_bfloat16* qs = vs + kBN * kLd;        // [kBM][kLd]
  __nv_bfloat16* dos = qs + kBM * kLd;       // [kBM][kLd]
  __nv_bfloat16* qt = dos + kBM * kLd;       // [DP][kLdt]
  __nv_bfloat16* dot = qt + DP * kLdt;       // [DP][kLdt]
  float* lse_s = reinterpret_cast<float*>(dot + DP * kLdt);   // [kBM]
  float* dl_s = lse_s + kBM;                                  // [kBM]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * kBN;
  const int bkv = blockIdx.y;
  const int b = bkv / g.hkv, kvh = bkv % g.hkv;
  stage_rows<DP, kBN>(ks, kLd, k + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0,
                      g.sk, g.d, vec16);
  stage_rows<DP, kBN>(vs, kLd, v + b * g.v_sb + kvh * g.v_sh, g.v_ss, k0,
                      g.sk, g.d, vec16);

  float dka[kTilesD][4], dva[kTilesD][4];
#pragma unroll
  for (int nt = 0; nt < kTilesD; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.0f;
  const int kr = warp * 16;                 // the warp's keys in the block
  const int key0 = k0 + kr + gr, key1 = key0 + 8;
  int qb0, qb1;
  q_range(g, k0, kBN, kBM, &qb0, &qb1);

  for (int hi = 0; hi < g.group; ++hi) {
    const int h = kvh * g.group + hi;
    const __nv_bfloat16* qp = q + b * g.q_sb + h * g.q_sh;
    const __nv_bfloat16* dop = dout + b * g.do_sb + h * g.do_sh;
    const float* lsep = lse + (static_cast<long long>(b) * g.hq + h) * g.sq;
    const float* dlp = delta + (static_cast<long long>(b) * g.hq + h) * g.sq;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * kBM;
      __syncthreads();               // the previous block is consumed
      stage_rows<DP, kBM>(qs, kLd, qp, g.q_ss, q0, g.sq, g.d, vec16);
      stage_rows<DP, kBM>(dos, kLd, dop, g.do_ss, q0, g.sq, g.d, vec16);
      stage_rows_t<DP, kBM>(qt, kLdt, qp, g.q_ss, q0, g.sq, g.d, vec16);
      stage_rows_t<DP, kBM>(dot, kLdt, dop, g.do_ss, q0, g.sq, g.d, vec16);
      for (int r = threadIdx.x; r < kBM; r += kThreads) {
        const bool in = q0 + r < g.sq;
        lse_s[r] = in ? lsep[q0 + r] : 0.0f;
        dl_s[r] = in ? dlp[q0 + r] : 0.0f;
      }
      __syncthreads();

      // Pᵀ (16 keys x 64 query rows) from Sᵀ = K·Qᵀ
      float pt[kTilesQ][4];
#pragma unroll
      for (int nt = 0; nt < kTilesQ; ++nt)
        pt[nt][0] = pt[nt][1] = pt[nt][2] = pt[nt][3] = 0.0f;
      mma_rows<kKS, kTilesQ>(pt, ks, kLd, kr, qs, kLd, gr, tg);
      const bool masked = needs_mask(g, q0, kBM, k0, kBN);
#pragma unroll
      for (int nt = 0; nt < kTilesQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * tg + (e & 1);
          const int key = e < 2 ? key0 : key1;
          pt[nt][e] = (!masked || key_ok(g, q0 + c, key))
                          ? expf(__fmul_rn(pt[nt][e], g.scale) - lse_s[c])
                          : 0.0f;
        }
      }
      uint32_t af[kBM / 16][4];
      to_frags<kTilesQ>(af, pt);
      mma_frags<kBM / 16, kTilesD>(dva, af, dot, kLdt, gr, tg);   // Pᵀ·dO

      // dSᵀ = Pᵀ ∘ (dPᵀ - D) · sm_scale, dPᵀ = V·dOᵀ
      float dpt[kTilesQ][4];
#pragma unroll
      for (int nt = 0; nt < kTilesQ; ++nt)
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.0f;
      mma_rows<kKS, kTilesQ>(dpt, vs, kLd, kr, dos, kLd, gr, tg);
#pragma unroll
      for (int nt = 0; nt < kTilesQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * tg + (e & 1);
          dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - dl_s[c]) * g.scale;
        }
      }
      to_frags<kTilesQ>(af, dpt);
      mma_frags<kBM / 16, kTilesD>(dka, af, qt, kLdt, gr, tg);    // dSᵀ·Q
    }
  }

  __nv_bfloat16* dkp = dk + b * g.dk_sb + kvh * g.dk_sh;
  __nv_bfloat16* dvp = dv + b * g.dv_sb + kvh * g.dv_sh;
#pragma unroll
  for (int nt = 0; nt < kTilesD; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (col >= g.d) continue;
    if (key0 < g.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key0 * g.dk_ss + col) =
          __floats2bfloat162_rn(dka[nt][0], dka[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key0 * g.dv_ss + col) =
          __floats2bfloat162_rn(dva[nt][0], dva[nt][1]);
    }
    if (key1 < g.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key1 * g.dk_ss + col) =
          __floats2bfloat162_rn(dka[nt][2], dka[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key1 * g.dv_ss + col) =
          __floats2bfloat162_rn(dva[nt][2], dva[nt][3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, Geom g, int vec16) {
  constexpr int kLd = DP + 8;
  constexpr int kLdt = kBN + 8;
  constexpr int kKS = DP / 16;
  constexpr int kTilesK = kBN / 8;
  constexpr int kTilesD = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBM * kLd;       // [kBM][kLd]
  __nv_bfloat16* ks = dos + kBM * kLd;       // [kBN][kLd]
  __nv_bfloat16* vs = ks + kBN * kLd;        // [kBN][kLd]
  __nv_bfloat16* kt = vs + kBN * kLd;        // [DP][kLdt]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const __nv_bfloat16* kp = k + b * g.k_sb + kvh * g.k_sh;
  const __nv_bfloat16* vp = v + b * g.v_sb + kvh * g.v_sh;
  stage_rows<DP, kBM>(qs, kLd, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.sq,
                      g.d, vec16);
  stage_rows<DP, kBM>(dos, kLd, dout + b * g.do_sb + h * g.do_sh, g.do_ss,
                      q0, g.sq, g.d, vec16);
  const int qr = warp * 16;
  const int row0 = q0 + qr + gr, row1 = row0 + 8;
  const long long base = (static_cast<long long>(b) * g.hq + h) * g.sq;
  const float lse0 = row0 < g.sq ? lse[base + row0] : 0.0f;
  const float lse1 = row1 < g.sq ? lse[base + row1] : 0.0f;
  const float dl0 = row0 < g.sq ? delta[base + row0] : 0.0f;
  const float dl1 = row1 < g.sq ? delta[base + row1] : 0.0f;

  float dqa[kTilesD][4];
#pragma unroll
  for (int nt = 0; nt < kTilesD; ++nt)
    dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.0f;

  int kb0, kb1;
  kv_range(g, q0, kBM, kBN, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * kBN;
    __syncthreads();
    stage_rows<DP, kBN>(ks, kLd, kp, g.k_ss, k0, g.sk, g.d, vec16);
    stage_rows<DP, kBN>(vs, kLd, vp, g.v_ss, k0, g.sk, g.d, vec16);
    stage_rows_t<DP, kBN>(kt, kLdt, kp, g.k_ss, k0, g.sk, g.d, vec16);
    __syncthreads();

    float p[kTilesK][4];
#pragma unroll
    for (int nt = 0; nt < kTilesK; ++nt)
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
    mma_rows<kKS, kTilesK>(p, qs, kLd, qr, ks, kLd, gr, tg);     // Q·Kᵀ
    const bool masked = needs_mask(g, q0, kBM, k0, kBN);
#pragma unroll
    for (int nt = 0; nt < kTilesK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        p[nt][e] = (!masked || key_ok(g, row, k0 + nt * 8 + 2 * tg + (e & 1)))
                       ? expf(__fmul_rn(p[nt][e], g.scale) -
                              (e < 2 ? lse0 : lse1))
                       : 0.0f;
      }
    }
    float ds[kTilesK][4];
#pragma unroll
    for (int nt = 0; nt < kTilesK; ++nt)
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.0f;
    mma_rows<kKS, kTilesK>(ds, dos, kLd, qr, vs, kLd, gr, tg);   // dO·Vᵀ
#pragma unroll
    for (int nt = 0; nt < kTilesK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - (e < 2 ? dl0 : dl1)) * g.scale;
    }
    uint32_t af[kBN / 16][4];
    to_frags<kTilesK>(af, ds);
    mma_frags<kBN / 16, kTilesD>(dqa, af, kt, kLdt, gr, tg);      // dS·K
  }

  __nv_bfloat16* dqp = dq + b * g.dq_sb + h * g.dq_sh;
#pragma unroll
  for (int nt = 0; nt < kTilesD; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (col >= g.d) continue;
    if (row0 < g.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + row0 * g.dq_ss + col) =
          __floats2bfloat162_rn(dqa[nt][0], dqa[nt][1]);
    if (row1 < g.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + row1 * g.dq_ss + col) =
          __floats2bfloat162_rn(dqa[nt][2], dqa[nt][3]);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk,
                void* dv, const Geom& g, int batch, int vec16,
                cudaStream_t stream) {
  constexpr int kSmemKV = (2 * kBN * (DP + 8) + 2 * kBM * (DP + 8) +
                           2 * DP * (kBM + 8)) * 2 + 2 * kBM * 4;
  constexpr int kSmemQ = (2 * kBM * (DP + 8) + 2 * kBN * (DP + 8) +
                          DP * (kBN + 8)) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      bwd_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  typedef const __nv_bfloat16* P;
  const dim3 grid_kv((g.sk + kBN - 1) / kBN, batch * g.hkv);
  bwd_dkdv_bf16<DP><<<grid_kv, kThreads, kSmemKV, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),
      static_cast<P>(dout), lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((g.sq + kBM - 1) / kBM, batch * g.hq);
  bwd_dq_bf16<DP><<<grid_q, kThreads, kSmemQ, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),
      static_cast<P>(dout), lse, delta, static_cast<__nv_bfloat16*>(dq), g,
      vec16);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 --
constexpr int kFRows = 32;     // rows a CTA (keys for dK, dV; queries for dQ)
constexpr int kFLanes = 8;     // threads a row
constexpr int kFStep = 32;     // rows of the other operand staged a step
constexpr int kFThreads = kFRows * kFLanes;
constexpr int kFDims = 128 / kFLanes;   // dimensions a thread, at most

__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__global__ void __launch_bounds__(kFThreads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, Geom g) {
  extern __shared__ float fsm[];
  float* qs = fsm;                       // [kFStep][d]
  float* dos = fsm + kFStep * g.d;       // [kFStep][d]
  float* lse_s = dos + kFStep * g.d;     // [kFStep]
  float* dl_s = lse_s + kFStep;          // [kFStep]
  const int r = threadIdx.x / kFLanes, part = threadIdx.x % kFLanes;
  const int dpt = g.d / kFLanes;
  const int k0 = blockIdx.x * kFRows;
  const int key = k0 + r;
  const int bkv = blockIdx.y;
  const int b = bkv / g.hkv, kvh = bkv % g.hkv;
  const float* krow = k + b * g.k_sb + kvh * g.k_sh + key * g.k_ss;
  const float* vrow = v + b * g.v_sb + kvh * g.v_sh + key * g.v_ss;
  float kv[kFDims], vv[kFDims], dka[kFDims], dva[kFDims];
#pragma unroll
  for (int i = 0; i < kFDims; ++i) {
    const bool in = i < dpt && key < g.sk;
    kv[i] = in ? krow[i * kFLanes + part] : 0.0f;
    vv[i] = in ? vrow[i * kFLanes + part] : 0.0f;
    dka[i] = dva[i] = 0.0f;
  }
  int qb0, qb1;
  q_range(g, k0, kFRows, kFStep, &qb0, &qb1);
  for (int hi = 0; hi < g.group; ++hi) {
    const int h = kvh * g.group + hi;
    const float* qp = q + b * g.q_sb + h * g.q_sh;
    const float* dop = dout + b * g.do_sb + h * g.do_sh;
    const long long base = (static_cast<long long>(b) * g.hq + h) * g.sq;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * kFStep;
      __syncthreads();
      for (int c = threadIdx.x; c < kFStep * g.d; c += kFThreads) {
        const int rr = c / g.d, cc = c % g.d, row = q0 + rr;
        qs[c] = row < g.sq ? qp[row * g.q_ss + cc] : 0.0f;
        dos[c] = row < g.sq ? dop[row * g.do_ss + cc] : 0.0f;
      }
      for (int rr = threadIdx.x; rr < kFStep; rr += kFThreads) {
        const bool in = q0 + rr < g.sq;
        lse_s[rr] = in ? lse[base + q0 + rr] : 0.0f;
        dl_s[rr] = in ? delta[base + q0 + rr] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < kFStep; ++j) {
        const float* qr = qs + j * g.d + part;
        const float* dr = dos + j * g.d + part;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int i = 0; i < kFDims; ++i) {
          if (i < dpt) {
            s = fmaf(kv[i], qr[i * kFLanes], s);
            dp = fmaf(vv[i], dr[i * kFLanes], dp);
          }
        }
        s = lane_sum(s);
        dp = lane_sum(dp);
        const float p = key_ok(g, q0 + j, key)
                            ? expf(__fmul_rn(s, g.scale) - lse_s[j]) : 0.0f;
        const float ds = p * (dp - dl_s[j]) * g.scale;
#pragma unroll
        for (int i = 0; i < kFDims; ++i) {
          if (i < dpt) {
            dva[i] = fmaf(p, dr[i * kFLanes], dva[i]);
            dka[i] = fmaf(ds, qr[i * kFLanes], dka[i]);
          }
        }
      }
    }
  }
  if (key < g.sk) {
    float* dkrow = dk + b * g.dk_sb + kvh * g.dk_sh + key * g.dk_ss;
    float* dvrow = dv + b * g.dv_sb + kvh * g.dv_sh + key * g.dv_ss;
#pragma unroll
    for (int i = 0; i < kFDims; ++i) {
      if (i < dpt) {
        dkrow[i * kFLanes + part] = dka[i];
        dvrow[i * kFLanes + part] = dva[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, Geom g) {
  extern __shared__ float fsm[];
  float* ks = fsm;                       // [kFStep][d]
  float* vs = fsm + kFStep * g.d;        // [kFStep][d]
  const int r = threadIdx.x / kFLanes, part = threadIdx.x % kFLanes;
  const int dpt = g.d / kFLanes;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFRows;
  const int row = q0 + r;
  const int bh = blockIdx.y;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const float* qrow = q + b * g.q_sb + h * g.q_sh + row * g.q_ss;
  const float* drow = dout + b * g.do_sb + h * g.do_sh + row * g.do_ss;
  const float* kp = k + b * g.k_sb + kvh * g.k_sh;
  const float* vp = v + b * g.v_sb + kvh * g.v_sh;
  const long long base = (static_cast<long long>(b) * g.hq + h) * g.sq;
  const float l = row < g.sq ? lse[base + row] : 0.0f;
  const float dl = row < g.sq ? delta[base + row] : 0.0f;
  float qv[kFDims], dov[kFDims], dqa[kFDims];
#pragma unroll
  for (int i = 0; i < kFDims; ++i) {
    const bool in = i < dpt && row < g.sq;
    qv[i] = in ? qrow[i * kFLanes + part] : 0.0f;
    dov[i] = in ? drow[i * kFLanes + part] : 0.0f;
    dqa[i] = 0.0f;
  }
  int kb0, kb1;
  kv_range(g, q0, kFRows, kFStep, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * kFStep;
    __syncthreads();
    for (int c = threadIdx.x; c < kFStep * g.d; c += kFThreads) {
      const int rr = c / g.d, cc = c % g.d, key = k0 + rr;
      ks[c] = key < g.sk ? kp[key * g.k_ss + cc] : 0.0f;
      vs[c] = key < g.sk ? vp[key * g.v_ss + cc] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kFStep; ++j) {
      const float* kr = ks + j * g.d + part;
      const float* vr = vs + j * g.d + part;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < kFDims; ++i) {
        if (i < dpt) {
          s = fmaf(qv[i], kr[i * kFLanes], s);
          dp = fmaf(dov[i], vr[i * kFLanes], dp);
        }
      }
      s = lane_sum(s);
      dp = lane_sum(dp);
      const float p = key_ok(g, row, k0 + j)
                          ? expf(__fmul_rn(s, g.scale) - l) : 0.0f;
      const float ds = p * (dp - dl) * g.scale;
#pragma unroll
      for (int i = 0; i < kFDims; ++i)
        if (i < dpt) dqa[i] = fmaf(ds, kr[i * kFLanes], dqa[i]);
    }
  }
  if (row < g.sq) {
    float* dqrow = dq + b * g.dq_sb + h * g.dq_sh + row * g.dq_ss;
#pragma unroll
    for (int i = 0; i < kFDims; ++i)
      if (i < dpt) dqrow[i * kFLanes + part] = dqa[i];
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, const Geom& g, int batch, cudaStream_t stream) {
  const int smem_kv = (2 * kFStep * g.d + 2 * kFStep) *
                      static_cast<int>(sizeof(float));
  const int smem_q = 2 * kFStep * g.d * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  typedef const float* P;
  const dim3 grid_kv((g.sk + kFRows - 1) / kFRows, batch * g.hkv);
  bwd_dkdv_f32<<<grid_kv, kFThreads, smem_kv, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),
      static_cast<P>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((g.sq + kFRows - 1) / kFRows, batch * g.hq);
  bwd_dq_f32<<<grid_q, kFThreads, smem_q, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),
      static_cast<P>(dout), lse, delta, static_cast<float*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k and v (b, hkv, sk, d), o and dout (b, hq, sq, d),
// dq, dk, dv shaped as q, k, v; each with its (batch, head, sequence)
// strides in elements and the last dimension contiguous. lse (the
// forward's natural-log log-sum-exp of each row) and delta (scratch, filled
// here) are contiguous (b, hq, sq) float32. dtype: 0 float32, 1 bfloat16;
// d a multiple of 8 up to 128. window <= 0: none. vec16: every bf16 row
// start of q, k, v, dout is 16-byte aligned. Returns the cudaError_t of the
// first launch that failed (0 on success); the wrapper checks shapes and
// types.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int batch, int hq, int hkv, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, int vec16, void* stream) {
  Geom g{q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,
         v_ss,  o_sb,  o_sh,  o_ss,  do_sb, do_sh, do_ss, dq_sb,
         dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
         hq,    hkv,   hq / hkv, sq, sk,  d,     causal, window,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(batch) * hq * sq;
  const unsigned blocks =
      static_cast<unsigned>((rows + kDeltaRows - 1) / kDeltaRows);
  if (dtype == 0) {
    bwd_delta<float><<<blocks, 32 * kDeltaRows, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl, g,
        rows);
  } else {
    bwd_delta<__nv_bfloat16><<<blocks, 32 * kDeltaRows, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), dl, g, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return launch_f32(q, k, v, dout, l, dl, dq, dk, dv, g, batch, s);
  if (d <= 32)
    return launch_bf16<32>(q, k, v, dout, l, dl, dq, dk, dv, g, batch, vec16, s);
  if (d <= 64)
    return launch_bf16<64>(q, k, v, dout, l, dl, dq, dk, dv, g, batch, vec16, s);
  return launch_bf16<128>(q, k, v, dout, l, dl, dq, dk, dv, g, batch, vec16, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
