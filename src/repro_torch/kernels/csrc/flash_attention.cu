// K3: flash attention forward (online softmax), bf16 on the tensor cores
// and float32 on the CUDA cores.
//
// The op (kernels/flash_attention/ops.py::choose_kernel) sends bf16 with
// head_dim 120 or 128 and 16-byte-aligned pointers and strides, the dense
// models' prefill, to flash_attention_sm90.cu (TMA and wgmma), and
// everything else it takes here: float32, head_dim up to 64 (the reduced
// configs' 16) or another multiple of 8, and unaligned strides.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel): a grid over (batch·heads,
// q blocks, kv blocks) whose kv axis runs in order, with the running max,
// denominator and (block_q, d) accumulator carried in VMEM scratch.
//
// What it computes, per (batch, query head) and query row: softmax over the
// keys of (q·k) · sm_scale, masked by k < sk, causal q >= k (both counted
// from 0, top-left aligned) and window q - k < window, times V. Masked
// scores are the finite -1e30; the running max, denominator and
// accumulator are float32; P is rounded to V's dtype before P·V; the output
// is cast to the input dtype; a denominator of 0 is replaced by 1.
//
// Design on Hopper:
//   * One CTA per (query block, batch·query head); the kv blocks are a loop
//     inside the CTA, so the state stays in registers. Query head h reads
//     kv head h / (hq / hkv) (jnp.repeat's order): GQA/MQA with no copy.
//   * bf16: 4 warps, 64 query rows (16 a warp), kv blocks of 64 keys.
//     S = Q·Kᵀ and O += P·V are mma.sync m16n8k16 (bf16 in, float32
//     accumulate), FlashAttention-2 style: the warp's Q fragments, S, P and
//     O live in registers and P is reused as the A operand of P·V without a
//     trip through shared memory. K is staged row-major and V transposed in
//     shared memory; head_dim is zero-padded there to 32, 64 or 128, so any
//     multiple of 8 up to 128 works (the model's 128 and 120, the reduced
//     configs' 16).
//   * float32: 8 threads per query row (each holding d/8 interleaved
//     dimensions of q and of the accumulator), 32 rows a CTA, K and V
//     staged in shared memory, scores reduced across the 8 lanes by
//     shuffles and folded 8 keys at a time; CUDA-core FMAs throughout.
//   * Ragged edges are masked in the kernel (rows >= sk read as 0 and never
//     count); nothing is padded in device memory. Strides are arguments, so
//     the (b, t, h, d) projections are read through their transposed views.
//   * Blocks wholly past the causal diagonal or before the window are
//     skipped (the output is the same); only blocks that cross a mask edge
//     compute the mask.
//   * A masked score contributes exactly 0 to the sums, so a query row with
//     no valid key comes out as zeros (the reference's docstring; see
//     ROADMAP, K3, for how the reference's own versions differ there).
//   * Optional: each query row's log-sum-exp, m + log(l) in natural units
//     of s · sm_scale, for the backward kernel (flash_attention_bwd.cu); it
//     is written after the output and moves none of its bits.
//
// Bound on an H100 at the model's shape (b = 1, 32 query / 8 kv heads,
// T = 8192, d = 128, causal): operations. 4·b·hq·d·T(T+1)/2 = 5.5e11
// bf16 tensor-core FLOP take 0.556 ms at 989 TFLOP/s; Q, K, V and O are
// 151 MB, 0.045 ms at 3.35 TB/s. This first version uses mma.sync with
// synchronous loads (no TMA, no wgmma, no pipelining), which cannot reach
// that rate; PERF.md has its measured time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Geom {
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int hq, group;          // group = hq / hkv
  int sq, sk, d;
  int causal, window;     // window <= 0: no window
  float scale;
};

// The kv blocks [kb0, kb1) that hold any key a query row in [q0, q0 + bm)
// may attend to.
__device__ __forceinline__ void kv_range(const Geom& g, int q0, int bm,
                                         int bn, int* kb0, int* kb1) {
  int hi = g.sk;
  if (g.causal) hi = min(hi, q0 + bm);
  int lo = 0;
  if (g.window > 0) lo = max(0, q0 - g.window + 1);
  *kb0 = lo / bn;
  *kb1 = hi > lo ? (hi + bn - 1) / bn : *kb0;
}

// Whether some (row, key) of the q block x kv block is masked.
__device__ __forceinline__ bool needs_mask(const Geom& g, int q0, int bm,
                                           int k0, int bn) {
  return k0 + bn > g.sk || (g.causal && k0 + bn - 1 > q0) ||
         (g.window > 0 && (q0 + bm - 1) - k0 >= g.window);
}

__device__ __forceinline__ bool key_ok(const Geom& g, int row, int col) {
  return col < g.sk && (!g.causal || row >= col) &&
         (g.window <= 0 || row - col < g.window);
}

// ---------------------------------------------------------------- bf16 --
constexpr int kBM = 64;        // query rows a CTA (4 warps x 16)
constexpr int kBN = 64;        // keys a kv block
constexpr int kThreads = 128;

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

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attn_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Geom g, int vec16) {
  constexpr int kLdq = DP + 8;     // +16 bytes a row: conflict-free fragments
  constexpr int kLdv = kBN + 8;
  constexpr int kKSteps = DP / 16;
  constexpr int kTilesS = kBN / 8;
  constexpr int kTilesO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBM * kLdq;        // [kBN][kLdq]
  __nv_bfloat16* vt = ks + kBN * kLdq;        // [DP][kLdv]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const __nv_bfloat16* qp = q + b * g.q_sb + h * g.q_sh;
  const __nv_bfloat16* kp = k + b * g.k_sb + kvh * g.k_sh;
  const __nv_bfloat16* vp = v + b * g.v_sb + kvh * g.v_sh;

  stage_rows<DP, kBM>(qs, kLdq, qp, g.q_ss, q0, g.sq, g.d, vec16);
  __syncthreads();
  const int qr = warp * 16 + gr;
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* r0 = qs + qr * kLdq + kk * 16 + 2 * tg;
    const __nv_bfloat16* r1 = r0 + 8 * kLdq;
    qf[kk][0] = ld32(r0);
    qf[kk][1] = ld32(r1);
    qf[kk][2] = ld32(r0 + 8);
    qf[kk][3] = ld32(r1 + 8);
  }

  float acc[kTilesO][4];
#pragma unroll
  for (int nt = 0; nt < kTilesO; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const int row0 = q0 + qr, row1 = row0 + 8;

  int kb0, kb1;
  kv_range(g, q0, kBM, kBN, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * kBN;
    __syncthreads();                 // the previous block is consumed
    stage_rows<DP, kBN>(ks, kLdq, kp, g.k_ss, k0, g.sk, g.d, vec16);
    stage_rows_t<DP, kBN>(vt, kLdv, vp, g.v_ss, k0, g.sk, g.d, vec16);
    __syncthreads();

    float s[kTilesS][4];
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kTilesS; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + gr) * kLdq + kk * 16 + 2 * tg;
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    const bool masked = needs_mask(g, q0, kBM, k0, kBN);
    uint32_t valid = 0xffffffffu;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nt][e], g.scale);
        if (masked &&
            !key_ok(g, e < 2 ? row0 : row1, k0 + nt * 8 + 2 * tg + (e & 1))) {
          x = kNegInf;
          valid &= ~(1u << (nt * 4 + e));
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a quad share rows gr and gr + 8
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < kTilesO; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }

    // P, rounded to bf16, laid out as the A operand of P·V
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (valid >> (nt * 4 + e)) & 1u
                   ? expf(s[nt][e] - (e < 2 ? mx0 : mx1)) : 0.0f;
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kTilesO; ++nt) {
        const __nv_bfloat16* vr = vt + (nt * 8 + gr) * kLdv + kk * 16 + 2 * tg;
        mma_bf16(acc[nt], pf[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (l0 == 0.0f) l0 = 1.0f;
  if (l1 == 0.0f) l1 = 1.0f;
  if (lse != nullptr && tg == 0) {
    float* lp = lse + static_cast<long long>(bh) * g.sq;
    if (row0 < g.sq) lp[row0] = m0 + logf(l0);
    if (row1 < g.sq) lp[row1] = m1 + logf(l1);
  }
  __nv_bfloat16* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int nt = 0; nt < kTilesO; ++nt) {
    const int col = nt * 8 + 2 * tg;
    if (col >= g.d) continue;
    if (row0 < g.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * g.o_ss + col) =
          __floats2bfloat162_rn(acc[nt][0] / l0, acc[nt][1] / l0);
    if (row1 < g.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row1 * g.o_ss + col) =
          __floats2bfloat162_rn(acc[nt][2] / l1, acc[nt][3] / l1);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const Geom& g, int batch, int vec16,
                cudaStream_t stream) {
  constexpr int kSmem = (kBM * (DP + 8) + kBN * (DP + 8) + DP * (kBN + 8)) *
                        static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.sq + kBM - 1) / kBM, batch * g.hq);
  flash_attn_bf16<DP><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      g, vec16);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 --
constexpr int kFRows = 32;     // query rows a CTA
constexpr int kFLanes = 8;     // threads a row
constexpr int kFBN = 64;       // keys a kv block
constexpr int kFThreads = kFRows * kFLanes;
constexpr int kFDims = 128 / kFLanes;   // dimensions a thread, at most

__global__ void __launch_bounds__(kFThreads)
flash_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, Geom g) {
  extern __shared__ float fsm[];
  float* ks = fsm;                      // [kFBN][d]
  float* vs = fsm + kFBN * g.d;         // [kFBN][d]
  const int r = threadIdx.x / kFLanes, part = threadIdx.x % kFLanes;
  const int dpt = g.d / kFLanes;        // thread's dims: i * 8 + part
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFRows;
  const int row = q0 + r;
  const int bh = blockIdx.y;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  const float* kp = k + b * g.k_sb + kvh * g.k_sh;
  const float* vp = v + b * g.v_sb + kvh * g.v_sh;

  float qv[kFDims], acc[kFDims];
  const float* qrow = q + b * g.q_sb + h * g.q_sh + row * g.q_ss;
#pragma unroll
  for (int i = 0; i < kFDims; ++i) {
    qv[i] = (i < dpt && row < g.sq) ? qrow[i * kFLanes + part] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  int kb0, kb1;
  kv_range(g, q0, kFRows, kFBN, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * kFBN;
    __syncthreads();
    for (int c = threadIdx.x; c < kFBN * g.d; c += kFThreads) {
      const int rr = c / g.d, cc = c % g.d, key = k0 + rr;
      ks[c] = key < g.sk ? kp[key * g.k_ss + cc] : 0.0f;
      vs[c] = key < g.sk ? vp[key * g.v_ss + cc] : 0.0f;
    }
    __syncthreads();
    const bool masked = needs_mask(g, q0, kFRows, k0, kFBN);
    for (int j = 0; j < kFBN; j += 8) {
      float s[8];
      float mx = m;
      uint32_t valid = 0xffu;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float* kr = ks + (j + jj) * g.d + part;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kFDims; ++i)
          if (i < dpt) dot = fmaf(qv[i], kr[i * kFLanes], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        float x = __fmul_rn(dot, g.scale);
        if (masked && !key_ok(g, row, k0 + j + jj)) {
          x = kNegInf;
          valid &= ~(1u << jj);
        }
        s[jj] = x;
        mx = fmaxf(mx, x);
      }
      const float alpha = expf(m - mx);
      m = mx;
      float p[8], psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        p[jj] = (valid >> jj) & 1u ? expf(s[jj] - mx) : 0.0f;
        psum += p[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < kFDims; ++i) {
        if (i >= dpt) continue;
        float a = acc[i] * alpha;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          a = fmaf(p[jj], vs[(j + jj) * g.d + i * kFLanes + part], a);
        acc[i] = a;
      }
    }
  }
  if (l == 0.0f) l = 1.0f;
  if (lse != nullptr && part == 0 && row < g.sq)
    lse[static_cast<long long>(bh) * g.sq + row] = m + logf(l);
  if (row < g.sq) {
    float* orow = o + b * g.o_sb + h * g.o_sh + row * g.o_ss;
#pragma unroll
    for (int i = 0; i < kFDims; ++i)
      if (i < dpt) orow[i * kFLanes + part] = acc[i] / l;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Geom& g, int batch, cudaStream_t stream) {
  const int smem = 2 * kFBN * g.d * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.sq + kFRows - 1) / kFRows, batch * g.hq);
  flash_attn_f32<<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k and v (b, hkv, sk, d), o (b, hq, sq, d), each with
// its (batch, head, sequence) strides in elements and the last dimension
// contiguous. dtype: 0 float32, 1 bfloat16. window <= 0: none. vec16: every
// bf16 row start is 16-byte aligned (16-byte loads). lse: null, or a
// contiguous (b, hq, sq) float32 buffer for each row's log-sum-exp. Returns
// the cudaError_t of the launch (0 on success); the wrapper checks shapes
// and types.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int hq, int hkv,
                           int sq, int sk, int d, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, int causal,
                           int window, float scale, int vec16, void* lse,
                           void* stream) {
  Geom g{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, hq, hq / hkv, sq, sk, d, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return launch_f32(q, k, v, o, l, g, batch, s);
  if (d <= 32) return launch_bf16<32>(q, k, v, o, l, g, batch, vec16, s);
  if (d <= 64) return launch_bf16<64>(q, k, v, o, l, g, batch, vec16, s);
  return launch_bf16<128>(q, k, v, o, l, g, batch, vec16, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
