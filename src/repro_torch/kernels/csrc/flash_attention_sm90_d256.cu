// K3 for Hopper at head_dim 256: flash attention forward (online softmax) in
// bf16 with TMA loads, a ring of shared-memory stages and wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel) at the one head_dim that
// flash_attention_sm90.cu (120, 128) and flash_attention.cu (up to 128) do
// not take: bf16 with d = 256 and 16-byte-aligned pointers and strides,
// recurrentgemma-2b's local attention
// (kernels/flash_attention/ops.py::choose_kernel).
//
// What it computes: that of flash_attention_sm90.cu, bit for bit the same
// arithmetic a row: softmax over the keys of (q·k) · sm_scale in base 2
// (scores scaled by __fmul_rn with sm_scale · log2(e), then exp2f), masked
// by k < sk, causal q >= k and window q - k < window; masked scores are the
// finite -1e30 and add exactly 0; the running max, denominator and
// accumulator are float32, the denominator sums the unrounded p, P is
// rounded to bf16 before P·V, a denominator of 0 is replaced by 1, and the
// output is cast to bf16. Optionally each row's log-sum-exp, (m +
// log2(l)) · ln 2, for a backward kernel.
//
// Design. At d = 256 the d <= 128 layout does not fit: a 64-row wgmma
// tile's O accumulator is 128 float32 registers a consumer thread, and one
// 128 x 256 bf16 tile is 64 KB, so 128-key blocks in 3 stages would need
// 448 KB of shared memory. So:
//   * One CTA per (128 query rows, batch·query head), the longest rows
//     first. Warpgroup 0 is the producer (one thread issues every TMA load;
//     setmaxnreg lowers it to 24 registers), warpgroups 1 and 2 are
//     consumers (raised to 240), each owning 64 query rows.
//   * Q (128 x 256, 64 KB) loads once; K and V tiles of 64 keys x 256 dims
//     (32 KB each) stream through 2 stages: 192 KB of shared memory. Every
//     tile is boxes of 64 dims x rows, 128-byte swizzled, from 4-D tensor
//     maps (d, s, h, b) over the caller's strided views; rows past sq / sk
//     come from TMA's zero fill.
//   * S = Q·Kᵀ: 16 wgmma m64n64k16 (32 accumulator registers), both
//     operands K-major in shared memory. O += P·V: 4 wgmma m64n256k16 with
//     P as the register A operand and V read MN-major through the
//     descriptor's transpose.
//   * As in flash_attention_sm90.cu, block i's S and block i - 1's P·V are
//     issued together, so that the softmax of block i runs while P·V of
//     block i - 1 is on the tensor cores; blocks wholly past the causal
//     diagonal or before the window are skipped, and only blocks that cross
//     a mask edge compute the mask.
//
// Bound on an H100 at recurrentgemma-2b's layer shape (b = 1, 10 query /
// 1 kv head, T = 8192, d = 256, causal, window 2048): operations. Each
// query sees min(q + 1, 2048) keys, 14,681,088 (q, k) pairs, and 4·d FLOP a
// pair over 10 heads is 1.503e11 bf16 tensor-core FLOP: 0.152 ms at 989
// TFLOP/s. Q, K, V and O are 92.3 MB, 0.028 ms at 3.35 TB/s. Not done yet
// (PERF.md has the measured time): ping-pong of the two consumers and a
// persistent grid.
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kD = 256;
constexpr int kBM = 128;              // query rows a CTA
constexpr int kBN = 64;               // keys a kv block
constexpr int kStages = 2;
constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kBoxQ = 128 * 128;      // bytes of a 64-dim x 128-row box
constexpr int kBoxKV = 64 * 128;      // bytes of a 64-dim x 64-row box
constexpr int kTileQ = 4 * kBoxQ;     // 128 rows x 256 dims
constexpr int kTileKV = 4 * kBoxKV;   // 64 rows x 256 dims
constexpr int kQOff = 0;
constexpr int kKOff = kTileQ;                              // + stage * 2 tiles
constexpr int kBarOff = kTileQ + kStages * 2 * kTileKV;
constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;   // + align

struct Geom {
  long long o_sb, o_sh, o_ss;
  int hq, group;          // group = hq / hkv
  int sq, sk;
  int causal, window;     // window <= 0: no window
  float scale_log2;       // sm_scale · log2(e)
};

__device__ __forceinline__ void kv_range(const Geom& g, int q0, int bm,
                                         int bn, int* kb0, int* kb1) {
  int hi = g.sk;
  if (g.causal) hi = min(hi, q0 + bm);
  int lo = 0;
  if (g.window > 0) lo = max(0, q0 - g.window + 1);
  *kb0 = lo / bn;
  *kb1 = hi > lo ? (hi + bn - 1) / bn : *kb0;
}

__device__ __forceinline__ bool needs_mask(const Geom& g, int q0, int bm,
                                           int k0, int bn) {
  return k0 + bn > g.sk || (g.causal && k0 + bn - 1 > q0) ||
         (g.window > 0 && (q0 + bm - 1) - k0 >= g.window);
}

__device__ __forceinline__ bool key_ok(const Geom& g, int row, int col) {
  return col < g.sk && (!g.causal || row >= col) &&
         (g.window <= 0 || row - col < g.window);
}

// ----------------------------------------------------------------- kernel --
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_sm90_d256(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     Geom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kBarOff));
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return smem + kKOff + s * 2 * kTileKV; };
  auto v_tile = [&](int s) {
    return smem + kKOff + s * 2 * kTileKV + kTileKV;
  };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / g.hq, h = bh % g.hq, kvh = h / g.group;
  int kb0, kb1;
  kv_range(g, q0, kBM, kBN, &kb0, &kb1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileQ);
      for (int j = 0; j < 4; ++j)
        tma_load(smem + kQOff + j * kBoxQ, &tq, q_full, 64 * j, q0, h, b);
      for (int i = 0; i < kb1 - kb0; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const int k0 = (kb0 + i) * kBN;
        mbar_expect_tx(k_full(s), kTileKV);
        for (int j = 0; j < 4; ++j)
          tma_load(k_tile(s) + j * kBoxKV, &tk, k_full(s), 64 * j, k0, kvh, b);
        mbar_expect_tx(v_full(s), kTileKV);
        for (int j = 0; j < 4; ++j)
          tma_load(v_tile(s) + j * kBoxKV, &tv, v_full(s), 64 * j, k0, kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                       // rows [64 cw, 64 cw + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const int row0 = qw0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
    const unsigned char* q_base = smem + kQOff + cw * 64 * 128;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    const int n_kb = kb1 - kb0;

    // S = Q·Kᵀ of the kv block in stage s, issued and committed.
    auto issue_s = [&](float (&sc)[32], int s) {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        // dims [16 kk, 16 kk + 16): box kk / 4, 32 bytes a step within it
        wgmma_ss_n64(sc,
                     smem_desc(q_base + (kk >> 2) * kBoxQ + (kk & 3) * 32, 16,
                               1024),
                     smem_desc(k_tile(s) + (kk >> 2) * kBoxKV + (kk & 3) * 32,
                               16, 1024),
                     kk > 0);
      }
      wgmma_commit();
    };
    // O += P·V of the kv block in stage s, issued and committed.
    auto issue_pv = [&](const uint32_t (&pf)[4][4], int s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys [16 kk, 16 kk + 16) of all four 64-dim boxes
        wgmma_rs_n256(acc, pf[kk],
                      smem_desc(v_tile(s) + kk * 16 * 128, kBoxKV, 1024));
      }
      wgmma_commit();
    };
    // The online softmax of the block of keys [k0, k0 + kBN), in base 2:
    // updates m and l, leaves P, rounded to bf16, in pn and the
    // accumulator's rescale factors in al.
    auto softmax = [&](float (&sc)[32], int k0, uint32_t (&pn)[4][4],
                       float& al0, float& al1) {
      const bool masked = needs_mask(g, qw0, 64, k0, kBN);
      uint32_t valid = ~0u;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(sc[4 * nt + e], g.scale_log2);
          if (masked &&
              !key_ok(g, e < 2 ? row0 : row1, k0 + nt * 8 + 2 * tg + (e & 1))) {
            x = kNegInf;
            valid &= ~(1u << (4 * nt + e));
          }
          sc[4 * nt + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
      // the four threads of a quad share rows row0 and row1
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      al0 = exp2f(m0 - mx0);
      al1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (valid >> (4 * nt + e)) & 1u
                     ? exp2f(sc[4 * nt + e] - (e < 2 ? mx0 : mx1)) : 0.0f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        pn[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pn[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    };
    // Block i >= 1: S of block i, then P·V of block i - 1 (its P in pf)
    // behind it; block i's P goes to pn. Straight-line code between the two
    // waits, and P in two buffers that take turns, so that the compiler
    // keeps the products asynchronous.
    auto step = [&](int i, const uint32_t (&pf)[4][4], uint32_t (&pn)[4][4]) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      float sc[32];
      float al0, al1;
      mbar_wait(k_full(s), (i / kStages) & 1);
      mbar_wait(v_full(sp), ((i - 1) / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(pf, sp);
      wgmma_wait<1>();            // S is done; P·V may still run
      fence_acc(sc);
      softmax(sc, (kb0 + i) * kBN, pn, al0, al1);
      wgmma_wait<0>();            // block i - 1's P·V is done
      fence_acc(acc);
      mbar_arrive(empty(sp));
#pragma unroll
      for (int nt = 0; nt < 32; ++nt) {
        acc[4 * nt + 0] *= al0;
        acc[4 * nt + 1] *= al0;
        acc[4 * nt + 2] *= al1;
        acc[4 * nt + 3] *= al1;
      }
    };
    // The last block's P·V.
    auto last_pv = [&](const uint32_t (&pf)[4][4]) {
      const int sp = (n_kb - 1) % kStages;
      mbar_wait(v_full(sp), ((n_kb - 1) / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
      issue_pv(pf, sp);
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty(sp));
    };

    mbar_wait(q_full, 0);
    uint32_t pa[4][4], pb[4][4];
    if (n_kb > 0) {               // block 0: S, softmax (O is still 0)
      float sc[32];
      float al0, al1;
      mbar_wait(k_full(0), 0);
      wgmma_fence();
      issue_s(sc, 0);
      wgmma_wait<0>();
      fence_acc(sc);
      softmax(sc, kb0 * kBN, pa, al0, al1);
    }
    int i = 1;
    for (; i + 1 < n_kb; i += 2) {
      step(i, pa, pb);
      step(i + 1, pb, pa);
    }
    if (i < n_kb) {               // block n_kb - 1 = i, its P in pb
      step(i, pa, pb);
      last_pv(pb);
    } else if (n_kb > 0) {        // block n_kb - 1 = i - 1, its P in pa
      last_pv(pa);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (l0 == 0.0f) l0 = 1.0f;
    if (l1 == 0.0f) l1 = 1.0f;
    if (lse != nullptr && tg == 0) {
      constexpr float kLn2 = 0.693147180559945309f;
      float* lp = lse + static_cast<long long>(bh) * g.sq;
      if (row0 < g.sq) lp[row0] = (m0 + log2f(l0)) * kLn2;
      if (row1 < g.sq) lp[row1] = (m1 + log2f(l1)) * kLn2;
    }
    __nv_bfloat16* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
    for (int nt = 0; nt < 32; ++nt) {
      const int col = nt * 8 + 2 * tg;
      if (row0 < g.sq)
        *reinterpret_cast<__nv_bfloat162*>(op + row0 * g.o_ss + col) =
            __floats2bfloat162_rn(acc[4 * nt] / l0, acc[4 * nt + 1] / l0);
      if (row1 < g.sq)
        *reinterpret_cast<__nv_bfloat162*>(op + row1 * g.o_ss + col) =
            __floats2bfloat162_rn(acc[4 * nt + 2] / l1, acc[4 * nt + 3] / l1);
    }
  }
}

}  // namespace

extern "C" {

// q (b, hq, sq, 256), k and v (b, hkv, sk, 256), o (b, hq, sq, 256), all
// bf16, each with its (batch, head, sequence) strides in elements and the
// last dimension contiguous; every base pointer is 16-byte aligned and every
// stride a multiple of 8 elements. window <= 0: none. scale_log2 is
// sm_scale · log2(e): the softmax runs in base 2. lse: null, or a contiguous
// (b, hq, sq) float32 buffer for each row's log-sum-exp in natural units.
// Returns 0 on success, the cudaError_t of the launch, or kEncodeError plus
// the CUresult of a failed tensor-map encoding; the wrapper checks shapes,
// types and alignment.
int flash_attention_sm90_d256_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int sq, int sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale_log2, void* lse,
    void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, batch, hq, sq, kD, q_sb, q_sh, q_ss, kBM);
  if (err == 0)
    err = encode(&tk, k, batch, hkv, sk, kD, k_sb, k_sh, k_ss, kBN);
  if (err == 0)
    err = encode(&tv, v, batch, hkv, sk, kD, v_sb, v_sh, v_ss, kBN);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attn_sm90_d256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  Geom g{o_sb, o_sh, o_ss, hq, hq / hkv, sq, sk, causal, window, scale_log2};
  const dim3 grid((sq + kBM - 1) / kBM, batch * hq);
  flash_attn_sm90_d256<<<grid, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), g);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
