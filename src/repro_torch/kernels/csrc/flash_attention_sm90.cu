// K3 for Hopper: flash attention forward (online softmax) in bf16 with TMA
// loads, a ring of shared-memory stages and wgmma, for head dims 120 and
// 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel), as flash_attention.cu does;
// this source serves bf16 with head_dim 120 or 128 and 16-byte-aligned
// pointers and strides (the dense models' prefill), and flash_attention.cu
// everything else (kernels/flash_attention/ops.py::choose_kernel).
//
// What it computes, per (batch, query head) and query row: softmax over the
// keys of (q·k) · sm_scale, masked by k < sk, causal q >= k (both counted
// from 0, top-left aligned) and window q - k < window, times V. Masked
// scores are the finite -1e30 and add exactly 0; the running max,
// denominator and accumulator are float32 and the denominator sums the
// unrounded p; P is rounded to bf16 before P·V; a denominator of 0 is
// replaced by 1 and the output is cast to bf16. The semantics of
// flash_attention.cu, with one change of arithmetic: the softmax runs in
// base 2 (scores scaled by __fmul_rn with sm_scale · log2(e), then exp2f),
// which moved no reading of the checks in chip_smoke.py (PERF.md).
//
// Design:
//   * One CTA per (128 query rows, batch·query head), the longest rows
//     first. Three warpgroups: warpgroup 0 is the producer (one thread issues
//     every TMA load; setmaxnreg gives its registers to the consumers),
//     warpgroups 1 and 2 are consumers, each owning 64 query rows (wgmma's
//     M).
//   * TMA: 4-D tensor maps (d, s, h, b) over the caller's strided views, so
//     the model's (b, h, t, d) transposes of (b, t, h, d) projections are
//     read with no copy; kv maps are indexed by kv head h / (hq / hkv).
//     Boxes of 64 dims x 128 rows land 128-byte swizzled; d = 128 is two
//     boxes. Rows past sq / sk and dims 120..127 at d = 120 come from TMA's
//     zero fill; nothing is padded in device memory.
//   * Q is loaded once. K and V tiles of 128 keys x 128 dims stream through
//     a ring of kStages stages, each with full barriers for K and for V and
//     one empty barrier that every consumer thread arrives on.
//   * S = Q·Kᵀ: 8 wgmma m64n128k16, both operands K-major in shared memory.
//     Softmax in registers (4 threads share a row, as in mma.sync's layout).
//     O += P·V: 8 wgmma m64n128k16 with P as the register A operand (the
//     float32 S accumulator converts in registers to the bf16 A fragment)
//     and V read as an MN-major B operand through the descriptor's
//     transpose, so V is never transposed in shared memory.
//   * Within a consumer warpgroup, block i's S and block i - 1's P·V are
//     issued together; the softmax of block i runs while P·V of block i - 1
//     is on the tensor cores, and the accumulator is rescaled after it.
//   * Blocks wholly past the causal diagonal or before the window are
//     skipped; only blocks that cross a mask edge compute the mask.
//   * Optional: each query row's log-sum-exp in natural units of
//     s · sm_scale, (m + log2(l)) · ln 2, for the backward kernel
//     (flash_attention_bwd.cu); written after the output, it moves none of
//     its bits.
//
// Bound on an H100 at the model's shape (b = 1, 32 query / 8 kv heads,
// T = 8192, d = 128, causal): operations. 4·b·hq·d·T(T+1)/2 = 5.5e11 bf16
// tensor-core FLOP take 0.556 ms at 989 TFLOP/s; Q, K, V and O are 151 MB,
// 0.045 ms at 3.35 TB/s. Not done yet (PERF.md has the measured time):
// ping-pong scheduling of the two consumer warpgroups, so that one's softmax
// always overlaps the other's products, and a persistent grid.
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 128;            // query rows a CTA
constexpr int kBN = 128;            // keys a kv block
constexpr int kStages = 3;
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kBox = 128 * 64 * 2;  // bytes of one 64-dim x 128-row box
constexpr int kTile = 2 * kBox;     // 128 rows x 128 dims
constexpr int kQOff = 0;
constexpr int kKOff = kTile;                              // + stage * 2 tiles
constexpr int kBarOff = kTile + kStages * 2 * kTile;
constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;   // + align

struct Geom {
  long long o_sb, o_sh, o_ss;
  int hq, group;          // group = hq / hkv
  int sq, sk, d;
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
flash_attn_sm90(const __grid_constant__ CUtensorMap tq,
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
  auto k_tile = [&](int s) { return smem + kKOff + s * 2 * kTile; };
  auto v_tile = [&](int s) { return smem + kKOff + s * 2 * kTile + kTile; };

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTile);
      tma_load(smem + kQOff, &tq, q_full, 0, q0, h, b);
      tma_load(smem + kQOff + kBox, &tq, q_full, 64, q0, h, b);
      for (int i = 0; i < kb1 - kb0; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const int k0 = (kb0 + i) * kBN;
        mbar_expect_tx(k_full(s), kTile);
        tma_load(k_tile(s), &tk, k_full(s), 0, k0, kvh, b);
        tma_load(k_tile(s) + kBox, &tk, k_full(s), 64, k0, kvh, b);
        mbar_expect_tx(v_full(s), kTile);
        tma_load(v_tile(s), &tv, v_full(s), 0, k0, kvh, b);
        tma_load(v_tile(s) + kBox, &tv, v_full(s), 64, k0, kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                       // rows [64 cw, 64 cw + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const int row0 = qw0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
    const unsigned char* q_base = smem + kQOff + cw * 64 * 128;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    const int n_kb = kb1 - kb0;

    // S = Q·Kᵀ of the kv block in stage s, issued and committed.
    auto issue_s = [&](float (&sc)[64], int s) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // dims [16 kk, 16 kk + 16): box kk / 4, 32 bytes a step within it
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_ss(sc, smem_desc(q_base + off, 16, 1024),
                 smem_desc(k_tile(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P·V of the kv block in stage s, issued and committed.
    auto issue_pv = [&](const uint32_t (&pf)[8][4], int s) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // keys [16 kk, 16 kk + 16): two 8-row groups of both 64-dim boxes
        wgmma_rs(acc, pf[kk],
                 smem_desc(v_tile(s) + kk * 16 * 128, kBox, 1024));
      }
      wgmma_commit();
    };
    // The online softmax of the block of keys [k0, k0 + kBN), in base 2
    // (sc becomes s · sm_scale · log2(e)): updates m and l, leaves P,
    // rounded to bf16, in pn and the accumulator's rescale factors in al.
    auto softmax = [&](float (&sc)[64], int k0, uint32_t (&pn)[8][4],
                       float& al0, float& al1) {
      const bool masked = needs_mask(g, qw0, 64, k0, kBN);
      uint64_t valid = ~0ull;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(sc[4 * nt + e], g.scale_log2);
          if (masked &&
              !key_ok(g, e < 2 ? row0 : row1, k0 + nt * 8 + 2 * tg + (e & 1))) {
            x = kNegInf;
            valid &= ~(1ull << (4 * nt + e));
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
      for (int nt = 0; nt < 16; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (valid >> (4 * nt + e)) & 1ull
                     ? exp2f(sc[4 * nt + e] - (e < 2 ? mx0 : mx1)) : 0.0f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        pn[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pn[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    };
    // Block i >= 1: S of block i, then P·V of block i - 1 (its P in pf)
    // behind it, so that the tensor cores run block i - 1's product while
    // this warpgroup's softmax of block i runs; block i's P goes to pn.
    // Straight-line code between the two waits, and P in two buffers that
    // take turns (no copy), so that the compiler keeps the products
    // asynchronous.
    auto step = [&](int i, const uint32_t (&pf)[8][4], uint32_t (&pn)[8][4]) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      float sc[64];
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
      for (int nt = 0; nt < 16; ++nt) {
        acc[4 * nt + 0] *= al0;
        acc[4 * nt + 1] *= al0;
        acc[4 * nt + 2] *= al1;
        acc[4 * nt + 3] *= al1;
      }
    };
    // The last block's P·V.
    auto last_pv = [&](const uint32_t (&pf)[8][4]) {
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
    uint32_t pa[8][4], pb[8][4];
    if (n_kb > 0) {               // block 0: S, softmax (O is still 0)
      float sc[64];
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
    for (int nt = 0; nt < 16; ++nt) {
      const int col = nt * 8 + 2 * tg;
      if (col >= g.d) continue;
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

// q (b, hq, sq, d), k and v (b, hkv, sk, d), o (b, hq, sq, d), all bf16,
// each with its (batch, head, sequence) strides in elements and the last
// dimension contiguous; d is 120 or 128; every base pointer is 16-byte
// aligned and every stride a multiple of 8 elements. window <= 0: none.
// scale_log2 is sm_scale · log2(e): the softmax runs in base 2. lse: null,
// or a contiguous (b, hq, sq) float32 buffer for each row's log-sum-exp in
// natural units.
// Returns 0 on success, the cudaError_t of the launch, or kEncodeError plus
// the CUresult of a failed tensor-map encoding; the wrapper checks shapes,
// types and alignment.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, int batch, int hq, int hkv, int sq,
                                int sk, int d, long long q_sb, long long q_sh,
                                long long q_ss, long long k_sb, long long k_sh,
                                long long k_ss, long long v_sb, long long v_sh,
                                long long v_ss, long long o_sb, long long o_sh,
                                long long o_ss, int causal, int window,
                                float scale_log2, void* lse, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, batch, hq, sq, d, q_sb, q_sh, q_ss, kBM);
  if (err == 0)
    err = encode(&tk, k, batch, hkv, sk, d, k_sb, k_sh, k_ss, kBN);
  if (err == 0)
    err = encode(&tv, v, batch, hkv, sk, d, v_sb, v_sh, v_ss, kBN);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attn_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  Geom g{o_sb, o_sh, o_ss, hq, hq / hkv, sq, sk, d, causal, window,
         scale_log2};
  const dim3 grid((sq + kBM - 1) / kBM, batch * hq);
  flash_attn_sm90<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), g);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
