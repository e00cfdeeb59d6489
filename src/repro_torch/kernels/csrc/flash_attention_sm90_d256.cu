// K3 for Hopper at head_dim 256: flash attention forward (online softmax) in
// bf16 with TMA loads, rings of shared-memory stages and wgmma, K and V
// shared by a cluster of two CTAs, on a persistent grid.
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
// log2(l)) · ln 2, for a backward kernel. The walk over 64-key blocks, the
// products and their order are those of the kernel's first design (one
// CTA a tile, both consumers in step), so the output and lse are its bits
// at every shape.
//
// Design. At d = 256 a 64-row wgmma tile's O accumulator is 128 float32
// registers a consumer thread, and one 128 x 256 bf16 tile is 64 KB, so:
//   * A tile is (128 query rows, batch, query head). Warpgroup 0 is the
//     producer (one thread issues every TMA load; setmaxnreg lowers it to
//     24 registers), warpgroups 1 and 2 are consumers (raised to 240), each
//     owning 64 query rows.
//   * Q (128 x 256, 64 KB) has one buffer; K and V tiles of 64 keys x 256
//     dims (32 KB each) stream through rings of their own, kKStages and
//     kVStages deep: 192 KB of shared memory. Every tile is boxes of 64
//     dims x rows, 128-byte swizzled, from 4-D tensor maps (d, s, h, b) over
//     the caller's strided views; rows past sq / sk come from TMA's zero
//     fill. The producer loads K one block ahead of V (K of block i + 1
//     before V of block i), and the consumers free a K stage as soon as S
//     is done with it, a V stage when P·V is.
//   * S = Q·Kᵀ: 16 wgmma m64n64k16 (32 accumulator registers), both
//     operands K-major in shared memory. O += P·V: 4 wgmma m64n256k16 with
//     P as the register A operand and V read MN-major through the
//     descriptor's transpose. Each block: S of block i is issued, O is
//     rescaled by block i - 1's factors while it runs, P·V of block i - 1
//     is issued behind it, block i's softmax runs while that P·V is on the
//     tensor cores, and block i's P is packed to bf16 once the P·V is done
//     (one P buffer). Blocks wholly past the causal diagonal or before the
//     window are skipped; only blocks that cross a mask edge test keys,
//     against each row's [lo, hi) key bounds, and only they pay the
//     masked keys' select in the exponentials (the softmax lies on each
//     step's critical path).
//   * No ping-pong: the two consumers issuing their products in turns on
//     named barriers measured no faster at d = 256 in any build tried
//     (PERF.md), so both consumers walk the blocks in step.
//   * Shared K and V: where two query heads read the same kv head (a group
//     of two or more), a cluster of two CTAs takes the same query block of
//     the pair, and each CTA's producer loads half of every K and V tile,
//     multicast to both (.multicast::cluster); a stage is free once all
//     four consumer warpgroups of the pair have released it. The heads of a
//     group left without a partner (the last of an odd group; every head
//     where hq = hkv) are solo tiles: one CTA loads its own K and V.
//   * Persistent grid: one CTA or cluster an SM (the wrapper sizes the
//     grid), walking the shared tiles a cluster at a time, then the solo
//     tiles a CTA at a time, longest query rows first, in a snake order
//     over the grid. Q has a barrier for its release, so the producer
//     loads the next tile's Q and first K and V blocks while the consumers
//     finish a tile's last P·V and store its output.
//
// Bound on an H100 at recurrentgemma-2b's layer shape (b = 1, 10 query /
// 1 kv head, T = 8192, d = 256, causal, window 2048): operations. Each
// query sees min(q + 1, 2048) keys, 14,681,088 (q, k) pairs, and 4·d FLOP a
// pair over 10 heads is 1.503e11 bf16 tensor-core FLOP: 0.152 ms at 989
// TFLOP/s. Q, K, V and O are 92.3 MB, 0.028 ms at 3.35 TB/s. Measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W (benchmarks_torch/k3_fwd_bits.py,
// in turns with the first design): 0.3616 ms (0.3635, 0.3597), 42% of
// the bound, against the first design's 0.5121 (0.5128, 0.5114). What
// holds it, part by part: benchmarks_torch/k3_d256_variants.py and
// PERF.md; chiefly the softmax, on each block's critical path.
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kD = 256;
constexpr int kBM = 128;              // query rows a CTA
constexpr int kBN = 64;               // keys a kv block
constexpr int kKStages = 2;
constexpr int kVStages = 2;
constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBoxQ = 128 * 128;      // bytes of a 64-dim x 128-row box
constexpr int kBoxKV = 64 * 128;      // bytes of a 64-dim x 64-row box
constexpr int kTileQ = 4 * kBoxQ;     // 128 rows x 256 dims
constexpr int kTileKV = 4 * kBoxKV;   // 64 rows x 256 dims
constexpr int kQOff = 0;
constexpr int kKOff = kTileQ;
constexpr int kVOff = kKOff + kKStages * kTileKV;
constexpr int kBarOff = kVOff + kVStages * kTileKV;
constexpr int kBars = 2 + 2 * kKStages + 2 * kVStages;
constexpr int kSmem = kBarOff + 8 * kBars + 1024;   // + align

struct Geom {
  long long o_sb, o_sh, o_ss;
  int batch, hq, hkv, group;  // group = hq / hkv
  int sq, sk;
  int causal, window;         // window <= 0: no window
  float scale_log2;           // sm_scale · log2(e)
  int cs;                     // CTAs a cluster, 1 or 2
  int n_qb;                   // query blocks of kBM rows
  int pairs;                  // head pairs a kv head (0 when cs = 1)
  int n_shared, n_solo;       // tiles of each kind
};

struct Tile {
  int q0, b, h, kvh;
  bool shared;                // K and V loaded by both CTAs of the cluster
};

// Worker k of p takes tile r·p + k in even rounds r and r·p + p - 1 - k in
// odd ones: a snake, so that the longest tiles (the lowest t) and the
// shortest even out.
__device__ __forceinline__ int snake(int r, int k, int p) {
  return r * p + ((r & 1) ? p - 1 - k : k);
}

// The w-th tile this CTA works: its cluster's shared tiles (worker cluster
// of the clusters), then its own solo tiles (worker cta of the ctas); in
// each kind, t counts the query blocks from the last (the longest rows)
// and, within one, the batch, kv head and pair or lone head. False when
// the walk is over.
__device__ __forceinline__ bool tile_at(const Geom& g, int w, int rank,
                                        Tile* tl) {
  const int cluster = blockIdx.x / g.cs, clusters = gridDim.x / g.cs;
  const int rounds = g.n_shared / clusters;
  const int mine = rounds + (snake(rounds, cluster, clusters) < g.n_shared);
  if (w < mine) {
    const int t = snake(w, cluster, clusters);
    const int per_q = g.batch * g.hkv * g.pairs;
    const int u = t % per_q, p = u % (g.hkv * g.pairs);
    tl->q0 = (g.n_qb - 1 - t / per_q) * kBM;
    tl->b = u / (g.hkv * g.pairs);
    tl->kvh = p / g.pairs;
    tl->h = tl->kvh * g.group + 2 * (p % g.pairs) + rank;
    tl->shared = true;
    return true;
  }
  const int t = snake(w - mine, blockIdx.x, gridDim.x);
  if (t >= g.n_solo) return false;
  const int lone = g.group - 2 * g.pairs;   // heads a kv head without partner
  const int per_q = g.batch * g.hkv * lone;
  const int u = t % per_q, r = u % (g.hkv * lone);
  tl->q0 = (g.n_qb - 1 - t / per_q) * kBM;
  tl->b = u / (g.hkv * lone);
  tl->kvh = r / lone;
  tl->h = tl->kvh * g.group + 2 * g.pairs + r % lone;
  tl->shared = false;
  return true;
}

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

// ------------------------------------------------------------- clusters --
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar` in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// `count` arrivals on this CTA's mbarrier at `bar`.
__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// A TMA tile load into the same shared offset of every CTA in `mask`,
// counted by the mbarrier at the same offset in each.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2, int c3,
                                                   uint16_t mask) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      ::"r"(d), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
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
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + kKStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + 2 * kKStages + s); };
  auto v_empty = [&](int s) {
    return bars + 8 * (2 + 2 * kKStages + kVStages + s);
  };
  auto k_tile = [&](int s) { return smem + kKOff + s * kTileKV; };
  auto v_tile = [&](int s) { return smem + kVOff + s * kTileKV; };
  const int rank = static_cast<int>(blockIdx.x) % g.cs;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    // a stage is free when every consumer warp of the CTAs that load it has
    // released it: one arrival from each in a shared tile, cs from each of
    // this CTA's in a solo tile
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps * g.cs);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumerWarps * g.cs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();             // every CTA's barriers initialised

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // One K or V tile of 64 keys from k0 into its stage: half of it from
      // each CTA, to both, in a shared tile; all of it in a solo one.
      auto stage_in = [&](const CUtensorMap* map, unsigned char* dst,
                          uint32_t full, uint32_t empty, int it, int stages,
                          int k0, const Tile& tl) {
        mbar_wait(empty, ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full, kTileKV);
        if (tl.shared) {
          for (int j = 2 * rank; j < 2 * rank + 2; ++j)
            tma_load_multicast(dst + j * kBoxKV, map, full, 64 * j, k0,
                               tl.kvh, tl.b, 0x3);
        } else {
          for (int j = 0; j < 4; ++j)
            tma_load(dst + j * kBoxKV, map, full, 64 * j, k0, tl.kvh, tl.b);
        }
      };
      int kit = 0;            // kv blocks loaded before this tile
      Tile tl;
      for (int w = 0; tile_at(g, w, rank, &tl); ++w) {
        int kb0, kb1;
        kv_range(g, tl.q0, kBM, kBN, &kb0, &kb1);
        const int n_kb = kb1 - kb0;
        if (w > 0) mbar_wait(q_empty, (w - 1) & 1);
        mbar_expect_tx(q_full, kTileQ);
        for (int j = 0; j < 4; ++j)
          tma_load(smem + kQOff + j * kBoxQ, &tq, q_full, 64 * j, tl.q0,
                   tl.h, tl.b);
        for (int i = 0; i <= n_kb; ++i) {   // K of block i, V of block i - 1
          if (i < n_kb) {
            const int it = kit + i, s = it % kKStages;
            stage_in(&tk, k_tile(s), k_full(s), k_empty(s), it, kKStages,
                     (kb0 + i) * kBN, tl);
          }
          if (i > 0) {
            const int it = kit + i - 1, s = it % kVStages;
            stage_in(&tv, v_tile(s), v_full(s), v_empty(s), it, kVStages,
                     (kb0 + i - 1) * kBN, tl);
          }
        }
        kit += n_kb;
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                       // rows [64 cw, 64 cw + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const unsigned char* q_base = smem + kQOff + cw * 64 * 128;

    // S = Q·Kᵀ of the kv block in K stage s, issued and committed.
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

    int kit = 0;              // kv blocks consumed before this tile
    Tile tl;
    for (int w = 0; tile_at(g, w, rank, &tl); ++w) {
      int kb0, kb1;
      kv_range(g, tl.q0, kBM, kBN, &kb0, &kb1);
      const int n_kb = kb1 - kb0;
      const int qw0 = tl.q0 + 64 * cw;
      const int row0 = qw0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
      // the keys rows row0 and row1 may see, [lo, hi): below sk, not past
      // the row when causal, less than the window behind it
      const int lo0 = g.window > 0 ? row0 - g.window + 1 : 0;
      const int lo1 = lo0 + (g.window > 0 ? 8 : 0);
      const int hi0 = g.causal ? min(g.sk, row0 + 1) : g.sk;
      const int hi1 = g.causal ? min(g.sk, row1 + 1) : g.sk;

      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
      uint32_t pf[4][4];          // P of the block whose P·V is next

      // This warp's release of a stage: one arrival in each CTA that loads
      // it.
      auto release = [&](uint32_t bar) {
        if (lane == 0) {
          if (tl.shared) {
            mbar_arrive_at(bar, 0);
            mbar_arrive_at(bar, 1);
          } else {
            mbar_arrive_n(bar, g.cs);
          }
        }
      };
      auto release_q = [&]() {
        if (lane == 0) mbar_arrive(q_empty);
      };
      // O += P·V of the kv block in V stage s, issued and committed.
      auto issue_pv = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // keys [16 kk, 16 kk + 16) of all four 64-dim boxes
          wgmma_rs_n256(acc, pf[kk],
                        smem_desc(v_tile(s) + kk * 16 * 128, kBoxKV, 1024));
        }
        wgmma_commit();
      };
      // The online softmax of the block of keys [k0, k0 + kBN), in base 2:
      // updates m and l, leaves the unrounded P in sc and the
      // accumulator's rescale factors in al.
      auto softmax = [&](float (&sc)[32], int k0, float& al0, float& al1) {
        const bool masked = needs_mask(g, qw0, 64, k0, kBN);
        uint32_t valid = ~0u;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(sc[4 * nt + e], g.scale_log2);
            const int col = k0 + nt * 8 + 2 * tg + (e & 1);
            if (masked && (col < (e < 2 ? lo0 : lo1) ||
                           col >= (e < 2 ? hi0 : hi1))) {
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
        if (masked) {             // a masked key's p is 0, not exp2f(0)
#pragma unroll
          for (int j = 0; j < 32; ++j)
            sc[j] = (valid >> j) & 1u
                        ? exp2f(sc[j] - ((j & 2) ? mx1 : mx0)) : 0.0f;
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            sc[j] = exp2f(sc[j] - ((j & 2) ? mx1 : mx0));
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          l0 += sc[4 * nt] + sc[4 * nt + 1];
          l1 += sc[4 * nt + 2] + sc[4 * nt + 3];
        }
      };
      // P, rounded to bf16, into the A fragments of P·V, once the last
      // P·V that read them is done.
      auto pack_p = [&](const float (&sc)[32]) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
          pf[nt / 2][(nt & 1) * 2 + 1] =
              pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);
        }
      };
      // O rescaled by the last softmax's factors (block i - 1's, before
      // its P·V is added: the order of the first design's rescale after
      // block i - 2's P·V, so the same products in the same order).
      float al0, al1;
      auto rescale = [&]() {
#pragma unroll
        for (int nt = 0; nt < 32; ++nt) {
          acc[4 * nt + 0] *= al0;
          acc[4 * nt + 1] *= al0;
          acc[4 * nt + 2] *= al1;
          acc[4 * nt + 3] *= al1;
        }
      };
      // Block i >= 1: S of block i, O rescaled by block i - 1's factors
      // while it runs, then P·V of block i - 1 behind it; block i's
      // softmax while that P·V runs, and its P packed once that P·V is
      // done. Straight-line code between the waits, so that the compiler
      // keeps the products asynchronous.
      // (Leaving P·V running into the next block, to keep the tensor cores
      // fed through the rescale, makes ptxas serialize the products: the
      // rescale then writes O while a product group is open.)
      auto step = [&](int i) {
        const int ki = kit + i, vi = kit + i - 1;
        const int ks = ki % kKStages, vs = vi % kVStages;
        float sc[32];
        mbar_wait(k_full(ks), (ki / kKStages) & 1);
        wgmma_fence();
        issue_s(sc, ks);
        rescale();                // while S runs
        mbar_wait(v_full(vs), (vi / kVStages) & 1);
        fence_acc(acc);
        wgmma_fence();
        issue_pv(vs);
        wgmma_wait<1>();          // S is done; P·V may still run
        fence_acc(sc);
        release(k_empty(ks));
        if (i == n_kb - 1) release_q();
        softmax(sc, (kb0 + i) * kBN, al0, al1);
        wgmma_wait<0>();          // block i - 1's P·V is done
        fence_acc(acc);
        release(v_empty(vs));
        pack_p(sc);
      };
      // The last block's P·V.
      auto last_pv = [&]() {
        const int vi = kit + n_kb - 1, vs = vi % kVStages;
        mbar_wait(v_full(vs), (vi / kVStages) & 1);
        rescale();
        fence_acc(acc);
        wgmma_fence();
        issue_pv(vs);
        wgmma_wait<0>();
        fence_acc(acc);
        release(v_empty(vs));
      };

      mbar_wait(q_full, w & 1);
      if (n_kb > 0) {             // block 0: S, softmax (O is still 0)
        const int ks = kit % kKStages;
        float sc[32];
        mbar_wait(k_full(ks), (kit / kKStages) & 1);
        wgmma_fence();
        issue_s(sc, ks);
        wgmma_wait<0>();
        fence_acc(sc);
        release(k_empty(ks));
        if (n_kb == 1) release_q();
        softmax(sc, kb0 * kBN, al0, al1);
        pack_p(sc);
      } else {
        release_q();
      }
#pragma unroll 1
      for (int i = 1; i < n_kb; ++i) step(i);
      if (n_kb > 0) last_pv();
      kit += n_kb;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (l0 == 0.0f) l0 = 1.0f;
      if (l1 == 0.0f) l1 = 1.0f;
      if (lse != nullptr && tg == 0) {
        constexpr float kLn2 = 0.693147180559945309f;
        float* lp = lse + (static_cast<long long>(tl.b) * g.hq + tl.h) * g.sq;
        if (row0 < g.sq) lp[row0] = (m0 + log2f(l0)) * kLn2;
        if (row1 < g.sq) lp[row1] = (m1 + log2f(l1)) * kLn2;
      }
      __nv_bfloat16* op = o + tl.b * g.o_sb + tl.h * g.o_sh;
#pragma unroll
      for (int nt = 0; nt < 32; ++nt) {
        const int col = nt * 8 + 2 * tg;
        if (row0 < g.sq)
          *reinterpret_cast<__nv_bfloat162*>(op + row0 * g.o_ss + col) =
              __floats2bfloat162_rn(acc[4 * nt] / l0, acc[4 * nt + 1] / l0);
        if (row1 < g.sq)
          *reinterpret_cast<__nv_bfloat162*>(op + row1 * g.o_ss + col) =
              __floats2bfloat162_rn(acc[4 * nt + 2] / l1,
                                    acc[4 * nt + 3] / l1);
      }
    }
  }
  cluster_sync();             // no CTA leaves while its partner may still
                              // arrive on its barriers
}

Geom geometry(int batch, int hq, int hkv, int sq, int sk, long long o_sb,
              long long o_sh, long long o_ss, int causal, int window,
              float scale_log2, int cs) {
  const int group = hq / hkv;
  const int pairs = cs == 2 ? group / 2 : 0;
  const int n_qb = (sq + kBM - 1) / kBM;
  return Geom{o_sb, o_sh, o_ss, batch, hq, hkv, group, sq, sk, causal,
              window, scale_log2, cs, n_qb, pairs,
              n_qb * batch * hkv * pairs,
              n_qb * batch * hkv * (group - 2 * pairs)};
}

cudaLaunchConfig_t launch_config(int ctas, int cs, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// q (b, hq, sq, 256), k and v (b, hkv, sk, 256), o (b, hq, sq, 256), all
// bf16, each with its (batch, head, sequence) strides in elements and the
// last dimension contiguous; every base pointer is 16-byte aligned and every
// stride a multiple of 8 elements. window <= 0: none. scale_log2 is
// sm_scale · log2(e): the softmax runs in base 2. lse: null, or a contiguous
// (b, hq, sq) float32 buffer for each row's log-sum-exp in natural units.
// cluster (1, or 2 where hq / hkv >= 2) is the CTAs a cluster; ctas, a
// multiple of it, the grid that walks the tiles. Returns 0 on success, the
// cudaError_t of the launch, or kEncodeError plus the CUresult of a failed
// tensor-map encoding; the wrapper checks shapes, types and alignment.
int flash_attention_sm90_d256_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int sq, int sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale_log2, void* lse,
    int cluster, int ctas, void* stream) {
  if ((cluster != 1 && cluster != 2) || (cluster == 2 && hq / hkv < 2) ||
      ctas < cluster || ctas % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const Geom g = geometry(batch, hq, hkv, sq, sk, o_sb, o_sh, o_ss, causal,
                          window, scale_log2, cluster);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(
      ctas, cluster, static_cast<cudaStream_t>(stream), &attr);
  cerr = cudaLaunchKernelEx(&cfg, flash_attn_sm90_d256, tq, tk, tv,
                            static_cast<__nv_bfloat16*>(o),
                            static_cast<float*>(lse), g);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` CTAs the current device holds at once with
// this kernel's shared memory: the persistent grid's size in clusters.
// Returns it, or minus the cudaError_t of the query.
int flash_attention_sm90_d256_slots(int cluster) {
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attn_sm90_d256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, cluster, nullptr, &attr);
  int n = 0;
  cerr = cudaOccupancyMaxActiveClusters(&n, flash_attn_sm90_d256, &cfg);
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  return n;
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
