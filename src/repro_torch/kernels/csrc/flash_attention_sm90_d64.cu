// K3 for Hopper at head_dim 64: flash attention forward (online softmax) in
// bf16 with TMA loads, rings of shared-memory stages and wgmma, its consumer
// warpgroups issuing their products in turns (ping-pong), on a persistent
// grid, with an optional split of the keys whose partial results a second
// kernel combines.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel) at the head_dim that
// flash_attention_sm90.cu (120, 128) and flash_attention_sm90_d256.cu (256)
// do not take: bf16 with d = 64 and 16-byte-aligned pointers and strides,
// whisper-small's encoder, decoder self- and cross-attention
// (kernels/flash_attention/ops.py::choose_kernel; d64_plan picks the launch).
//
// What it computes: the function of flash_attention_sm90.cu a row: softmax
// over the keys of (q·k) · sm_scale in base 2 (scores scaled by __fmul_rn
// with sm_scale · log2(e)), masked by k < sk, causal q >= k and window
// q - k < window, top-left aligned; masked scores are the finite -1e30 and
// add exactly 0; the running max, denominator and accumulator are float32,
// the denominator sums the unrounded p, P is rounded to bf16 before P·V, a
// denominator of 0 is replaced by 1, and the output is cast to bf16.
// Optionally each row's log-sum-exp in natural units, (m + log2(l)) · ln 2,
// for the backward kernel (flash_attention_bwd.cu). Its exponentials are
// ex2.approx.ftz (the MUFU's exp2, as exp2f without its rescale of results
// below 2^-126, which it flushes to 0).
//
// Design. At d = 64 a (query, key) pair is 4·64 = 256 tensor-core FLOP and
// one exponential: at 989 TFLOP/s and the MUFU's 16 exponentials a clock an
// SM (~3.9e12 a second) the two take the same time, so a warpgroup whose
// softmax runs between its own products reaches at most half the bound. The
// softmax of one warpgroup has to run under another's products:
//   * A CTA is kWG consumer warpgroups of 64 query rows each (kBM = 64·kWG
//     rows: 128 or 192, d64_plan picks) and one producer warpgroup (one
//     thread issues every TMA load; setmaxnreg lowers it to 24 registers and
//     raises the consumers to 240 or 160).
//   * Q (kBM x 64) is one TMA box of 64 dims x kBM rows; K and V tiles of
//     128 keys x 64 dims (16 KB, one box each) stream through rings of
//     kStages stages of their own, 128-byte swizzled, from 4-D tensor maps
//     (d, s, h, b) over the caller's strided views (kv head h / (hq / hkv)).
//     Rows past sq / sk come from TMA's zero fill; the producer loads K one
//     block ahead of V, and the consumers free a K stage once S is done with
//     it, a V stage once P·V is.
//   * S = Q·Kᵀ: 4 wgmma m64n128k16 (64 accumulator registers), both
//     operands K-major in shared memory. O += P·V: 8 wgmma m64n64k16 with
//     P as the register A operand and V read MN-major through the
//     descriptor's transpose (O is 32 registers a thread).
//   * Within a warpgroup, block i's S is issued with block i - 1's P·V
//     behind it, and block i's softmax runs while that P·V is on the tensor
//     cores. Across warpgroups (ping-pong), a named barrier a warpgroup
//     passes the turn to issue in a ring: warpgroup w issues its S and P·V,
//     then lets w + 1 issue, so that w's softmax runs while w + 1's
//     products do.
//   * Blocks wholly past the causal diagonal or before the window are
//     skipped; only blocks that cross a mask edge test keys, against each
//     row's [lo, hi) key bounds, and only they pay the masked keys' select.
//   * Persistent grid: one CTA an SM (the wrapper sizes the grid), each
//     walking units (a query tile of one batch·head and one run of its kv
//     blocks) in a snake order, the longest rows first. The K and V rings
//     run on across units, and Q has a barrier for its release once a
//     unit's last S is done, so the producer loads the next unit's Q and
//     first blocks while the consumers finish the last P·V and store.
//   * Key split (splits > 1, d64_plan: non-causal shapes with too few query
//     tiles to fill the card, e.g. whisper's cross-attention, 448 queries
//     over 1500 keys): the kv blocks are split in equal runs, each a unit;
//     a unit writes its rows' unnormalized float32 O and (m, l) to
//     scratch, and flash_attn_d64_combine merges the runs in the fixed
//     order 0, 1, ... (no atomics: two calls give the same bits).
//
// Bound on an H100 at whisper-small's shapes (b = 4, 12/12 heads, d = 64,
// bf16, non-causal): the encoder's 1500 x 1500 is 4·64·48·1500² = 2.76e10
// FLOP, 0.0280 ms at 989 TFLOP/s, and 1.08e8 exponentials, ~0.028 ms at
// ~3.9e12 a second; the cross-attention's 448 x 1500 a third of that
// (0.0084 ms); the decoder's causal 448 x 448 ~0.0013 ms. Q, K, V and O move
// in under a third of the products' time. PERF.md has the measured times.
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kD = 64;
constexpr int kBN = 128;              // keys a kv block
constexpr int kStages = 3;
constexpr int kTileKV = 128 * 128;    // bytes of a 64-dim x 128-row box
constexpr int kBars = 2 + 4 * kStages;

template <int kWG>
struct Cfg {
  static constexpr int kBM = 64 * kWG;              // query rows a CTA
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kConsumerRegs = kWG == 2 ? 240 : 160;
  static constexpr int kTileQ = kBM * 128;
  static constexpr int kKOff = kTileQ;
  static constexpr int kVOff = kKOff + kStages * kTileKV;
  static constexpr int kBarOff = kVOff + kStages * kTileKV;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;   // + align
};

struct Geom {
  long long o_sb, o_sh, o_ss;
  int hq, group;              // group = hq / hkv
  int sq, sk;
  int causal, window;         // window <= 0: no window
  float scale_log2;           // sm_scale · log2(e)
  int splits, per_split;      // kv blocks a split (all of them when 1)
  int bh, n_qb, units;        // b·hq, query tiles, n_qb · bh · splits
  float* part;                // splits > 1: (splits, b·hq, sq) rows of
                              // O (64 floats), then (m, l) pairs after them
};

__device__ __forceinline__ void kv_range(const Geom& g, int q0, int bm,
                                         int* kb0, int* kb1) {
  int hi = g.sk;
  if (g.causal) hi = min(hi, q0 + bm);
  int lo = 0;
  if (g.window > 0) lo = max(0, q0 - g.window + 1);
  *kb0 = lo / kBN;
  *kb1 = hi > lo ? (hi + kBN - 1) / kBN : *kb0;
}

__device__ __forceinline__ bool needs_mask(const Geom& g, int q0, int bm,
                                           int k0) {
  return k0 + kBN > g.sk || (g.causal && k0 + kBN - 1 > q0) ||
         (g.window > 0 && (q0 + bm - 1) - k0 >= g.window);
}

// A unit of work: one query tile of one (batch, head) and one key split.
struct Unit {
  int q0, bh, split, kb0, n_kb;
};

// The w-th unit CTA c of the p in the grid works: unit w·p + c in even
// rounds and w·p + p - 1 - c in odd ones (a snake, so that the longest
// tiles, first in the order, and the shortest even out). Units run from
// the last query tile (the longest rows when causal) to the first, then
// over (batch, head) and split. False when the walk is over.
template <int kBM>
__device__ __forceinline__ bool unit_at(const Geom& g, int w, Unit* u) {
  const int p = gridDim.x, c = blockIdx.x;
  const int t = w * p + ((w & 1) ? p - 1 - c : c);
  if (t >= g.units) return false;
  const int per_q = g.bh * g.splits;
  u->q0 = (g.n_qb - 1 - t / per_q) * kBM;
  u->bh = t % per_q / g.splits;
  u->split = t % g.splits;
  int kb0, kb1;
  kv_range(g, u->q0, kBM, &kb0, &kb1);
  kb0 = max(kb0, u->split * g.per_split);
  kb1 = max(kb0, min(kb1, (u->split + 1) * g.per_split));
  u->kb0 = kb0;
  u->n_kb = kb1 - kb0;
  return true;
}

// Named barriers 1.. kWG (sm90.cuh's named_sync, named_arrive) order the
// consumers' products: warpgroup w waits on barrier 1 + w for its turn and
// arrives on the next one's to pass it.

// ----------------------------------------------------------------- kernel --
template <int kWG>
__global__ void __launch_bounds__(Cfg<kWG>::kThreads, 1)
flash_attn_sm90_d64(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    Geom g) {
  using C = Cfg<kWG>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + C::kBarOff));
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  auto k_tile = [&](int s) { return smem + C::kKOff + s * kTileKV; };
  auto v_tile = [&](int s) { return smem + C::kVOff + s * kTileKV; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kWG);            // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 4 * kWG);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // One K or V tile of 128 keys from k0 into its stage; it counts the
      // tiles of its ring over the whole walk.
      auto stage_in = [&](const CUtensorMap* map, unsigned char* dst,
                          uint32_t full, uint32_t empty, int it, int k0,
                          int kvh, int b) {
        mbar_wait(empty, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kTileKV);
        tma_load(dst, map, full, 0, k0, kvh, b);
      };
      int kit = 0;              // kv blocks loaded before this unit
      Unit u;
      for (int w = 0; unit_at<C::kBM>(g, w, &u); ++w) {
        const int b = u.bh / g.hq, h = u.bh % g.hq, kvh = h / g.group;
        if (w > 0) mbar_wait(q_empty, (w - 1) & 1);
        mbar_expect_tx(q_full, C::kTileQ);
        tma_load(smem, &tq, q_full, 0, u.q0, h, b);
        for (int i = 0; i <= u.n_kb; ++i) {  // K of block i, V of block i - 1
          if (i < u.n_kb) {
            const int it = kit + i, s = it % kStages;
            stage_in(&tk, k_tile(s), k_full(s), k_empty(s), it,
                     (u.kb0 + i) * kBN, kvh, b);
          }
          if (i > 0) {
            const int it = kit + i - 1, s = it % kStages;
            stage_in(&tv, v_tile(s), v_full(s), v_empty(s), it,
                     (u.kb0 + i - 1) * kBN, kvh, b);
          }
        }
        kit += u.n_kb;
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::kConsumerRegs));
    const int cw = wg - 1;                       // rows [64 cw, 64 cw + 64)
    const int wtid = threadIdx.x % 128;
    const int lane = wtid & 31, gr = lane >> 2, tg = lane & 3;
    const unsigned char* q_base = smem + cw * 64 * 128;

    // This consumer's turn to issue products, and passing it on.
    auto turn_wait = [&]() { named_sync(1 + cw); };
    auto turn_pass = [&]() { named_arrive(1 + (cw + 1) % kWG); };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q·Kᵀ of the kv block in K stage s, issued and committed.
    auto issue_s = [&](float (&sc)[64], int s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // dims [16 kk, 16 kk + 16): 32 bytes a step within the swizzled row
        wgmma_ss(sc, smem_desc(q_base + kk * 32, 16, 1024),
                 smem_desc(k_tile(s) + kk * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    if (cw == 0) named_arrive(1);   // the first turn
    int kit = 0;                // kv blocks consumed before this unit
    Unit u;
    for (int w = 0; unit_at<C::kBM>(g, w, &u); ++w) {
      const int n_kb = u.n_kb, kb0 = u.kb0;
      const int qw0 = u.q0 + 64 * cw;
      const int row0 = qw0 + (wtid >> 5) * 16 + gr, row1 = row0 + 8;
      // the keys rows row0 and row1 may see, [lo, hi): below sk, not past
      // the row when causal, less than the window behind it
      const int lo0 = g.window > 0 ? row0 - g.window + 1 : 0;
      const int lo1 = lo0 + (g.window > 0 ? 8 : 0);
      const int hi0 = g.causal ? min(g.sk, row0 + 1) : g.sk;
      const int hi1 = g.causal ? min(g.sk, row1 + 1) : g.sk;

      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
      float al0 = 1.0f, al1 = 1.0f;
      uint32_t pf[8][4];        // P of the block whose P·V is next

      // O += P·V of the kv block in V stage s, issued and committed.
      auto issue_pv = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          // keys [16 kk, 16 kk + 16): two 8-row groups of the 64-dim box
          wgmma_rs_n64(acc, pf[kk],
                       smem_desc(v_tile(s) + kk * 16 * 128, kTileKV, 1024));
        }
        wgmma_commit();
      };
      // The online softmax of the block of keys [k0, k0 + kBN), in base 2:
      // updates m and l, leaves the unrounded P in sc and the
      // accumulator's rescale factors in al0, al1.
      auto softmax = [&](float (&sc)[64], int k0) {
        const bool masked = needs_mask(g, qw0, 64, k0);
        auto kept = [&](int j) {
          const int col = k0 + (j >> 2) * 8 + 2 * tg + (j & 1);
          return (j & 2) ? col >= lo1 && col < hi1 : col >= lo0 && col < hi0;
        };
        float mx0 = m0, mx1 = m1;
        if (masked) {
#pragma unroll
          for (int j = 0; j < 64; ++j)
            sc[j] = kept(j) ? __fmul_rn(sc[j], g.scale_log2) : kNegInf;
        } else {
#pragma unroll
          for (int j = 0; j < 64; ++j) sc[j] = __fmul_rn(sc[j], g.scale_log2);
        }
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
        }
        // the four threads of a quad share rows row0 and row1
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        al0 = ex2(m0 - mx0);
        al1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        l0 *= al0;
        l1 *= al1;
        if (masked) {           // a masked key's p is 0, not ex2(0)
#pragma unroll
          for (int j = 0; j < 64; ++j)
            sc[j] = kept(j) ? ex2(sc[j] - ((j & 2) ? mx1 : mx0)) : 0.0f;
        } else {
#pragma unroll
          for (int j = 0; j < 64; ++j)
            sc[j] = ex2(sc[j] - ((j & 2) ? mx1 : mx0));
        }
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          l0 += sc[4 * nt] + sc[4 * nt + 1];
          l1 += sc[4 * nt + 2] + sc[4 * nt + 3];
        }
      };
      // P, rounded to bf16, into the A fragments of P·V, once the last P·V
      // that read them is done.
      auto pack_p = [&](const float (&sc)[64]) {
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
          pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(sc[4 * nt + 2],
                                                   sc[4 * nt + 3]);
        }
      };
      // O rescaled by the last softmax's factors, before that block's P·V
      // is added (block i - 2's P·V is done by then).
      auto rescale = [&]() {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[4 * nt + 0] *= al0;
          acc[4 * nt + 1] *= al0;
          acc[4 * nt + 2] *= al1;
          acc[4 * nt + 3] *= al1;
        }
      };
      // Block i >= 1: O rescaled, then in this consumer's turn S of block
      // i and P·V of block i - 1 behind it; block i's softmax while that
      // P·V (and the next consumer's products) run, and its P packed once
      // the P·V is done. Q is free once the last block's S is done.
      // Straight-line code between the waits, so that the compiler keeps
      // the products asynchronous.
      auto step = [&](int i) {
        const int ki = kit + i, vi = kit + i - 1;
        const int ks = ki % kStages, vs = vi % kStages;
        float sc[64];
        rescale();
        mbar_wait(k_full(ks), (ki / kStages) & 1);
        mbar_wait(v_full(vs), (vi / kStages) & 1);
        turn_wait();
        fence_acc(acc);
        wgmma_fence();
        issue_s(sc, ks);
        issue_pv(vs);
        turn_pass();
        wgmma_wait<1>();        // S is done; P·V may still run
        fence_acc(sc);
        release(k_empty(ks));
        if (i == n_kb - 1) release(q_empty);
        softmax(sc, (kb0 + i) * kBN);
        wgmma_wait<0>();        // block i - 1's P·V is done
        fence_acc(acc);
        release(v_empty(vs));
        pack_p(sc);
      };

      mbar_wait(q_full, w & 1);
      if (n_kb > 0) {           // block 0: S, softmax (O is still 0)
        const int ks = kit % kStages;
        float sc[64];
        mbar_wait(k_full(ks), (kit / kStages) & 1);
        turn_wait();
        wgmma_fence();
        issue_s(sc, ks);
        turn_pass();
        wgmma_wait<0>();
        fence_acc(sc);
        release(k_empty(ks));
        if (n_kb == 1) release(q_empty);
        softmax(sc, kb0 * kBN);
        pack_p(sc);
      } else {
        release(q_empty);
      }
#pragma unroll 1
      for (int i = 1; i < n_kb; ++i) step(i);
      if (n_kb > 0) {           // the last block's P·V
        const int vi = kit + n_kb - 1, vs = vi % kStages;
        rescale();
        mbar_wait(v_full(vs), (vi / kStages) & 1);
        fence_acc(acc);
        wgmma_fence();
        issue_pv(vs);
        wgmma_wait<0>();
        fence_acc(acc);
        release(v_empty(vs));
      }
      kit += n_kb;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (g.splits > 1) {
        // this split's unnormalized rows and their (m, l), for the combine
        const long long rows = static_cast<long long>(g.bh) * g.sq;
        const long long r0 = u.split * rows + static_cast<long long>(u.bh) * g.sq;
        float* po = g.part + r0 * kD;
        float2* pml =
            reinterpret_cast<float2*>(g.part + g.splits * rows * kD) + r0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * tg;
          if (row0 < g.sq)
            *reinterpret_cast<float2*>(po + row0 * kD + col) =
                make_float2(acc[4 * nt], acc[4 * nt + 1]);
          if (row1 < g.sq)
            *reinterpret_cast<float2*>(po + row1 * kD + col) =
                make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
        }
        if (tg == 0) {
          if (row0 < g.sq) pml[row0] = make_float2(m0, l0);
          if (row1 < g.sq) pml[row1] = make_float2(m1, l1);
        }
        continue;
      }
      if (l0 == 0.0f) l0 = 1.0f;
      if (l1 == 0.0f) l1 = 1.0f;
      if (lse != nullptr && tg == 0) {
        constexpr float kLn2 = 0.693147180559945309f;
        float* lp = lse + static_cast<long long>(u.bh) * g.sq;
        if (row0 < g.sq) lp[row0] = (m0 + log2f(l0)) * kLn2;
        if (row1 < g.sq) lp[row1] = (m1 + log2f(l1)) * kLn2;
      }
      const int b = u.bh / g.hq, h = u.bh % g.hq;
      __nv_bfloat16* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
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
}

// The second pass of a key split: each row's splits merged in the order
// 0, 1, ..., as the online softmax merges blocks, into the bf16 output and
// the lse. Eight threads a row, eight dims each.
__global__ void __launch_bounds__(256)
flash_attn_d64_combine(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       long long o_sb, long long o_sh, long long o_ss, int hq,
                       int sq, long long rows, int splits) {
  const long long r = blockIdx.x * 32LL + threadIdx.x / 8;
  if (r >= rows) return;
  const int c = (threadIdx.x & 7) * 8;
  const float2* pml = reinterpret_cast<const float2*>(part + splits * rows * kD);
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pml[s * rows + r].x);
  float l = 0.0f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = pml[s * rows + r];
    const float w = ex2(ml.x - mx);
    l += ml.y * w;
    const float4* p =
        reinterpret_cast<const float4*>(part + (s * rows + r) * kD + c);
    const float4 a = p[0], bq = p[1];
    acc[0] += a.x * w;
    acc[1] += a.y * w;
    acc[2] += a.z * w;
    acc[3] += a.w * w;
    acc[4] += bq.x * w;
    acc[5] += bq.y * w;
    acc[6] += bq.z * w;
    acc[7] += bq.w * w;
  }
  if (l == 0.0f) l = 1.0f;
  const int bh = static_cast<int>(r / sq), q = static_cast<int>(r % sq);
  uint4 out;
  out.x = pack_bf16(acc[0] / l, acc[1] / l);
  out.y = pack_bf16(acc[2] / l, acc[3] / l);
  out.z = pack_bf16(acc[4] / l, acc[5] / l);
  out.w = pack_bf16(acc[6] / l, acc[7] / l);
  *reinterpret_cast<uint4*>(o + (bh / hq) * o_sb + (bh % hq) * o_sh +
                            q * o_ss + c) = out;
  if (lse != nullptr && c == 0) {
    constexpr float kLn2 = 0.693147180559945309f;
    lse[r] = (mx + log2f(l)) * kLn2;
  }
}

template <int kWG>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, __nv_bfloat16* o, float* lse, const Geom& g,
           int ctas, cudaStream_t stream) {
  using C = Cfg<kWG>;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attn_sm90_d64<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  flash_attn_sm90_d64<kWG><<<ctas, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, o, lse, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, hq, sq, 64), k and v (b, hkv, sk, 64), o (b, hq, sq, 64), all bf16,
// each with its (batch, head, sequence) strides in elements and the last
// dimension contiguous; every base pointer is 16-byte aligned and every
// stride a multiple of 8 elements; o's strides are those of a (b, sq, hq,
// 64) buffer or any other multiple of 8. window <= 0: none. scale_log2 is
// sm_scale · log2(e): the softmax runs in base 2. lse: null, or a contiguous
// (b, hq, sq) float32 buffer for each row's log-sum-exp in natural units.
// consumers (2 or 3) is the consumer warpgroups a CTA (128 or 192 query
// rows); splits (1-16) the runs the kv blocks are split into, and part,
// with splits > 1, float32 scratch of splits · b · hq · sq · 66 elements;
// ctas the persistent grid that walks the units (query tile, batch·head,
// split), at most one CTA an SM (the wrapper: the fewer of the SMs and the
// units).
// Returns 0 on success, the cudaError_t of a launch, or kEncodeError plus
// the CUresult of a failed tensor-map encoding; the wrapper checks shapes,
// types and alignment.
int flash_attention_sm90_d64_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int sq, int sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale_log2, void* lse,
    int consumers, int splits, int ctas, void* part, void* stream) {
  if ((consumers != 2 && consumers != 3) || splits < 1 || splits > 16 ||
      (splits > 1 && part == nullptr) || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, batch, hq, sq, kD, q_sb, q_sh, q_ss, 64 * consumers);
  if (err == 0) err = encode(&tk, k, batch, hkv, sk, kD, k_sb, k_sh, k_ss, kBN);
  if (err == 0) err = encode(&tv, v, batch, hkv, sk, kD, v_sb, v_sh, v_ss, kBN);
  if (err != 0) return err;
  const int n_kb = (sk + kBN - 1) / kBN;
  const int n_qb = (sq + 64 * consumers - 1) / (64 * consumers);
  Geom g{o_sb, o_sh, o_ss, hq, hq / hkv, sq, sk, causal, window, scale_log2,
         splits, (n_kb + splits - 1) / splits, batch * hq, n_qb,
         n_qb * batch * hq * splits, static_cast<float*>(part)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  float* lf = static_cast<float*>(lse);
  err = consumers == 2 ? launch<2>(tq, tk, tv, ob, lf, g, ctas, st)
                       : launch<3>(tq, tk, tv, ob, lf, g, ctas, st);
  if (err != 0 || splits == 1) return err;
  const long long rows = static_cast<long long>(batch) * hq * sq;
  flash_attn_d64_combine<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                           st>>>(g.part, ob, lf, o_sb, o_sh, o_ss, hq, sq,
                                 rows, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
