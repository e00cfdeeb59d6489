// What the Hopper K3-bwd kernels share (flash_attention_bwd_sm90.cu at head
// dims 64, 120 and 128, flash_attention_bwd_sm90_d256.cu at 256): K3's
// masks over a geometry G with sq, sk, causal and window (window <= 0: none),
// the ranges of blocks a block sees, a bulk copy into shared memory, the
// exponentials of an accumulator under the masks and its conversion to bf16
// A fragments.
// After sm90.cuh.
#pragma once

namespace {

// The keys [lo, hi) that query row `row` sees under K3's masks (none past
// sq).
template <class G>
__device__ __forceinline__ int2 keys_of_row(const G& g, int row) {
  const int hi = row >= g.sq ? 0 : g.causal ? min(g.sk, row + 1) : g.sk;
  return make_int2(g.window > 0 ? max(0, row - g.window + 1) : 0, hi);
}

// The query rows [lo, hi) that see key `key` (none past sk).
template <class G>
__device__ __forceinline__ int2 rows_of_key(const G& g, int key) {
  const int hi = key >= g.sk ? 0 : g.window > 0 ? min(g.sq, key + g.window)
                                                : g.sq;
  return make_int2(g.causal ? key : 0, hi);
}

// Whether some (row, key) of the q block x kv block is masked.
template <class G>
__device__ __forceinline__ bool needs_mask(const G& g, int q0, int bm,
                                           int k0, int bn) {
  return q0 + bm > g.sq || k0 + bn > g.sk ||
         (g.causal && k0 + bn - 1 > q0) ||
         (g.window > 0 && (q0 + bm - 1) - k0 >= g.window);
}

// Whether every (row, key) of the q block x kv block is masked.
template <class G>
__device__ __forceinline__ bool all_masked(const G& g, int q0, int bm,
                                           int k0, int bn) {
  return k0 >= g.sk || q0 >= g.sq || (g.causal && k0 > q0 + bm - 1) ||
         (g.window > 0 && q0 - (k0 + bn - 1) >= g.window);
}

// The kv blocks [kb0, kb1) holding a key some row of [q0, q0 + bm) sees.
template <class G>
__device__ __forceinline__ void kv_range(const G& g, int q0, int bm,
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
template <class G>
__device__ __forceinline__ void q_range(const G& g, int k0, int bn,
                                        int bm, int* qb0, int* qb1) {
  const int lo = g.causal ? k0 : 0;
  int hi = g.sq;
  if (g.window > 0) hi = min(hi, k0 + bn - 1 + g.window);
  *qb0 = lo / bm;
  *qb1 = hi > lo ? (hi + bm - 1) / bm : *qb0;
}

// P in place of an accumulator fragment of 64 rows x 8·NT columns (thread
// rows r0 and r0 + 8, columns c0 + 8 nt + 2 tg and + 1): 2^(acc · sl2 - l),
// l a row's (l0, l1) where L_ROW, else its column's (lcol[column - c0]).
// Where `masked` (a block across a mask edge), an entry whose column lies
// outside its row's [lo, hi) (b0, b1) is 0; a block inside the masks takes
// the branch without the compares.
template <int NT, bool L_ROW>
__device__ __forceinline__ void exp_masked(float (&acc)[4 * NT], float sl2,
                                           float l0, float l1,
                                           const float* lcol, bool masked,
                                           int c0, int2 b0, int2 b1, int tg) {
  auto l_of = [&](int nt, int e) {
    if constexpr (L_ROW) {
      return e < 2 ? l0 : l1;
    } else {
      return lcol[nt * 8 + 2 * tg + (e & 1)];
    }
  };
  if (masked) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * tg + (e & 1);
        const int2 bd = e < 2 ? b0 : b1;
        const float p = ex2(fmaf(acc[4 * nt + e], sl2, -l_of(nt, e)));
        acc[4 * nt + e] = col >= bd.x && col < bd.y ? p : 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * nt + e] = ex2(fmaf(acc[4 * nt + e], sl2, -l_of(nt, e)));
    }
  }
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

}  // namespace
