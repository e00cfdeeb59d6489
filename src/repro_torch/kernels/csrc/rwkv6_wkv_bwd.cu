// W-bwd: the gradient of W (rwkv6_wkv.cu), RWKV6's WKV recurrence, for
// training rwkv6 on the card, in chunks on the tensor cores.
//
// Port only: no Pallas kernel stands behind it. The JAX package's gradient
// is autodiff of the jax.lax.scan of rwkv6_apply
// (src/repro/models/rwkv6.py:97-111); this stands for that autodiff on the
// training path (kernels/rwkv6_wkv/ops.py::rwkv6_wkv_bwd). Its plain
// version is kernels/rwkv6_wkv/ref.py::wkv_bwd_ref, and
// ref.py::wkv_bwd_chunked is its arithmetic in plain PyTorch.
//
// What it computes, per (batch, head), from r, k, v (b, T, H, hd) of the
// model's type, logw (b, T, H, hd) and u (H, hd) float32, dy (b, T, H, hd)
// float32 and the gradient dS of the last state (b, H, hd, hd) float32 or
// none: the gradient of W's (y, S_T) from a zero state, dr, dk, dv in the
// inputs' type, dlogw float32 and du float32 (H, hd), du summed over T and
// then the batch in a fixed order. Every sum runs in a fixed order and there
// are no atomics: two runs give the same bits. It is held to the plain
// version by a tolerance (chip_smoke.py's RTRAIN_TOL), not bit for bit.
//
// The chunked form. Over a chunk of C = 16 steps from the state S0, with
// W's forward in chunks (rwkv6_wkv.cu): P_t = 2^lb_t the decay before step
// t within the chunk (lb_t the sum of logw · log2 e over the chunk's earlier
// steps, L the chunk's total), Q_s = 2^(L - lb_{s+1}) the decay after step
// s, D = 2^L, r̃_t = r_t ⊙ P_t, K̂_s = k_s ⊙ Q_s, W[t][s] = w_{t-1} ⊙ ...
// ⊙ w_{s+1} (1 at s = t - 1) and A[t][s] = Σ_i r_t k_s W[t][s] for s < t,
// A[t][t] = r_t · (u ⊙ k_t):
//   y = r̃ S0 + A V,  S_end = D ⊙ S0 + K̂ᵀ V.
// Given dY and the gradient G of S_end, chunks from the last:
//   the chain: G ← D ⊙ G + r̃ᵀ dY (one multiply-add an element; the product
//     is taken off the chain);
//   the products: dr̃ = dY S0ᵀ, dK̂ = V Gᵀ, dV = Aᵀ dY + K̂ G, dA = dY Vᵀ,
//     dD = rowsum(G ⊙ S0);
//   through the decays, with M[t][s] = dA[t][s] r_t ⊙ k_s ⊙ W[t][s], s < t:
//     dr_t = dr̃_t ⊙ P_t + Σ_{s<t} dA[t][s] k_s ⊙ W[t][s] + u ⊙ k_t dA[t][t]
//     dk_s = dK̂_s ⊙ Q_s + Σ_{t>s} dA[t][s] r_t ⊙ W[t][s] + u ⊙ r_s dA[s][s]
//     du  += Σ_t r_t ⊙ k_t dA[t][t]
//     dlogw_τ = D ⊙ dD + Σ_{s<τ} K̂_s ⊙ dK̂_s + Σ_{t>τ} (r̃_t ⊙ dr̃_t
//               + Σ_{s<t} M[t][s]) - Σ_{s>=τ} Σ_{t>s} M[t][s].
// Every factor is a product of decays of at most 1 and none is inverted
// (W as products of w, P, Q and D as powers of 2 of sums <= 0), so nothing
// overflows however fast the decay; dlogw's one subtraction cancels within
// a chunk. The products run on the tensor cores (mma.sync m16n8k8) in split
// TF32 (rwkv6_wkv.cu's hi·hi + hi·lo + lo·hi; a bf16 v is exact in TF32 and
// is not split), except dV's two where dv is bf16: those feed dv alone, and
// one plain TF32 pass keeps it well inside bf16's own rounding (0.0041 of
// max |plain| at rwkv6-3b's shape, against 0.0020 split; the limit is
// 0.01). mma.sync throughout: with 16 of the state's rows a CTA, no
// product's M reaches wgmma's 64 (r̃ᵀ dY is 16 x hd here), and gathering a
// head's 64 rows in one CTA would leave 40 CTAs for the card's 132 SMs
// (not measured). The decay terms run in float32 on the CUDA cores.
//
// The states the chunks start from: a forward sweep over T (S ← D ⊙ S + K̂ᵀ
// V) writes S0 of every chunk to a float32 checkpoint (b, H, chunks, hd,
// hd), which the backward sweep reads back two chunks ahead of use. The
// other way, a checkpoint every n-th chunk with the chunks between rebuilt
// in the backward sweep, moves fewer bytes but adds a product a chunk and a
// second staging of k, v and logw; it was not taken because the
// checkpoint's traffic costs nothing measurable here: with every chunk's
// state sent to one place, which stays in L2, the kernel takes the same
// time (benchmarks_torch/w_bwd_variants.py, no_ckpt).
//
// Layout. A cluster of NQ = hd / 16 CTAs takes one (batch, head): CTA q
// owns the state's rows (dk channels) 16q..16q+15, so that dr̃, dK̂, dD, dr,
// dk, dlogw and du are its own; dv is a sum over the rows, so each CTA's
// share of it goes to the CTA that owns those columns (st.async into its
// shared memory, counted by its mbarrier), which adds the NQ shares in rank
// order. Eight warps, a chunk in flight in each role, a CTA barrier a
// chunk:
//   - warps 0..NQ-1 (the products): warp w holds G's and S0's columns
//     16w..16w+15 in the mma.sync accumulator layout; per chunk its shares
//     of dK̂ᵀ, dr̃ᵀ and dD (a sum over its columns), then G's update and its
//     columns of dV's share, sent to the owning CTA once every owner has
//     summed that slot's round before;
//   - warp 4: lane 0 brings each chunk's 16 x 16 tiles of r, k, logw (the
//     CTA's channels) and 16 x (hd + 8) tiles of v and dy (the head's
//     columns and 8 more, so that the rows' fragments meet no bank twice) by
//     TMA into a ring of 4 slots (8 slots of k, logw and v in the forward
//     sweep); dA = dY Vᵀ (on the tensor cores) two chunks ahead, the decays
//     (P, Q, D, r̃, K̂) one chunk ahead, and the sum of dv's shares of the
//     chunk before;
//   - warp 5, a chunk ahead: lane (row t, 8 channels), dr's terms through
//     dA and Σ_s M[t][s];
//   - warp 6, a chunk ahead: lane (column s, 8 channels), dk's terms
//     through dA, Σ_t M[t][s] and A's share;
//   - warp 7: the chunk before's dr, dk, dlogw (its scans over the chunk)
//     and du.
// The forward sweep runs first, two chunks a step: warps 4 and 5 their
// decays, the product warps the state through the two before. Two CTAs fit
// on an SM.
//
// Bound on an H100 at rwkv6-3b's (1, 4096, 40, 64) bf16: bytes. r, k, v in
// bf16, logw and dy float32 read once, dr, dk, dv in bf16 and dlogw float32
// written once: 252 MB, 0.075 ms at 3.35 TB/s. The chunked form's products
// (2·C·hd² FLOP each for five with the state, 2·C²·hd for two within the
// chunk, a chunk and head; three TF32 passes each where split, two where
// one side is a bf16 v) take 0.039 ms at the TF32 rate, its decay terms
// 0.011 ms on the CUDA cores (chip_smoke.py's w_bwd_bound). The kernel sits
// far above both: each role is a chain of dependent steps in one warp, and
// the SM's 16 warps (two CTAs) share its instruction slots and shared-memory
// pipe; taking out the decay loops (warps 5-6) takes 0.5 ms of its 1.17
// (w_bwd_variants.py no_loops), and adding 16 operations to each loop step
// adds 0.11 ms: the loops' arithmetic, run by one warp each, sets the
// pace. PERF.md has its time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 16;            // steps a chunk (ops.py BWD_CHUNK)
constexpr int kG = 16;            // state rows (dk channels) a CTA
constexpr int kThreads = 256;
constexpr int kRing = 4;          // the backward sweep's TMA slots
constexpr int kRingF = 8;         // the forward sweep's (k, logw, v only)
constexpr int kDer = 3;           // slots of the staged chunks' decay terms
constexpr int kPad = 8;           // v and dy rows: hd + 8 elements
constexpr int kDecayWarp = 4;
constexpr int kLoop1Warp = 5;
constexpr int kLoop2Warp = 6;
constexpr float kLog2e = 1.4426950408889634f;

// With -DRWKV6_BWD_CLOCK (benchmarks_torch/w_bwd_variants.py's "clocked"),
// lane 0 of each warp counts its cycles: [0] the forward sweep's work, [1]
// its CTA barriers, [2] the backward sweep's work, [3] its CTA barriers,
// [4] and [5] the mbarrier waits inside the forward's and the backward's
// work, [6] and [7] the loop warps' rows and their loops (out of [2]),
// and writes them over dstate (which the caller passes as a buffer of
// b · H · hd · hd floats) at the end.
#ifdef RWKV6_BWD_CLOCK
#define CLK_MARK(slot)                                  \
  {                                                     \
    const long long now_ = clock64();                   \
    clk[slot] += static_cast<unsigned>(now_ - clk_t0);  \
    clk_t0 = now_;                                      \
  }
#else
#define CLK_MARK(slot)
#endif

// One chunk's tiles as TMA lands them.
template <typename T, int HD>
struct __align__(128) Raw {
  T r[kC][kG];
  T k[kC][kG];
  float lw[kC][kG];
  T v[kC][HD + kPad];
  float dy[kC][HD + kPad];
};

// One chunk's tiles for the forward sweep: k, logw and v, so that twice as
// many slots fit where the backward sweep's ring lies.
template <typename T, int HD>
struct __align__(128) RawF {
  T k[kC][kG];
  float lw[kC][kG];
  T v[kC][HD + kPad];
};

// One chunk's terms from the staging warps (4-6), read by the products and
// the finals.
struct __align__(16) Der {
  float rt[kC][24];     // r̃[t][i]
  float aq[kC][24];     // A's share over this CTA's channels [t][s]
  float kt[kC][20];     // K̂[s][i]
  float p[kC][kG];      // P[t][i]
  float qd[kC][kG];     // Q[s][i]
  float drp[kC][kG];    // Σ_{s<t} dA k W + u k dA[t][t]
  float rowm[kC][kG];   // Σ_{s<t} M[t][s]
  float duc[kC][kG];    // r k dA[t][t]
  float dkp[kC][kG];    // Σ_{t>s} dA r W + u r dA[s][s]
  float colm[kC][kG];   // Σ_{t>s} M[t][s]
  float d[kG];          // D
};

// The product warps' shares of one chunk's sums over the state's columns.
struct __align__(16) Part {
  float drt[4][kC][20];   // dr̃[t][i]
  float dkt[4][kC][20];   // dK̂[s][i]
  float dd[4][kG];        // rowsum(G ⊙ S0)
};

// The forward sweep's decay terms of one chunk: K̂[s][i] and D.
struct __align__(16) FwdDec {
  float kt[kC][20];
  float d[kG];
};

// A loop warp's chunk: w = 2^(logw · log2 e), and k (warp 5) or r (warp 6)
// as float.
struct __align__(16) LoopScr {
  float w[kC][20];
  float x[kC][20];
};

template <typename T, int HD>
struct Smem {
  union {
    Raw<T, HD> raw[kRing];        // the backward sweep's ring
    RawF<T, HD> fwd[kRingF];      // the forward sweep's
  };
  Der der[kDer];
  union {
    Part part[2];                   // the backward sweep's
    FwdDec fdec[4];                 // the forward sweep's, two chunks a step
  };
  float gold[4][kG][24];            // a product warp's G before the update
  float recv[2][HD / kG][kC][kG];   // dv's shares of this CTA's columns
  LoopScr scr[2];
  float da[2][kC][17];              // dA of the next two chunks, warp 4's
  float u[kG];
  unsigned long long raw_full[kRing];
  unsigned long long fwd_full[kRingF];
  unsigned long long recv_full[2];  // a round's dv shares landed here
  unsigned long long recv_empty[2]; // every owner summed this CTA's shares
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Two consecutive values (the first at an even index) as float.
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// 8 consecutive values as float.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + e);
    x[e] = f.x;
    x[e + 1] = f.y;
    x[e + 2] = f.z;
    x[e + 3] = f.w;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(ws[e] << 16);
    x[2 * e + 1] = __uint_as_float(ws[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// This CTA's shared address `a` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t in_cta(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// Two floats to the cluster address `a`, counted as 8 bytes by the
// mbarrier at the cluster address `bar` in the same CTA.
__device__ __forceinline__ void st_async2(uint32_t a, float x, float y,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(a),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

// One arrival on the mbarrier at `bar` in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   in_cta(bar, rank))
               : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(d),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A TF32 operand: hi and lo of a split float, or the float itself where it
// is exact in TF32 (a bf16 value).
template <bool kExact>
__device__ __forceinline__ void tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32(x, hi, lo);
  }
}

// d += A · B in split TF32: lo·hi + hi·lo + hi·hi, without hi·lo where B is
// exact.
template <bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  if constexpr (!kExactB) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// A fragment (rows g, g + 8; columns c, c + 4) split, from four floats
// given in the order a0..a3.
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// dA = dY Vᵀ (t x s, over the head's hd columns) by one warp, into
// da[t][s]. The k dimension is permuted within each 8 (operand column c is
// j = 2c, column c + 4 is j = 2c + 1), so that a lane's pairs are adjacent.
template <typename T, int HD>
__device__ __forceinline__ void chunk_da(const Raw<T, HD>& rw,
                                         float (&da)[kC][17], int lane) {
  constexpr bool kExactV = sizeof(T) == 2;
  const int g = lane >> 2, c4 = lane & 3;
  // four accumulators (column tile, even or odd k-step), so that the
  // products form four chains; the operands first, so that the loads are
  // in flight together
  float acc[2][2][4] = {};
  float2 d0[HD / 8], d1[HD / 8], b0[HD / 8], b1[HD / 8];
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    d0[kk] = pair(&rw.dy[g][8 * kk + 2 * c4]);
    d1[kk] = pair(&rw.dy[g + 8][8 * kk + 2 * c4]);
    b0[kk] = pair(&rw.v[g][8 * kk + 2 * c4]);
    b1[kk] = pair(&rw.v[8 + g][8 * kk + 2 * c4]);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ah[4], al[4];
    split4(d0[kk].x, d1[kk].x, d0[kk].y, d1[kk].y, ah, al);
#pragma unroll
    for (int ns = 0; ns < 2; ++ns) {
      const float2 b = ns == 0 ? b0[kk] : b1[kk];
      uint32_t bh0, bl0, bh1, bl1;
      tf32<kExactV>(b.x, bh0, bl0);
      tf32<kExactV>(b.y, bh1, bl1);
      mma3<kExactV>(acc[ns][kk & 1], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int ns = 0; ns < 2; ++ns) {
    da[g][8 * ns + 2 * c4] = acc[ns][0][0] + acc[ns][1][0];
    da[g][8 * ns + 2 * c4 + 1] = acc[ns][0][1] + acc[ns][1][1];
    da[g + 8][8 * ns + 2 * c4] = acc[ns][0][2] + acc[ns][1][2];
    da[g + 8][8 * ns + 2 * c4 + 1] = acc[ns][0][3] + acc[ns][1][3];
  }
}

// One CTA: (batch, head) = blockIdx.x / NQ, rank q in its cluster of
// NQ = HD / 16.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
wkv_bwd_kernel(const __grid_constant__ CUtensorMap map_r,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_dy,
               const float* __restrict__ u, const float* __restrict__ dstate,
               float* __restrict__ ckpt, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dlogw, float* __restrict__ du_part,
               int t_len, int heads) {
  constexpr int NQ = HD / kG;
  constexpr int VW = HD + kPad;
  constexpr bool kExactV = sizeof(T) == 2;
  constexpr uint32_t kTxFwd =
      (sizeof(T) * kG + sizeof(float) * kG + sizeof(T) * VW) * kC;
  constexpr uint32_t kTxBack =
      kTxFwd + (sizeof(T) * kG + sizeof(float) * VW) * kC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, HD>& sm = *reinterpret_cast<Smem<T, HD>*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / NQ;
  const int head = bh % heads;
  const int batch = bh / heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, c4 = lane & 3;
  const int chunks = (t_len + kC - 1) / kC;
  // element (t, column col) of a (b, T, H, hd) tensor
  auto at = [&](int t, int col) -> long long {
    return ((static_cast<long long>(batch) * t_len + t) * heads + head) * HD +
           col;
  };

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(smem_u32(&sm.raw_full[s]), 1);
    for (int s = 0; s < kRingF; ++s) mbar_init(smem_u32(&sm.fwd_full[s]), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_u32(&sm.recv_full[s]), 1);
      mbar_init(smem_u32(&sm.recv_empty[s]), NQ);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // above the diagonal A stays zero: its entries are never written
  for (int s = 0; s < kDer; ++s)
    for (int e = tid; e < kC * 24; e += kThreads) (&sm.der[s].aq[0][0])[e] = 0.0f;
  if (tid < kG) sm.u[tid] = u[head * HD + q * kG + tid];
  __syncthreads();
  cluster_sync_all();

  const bool loader = tid == kDecayWarp * 32;
  // dv's shares of rounds 0 and 1 (a round is a chunk of the backward
  // sweep; its shares go to slot round & 1): NQ CTAs' 1 KB each
  constexpr uint32_t kRecvTx = NQ * kC * kG * sizeof(float);
  if (loader) {
    mbar_expect_tx(smem_u32(&sm.recv_full[0]), kRecvTx);
    mbar_expect_tx(smem_u32(&sm.recv_full[1]), kRecvTx);
  }
#ifdef RWKV6_BWD_CLOCK
  long long clk_t0 = clock64();
  unsigned clk[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  int clk_w = 4;
  auto wait_bar = [&](uint32_t bar, uint32_t parity) {
    const long long a = clock64();
    mbar_wait(bar, parity);
    clk[clk_w] += static_cast<unsigned>(clock64() - a);
  };
#else
  auto wait_bar = [&](uint32_t bar, uint32_t parity) { mbar_wait(bar, parity); };
#endif
  // the forward sweep's chunk f: k, logw and v, slot f % kRingF
  auto load_f = [&](int f) {
    const int t0 = f * kC;
    const uint32_t bar = smem_u32(&sm.fwd_full[f % kRingF]);
    RawF<T, HD>& fw = sm.fwd[f % kRingF];
    mbar_expect_tx(bar, kTxFwd);
    tma_load(&fw.k[0][0], &map_k, bar, q * kG, head, t0, batch);
    tma_load(&fw.lw[0][0], &map_w, bar, q * kG, head, t0, batch);
    tma_load3(&fw.v[0][0], &map_v, bar, head * HD, t0, batch);
  };
  auto fwd_of = [&](int f) -> const RawF<T, HD>& {
    wait_bar(smem_u32(&sm.fwd_full[f % kRingF]), (f / kRingF) & 1);
    return sm.fwd[f % kRingF];
  };
  // the backward sweep's m-th chunk (chunk chunks - 1 - m): r, k, logw, v
  // and dy, slot m % kRing
  auto load_b = [&](int m) {
    const int t0 = (chunks - 1 - m) * kC;
    const uint32_t bar = smem_u32(&sm.raw_full[m % kRing]);
    Raw<T, HD>& rw = sm.raw[m % kRing];
    mbar_expect_tx(bar, kTxBack);
    tma_load(&rw.r[0][0], &map_r, bar, q * kG, head, t0, batch);
    tma_load(&rw.k[0][0], &map_k, bar, q * kG, head, t0, batch);
    tma_load(&rw.lw[0][0], &map_w, bar, q * kG, head, t0, batch);
    tma_load3(&rw.v[0][0], &map_v, bar, head * HD, t0, batch);
    tma_load3(&rw.dy[0][0], &map_dy, bar, head * HD, t0, batch);
  };
  auto raw_of = [&](int m) -> const Raw<T, HD>& {
    wait_bar(smem_u32(&sm.raw_full[m % kRing]), (m / kRing) & 1);
    return sm.raw[m % kRing];
  };

  // The decays of a chunk, lane (channel i, step half hh): its channel's
  // prefix over the chunk in registers, then K̂ into kt (and, given r, r̃,
  // P, Q into de) of the 8 steps 8 hh.., and D into dd. Both halves take the whole prefix and
  // pick their steps by selects, so that the warp does not diverge.
  auto decays = [&](const T (*kx)[kG], const float (*lw)[kG],
                    const T (*rx)[kG], float (*kt)[20], float* dd, Der* de) {
    const int i = lane & 15, hh = lane >> 4;
    float lb[kC + 1], kv[8], rv[8];
    lb[0] = 0.0f;
#pragma unroll
    for (int t = 0; t < kC; ++t) lb[t + 1] = fmaf(lw[t][i], kLog2e, lb[t]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kv[e] = to_f(kx[8 * hh + e][i]);
      rv[e] = rx != nullptr ? to_f(rx[8 * hh + e][i]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = 8 * hh + e;
      const float before = hh ? lb[8 + e] : lb[e];
      const float after = hh ? lb[9 + e] : lb[e + 1];
      const float qd = ex2(lb[kC] - after);
      kt[t][i] = kv[e] * qd;
      if (rx != nullptr) {
        const float p = ex2(before);
        de->rt[t][i] = rv[e] * p;
        de->p[t][i] = p;
        de->qd[t][i] = qd;
      }
    }
    if (hh == 0) dd[i] = ex2(lb[kC]);
  };

  // G and S0, columns 16 warp + 8 nt + 2 c4 (+ 1) of rows g and g + 8 of
  // this CTA's 16, the mma.sync accumulator layout (product warps only)
  float S[2][4], G[2][4];
  const long long ck_row =
      static_cast<long long>(q * kG) * HD + 16 * (warp & 3) + 2 * c4;
  auto ck_at = [&](int c) {
    return ckpt + (static_cast<long long>(bh) * chunks + c) * HD * HD + ck_row;
  };
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[n][e] = 0.0f;

  // --------------------------------------------------------- forward sweep --
  // step f: warps 4 and 5 take the decays of chunks 2f and 2f + 1, the
  // product warps the state through chunks 2f - 2 and 2f - 1
  if (loader) {
    for (int f = 0; f < min(kRingF, chunks); ++f) load_f(f);
  }
  for (int f = 0; 2 * f - 2 < chunks; ++f) {
    if (warp == kDecayWarp || warp == kLoop1Warp) {
      const int c = 2 * f + (warp == kLoop1Warp);
      if (loader) {
        // the slots of chunks 2f - 4 and 2f - 3, read at step f - 1
        for (int x = 2 * f - 4; x < 2 * f - 2; ++x)
          if (x >= 0 && x + kRingF < chunks) load_f(x + kRingF);
      }
      if (c < chunks) {
        const RawF<T, HD>& fw = fwd_of(c);
        FwdDec& fd = sm.fdec[c & 3];
        decays(fw.k, fw.lw, nullptr, fd.kt, fd.d, nullptr);
      }
    } else if (warp < NQ && f >= 1) {
      for (int c = 2 * f - 2; c < min(2 * f, chunks); ++c) {
        // S0 of chunk c to the checkpoint, then S ← D ⊙ S + K̂ᵀ V
        const RawF<T, HD>& fw = fwd_of(c);
        const FwdDec& fd = sm.fdec[c & 3];
        float* ck = ck_at(c);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<float2*>(ck + g * HD + 8 * n) =
              make_float2(S[n][0], S[n][1]);
          *reinterpret_cast<float2*>(ck + (g + 8) * HD + 8 * n) =
              make_float2(S[n][2], S[n][3]);
        }
        float ua[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ua[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ah[4], al[4];
          split4(fd.kt[8 * kk + c4][g], fd.kt[8 * kk + c4][g + 8],
                 fd.kt[8 * kk + c4 + 4][g], fd.kt[8 * kk + c4 + 4][g + 8], ah,
                 al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int j = 16 * warp + 8 * n + g;
            uint32_t bh0, bl0, bh1, bl1;
            tf32<kExactV>(to_f(fw.v[8 * kk + c4][j]), bh0, bl0);
            tf32<kExactV>(to_f(fw.v[8 * kk + c4 + 4][j]), bh1, bl1);
            mma3<kExactV>(ua[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        const float d0 = fd.d[g], d1 = fd.d[g + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          S[n][0] = fmaf(d0, S[n][0], ua[n][0]);
          S[n][1] = fmaf(d0, S[n][1], ua[n][1]);
          S[n][2] = fmaf(d1, S[n][2], ua[n][2]);
          S[n][3] = fmaf(d1, S[n][3], ua[n][3]);
        }
      }
    }
    CLK_MARK(0);
    __syncthreads();
    CLK_MARK(1);
  }

  // -------------------------------------------------------- backward sweep --
  // step m takes chunk chunks - 1 - m
#ifdef RWKV6_BWD_CLOCK
  clk_w = 5;
#endif
  if (loader) {
    for (int m = 0; m < min(kRing, chunks); ++m) load_b(m);
  }
  float Sa[2][4], Sb[2][4];        // S0 of the next two chunks
  auto load_s0 = [&](int m, float (&x)[2][4]) {
    if (m >= chunks) return;
    const float* ck = ck_at(chunks - 1 - m);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 a = *reinterpret_cast<const float2*>(ck + g * HD + 8 * n);
      const float2 b =
          *reinterpret_cast<const float2*>(ck + (g + 8) * HD + 8 * n);
      x[n][0] = a.x;
      x[n][1] = a.y;
      x[n][2] = b.x;
      x[n][3] = b.y;
    }
  };
  if (warp < NQ) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const long long row = static_cast<long long>(bh) * HD + q * kG + g;
      const int j = 16 * warp + 8 * n + 2 * c4;
      float2 a = make_float2(0.0f, 0.0f), b = a;
      if (dstate != nullptr) {
        a = *reinterpret_cast<const float2*>(dstate + row * HD + j);
        b = *reinterpret_cast<const float2*>(dstate + (row + 8) * HD + j);
      }
      G[n][0] = a.x;
      G[n][1] = a.y;
      G[n][2] = b.x;
      G[n][3] = b.y;
    }
    load_s0(0, Sa);
    load_s0(1, Sb);
  }
  float du_acc = 0.0f;             // warp 7: channel lane & 15, half lane >> 4

  for (int m = -2; m <= chunks; ++m) {
    if (warp < 4) {
      if (m >= 0 && m < chunks && warp < NQ) {
        // ------------------------------------------------------ products --
        const Raw<T, HD>& rw = raw_of(m);
        const Der& de = sm.der[m % kDer];
        Part& pt = sm.part[m & 1];
        const int w = warp;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            S[n][e] = Sa[n][e];
            Sa[n][e] = Sb[n][e];
          }
        load_s0(m + 2, Sb);
        // dK̂ᵀ (i x s) = G Vᵀ and dr̃ᵀ (i x t) = S0 dYᵀ over this warp's
        // columns (k-step kk: columns 8 kk + 2 c4 and + 1, the accumulator's
        // pairs), and rowsum(G ⊙ S0) over them
        float dka[2][4], dra[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[n][e] = dra[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t gh[4], gl[4], sh[4], sl[4];
          split4(G[kk][0], G[kk][2], G[kk][1], G[kk][3], gh, gl);
          split4(S[kk][0], S[kk][2], S[kk][1], S[kk][3], sh, sl);
          const int j = 16 * w + 8 * kk + 2 * c4;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float2 b = pair(&rw.v[8 * n + g][j]);
            uint32_t bh0, bl0, bh1, bl1;
            tf32<kExactV>(b.x, bh0, bl0);
            tf32<kExactV>(b.y, bh1, bl1);
            mma3<kExactV>(dka[n], gh, gl, bh0, bh1, bl0, bl1);
            const float2 y = pair(&rw.dy[8 * n + g][j]);
            tf32<false>(y.x, bh0, bl0);
            tf32<false>(y.y, bh1, bl1);
            mma3<false>(dra[n], sh, sl, bh0, bh1, bl0, bl1);
          }
        }
        float dd0 = 0.0f, dd1 = 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          dd0 = fmaf(G[n][0], S[n][0], dd0);
          dd0 = fmaf(G[n][1], S[n][1], dd0);
          dd1 = fmaf(G[n][2], S[n][2], dd1);
          dd1 = fmaf(G[n][3], S[n][3], dd1);
        }
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, 1);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, 1);
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, 2);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, 2);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int t = 8 * n + 2 * c4;
          pt.dkt[w][t][g] = dka[n][0];
          pt.dkt[w][t + 1][g] = dka[n][1];
          pt.dkt[w][t][g + 8] = dka[n][2];
          pt.dkt[w][t + 1][g + 8] = dka[n][3];
          pt.drt[w][t][g] = dra[n][0];
          pt.drt[w][t + 1][g] = dra[n][1];
          pt.drt[w][t][g + 8] = dra[n][2];
          pt.drt[w][t + 1][g + 8] = dra[n][3];
          *reinterpret_cast<float2*>(&sm.gold[w][g][8 * n + 2 * c4]) =
              make_float2(G[n][0], G[n][1]);
          *reinterpret_cast<float2*>(&sm.gold[w][g + 8][8 * n + 2 * c4]) =
              make_float2(G[n][2], G[n][3]);
        }
        if (c4 == 0) {
          pt.dd[w][g] = dd0;
          pt.dd[w][g + 8] = dd1;
        }
        __syncwarp();
        // dY's fragments over t (k-step kk) for this warp's columns, split
        uint32_t yh[2][2][2], yl[2][2][2];    // [kk][n][b0/b1]
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int j = 16 * w + 8 * n + g;
            tf32<false>(rw.dy[8 * kk + c4][j], yh[kk][n][0], yl[kk][n][0]);
            tf32<false>(rw.dy[8 * kk + c4 + 4][j], yh[kk][n][1],
                        yl[kk][n][1]);
          }
        // G ← D ⊙ G + r̃ᵀ dY; dV's share = K̂ G_old + A_qᵀ dY. dv goes out in
        // the inputs' type: for bf16 its two products are taken in plain
        // TF32 (the operands' bits as they are, one pass), which keeps dv
        // well inside bf16's own rounding; for float32 in split TF32
        float ga[2][4], va[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ga[n][e] = va[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int t = 8 * kk + c4;
          uint32_t rh[4], rl[4], kh[4], kl[4], ah[4], al[4];
          split4(de.rt[t][g], de.rt[t][g + 8], de.rt[t + 4][g],
                 de.rt[t + 4][g + 8], rh, rl);
          if constexpr (kExactV) {
            const float kx[4] = {de.kt[g][t], de.kt[g + 8][t],
                                 de.kt[g][t + 4], de.kt[g + 8][t + 4]};
            const float ax[4] = {de.aq[t][g], de.aq[t][g + 8],
                                 de.aq[t + 4][g], de.aq[t + 4][g + 8]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              kh[e] = __float_as_uint(kx[e]);
              ah[e] = __float_as_uint(ax[e]);
            }
          } else {
            split4(de.kt[g][t], de.kt[g + 8][t], de.kt[g][t + 4],
                   de.kt[g + 8][t + 4], kh, kl);
            split4(de.aq[t][g], de.aq[t][g + 8], de.aq[t + 4][g],
                   de.aq[t + 4][g + 8], ah, al);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma3<false>(ga[n], rh, rl, yh[kk][n][0], yh[kk][n][1],
                        yl[kk][n][0], yl[kk][n][1]);
            const float g0 = sm.gold[w][t][8 * n + g];
            const float g1 = sm.gold[w][t + 4][8 * n + g];
            if constexpr (kExactV) {
              mma_tf32(va[n], kh, __float_as_uint(g0), __float_as_uint(g1));
              mma_tf32(va[n], ah, yh[kk][n][0], yh[kk][n][1]);
            } else {
              uint32_t bh0, bl0, bh1, bl1;
              tf32<false>(g0, bh0, bl0);
              tf32<false>(g1, bh1, bl1);
              mma3<false>(va[n], kh, kl, bh0, bh1, bl0, bl1);
              mma3<false>(va[n], ah, al, yh[kk][n][0], yh[kk][n][1],
                          yl[kk][n][0], yl[kk][n][1]);
            }
          }
        }
        const float d0 = de.d[g], d1 = de.d[g + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          G[n][0] = fmaf(d0, G[n][0], ga[n][0]);
          G[n][1] = fmaf(d0, G[n][1], ga[n][1]);
          G[n][2] = fmaf(d1, G[n][2], ga[n][2]);
          G[n][3] = fmaf(d1, G[n][3], ga[n][3]);
        }
        // the share to CTA w, which owns columns 16w..16w+15, once every
        // owner has summed this slot's round before (st.async: the owner's
        // recv_full counts the bytes as they land)
        if (m >= 2)
          wait_bar(smem_u32(&sm.recv_empty[m & 1]), ((m >> 1) & 1) ^ 1);
        const uint32_t dst = in_cta(smem_u32(&sm.recv[m & 1][q][0][0]), w);
        const uint32_t bar = in_cta(smem_u32(&sm.recv_full[m & 1]), w);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t o = 4 * (g * kG + 8 * n + 2 * c4);
          st_async2(dst + o, va[n][0], va[n][1], bar);
          st_async2(dst + o + 4 * 8 * kG, va[n][2], va[n][3], bar);
        }
      }
    } else if (warp == kDecayWarp) {
      // ---------------------------------- TMA, dA, decays, dv's sum --
      if (loader && m >= 1 && m - 1 + kRing < chunks) load_b(m - 1 + kRing);
      if (m + 2 < chunks) chunk_da<T, HD>(raw_of(m + 2), sm.da[m & 1], lane);
      if (m + 1 < chunks && m + 1 >= 0) {
        const Raw<T, HD>& rw = raw_of(m + 1);
        Der& de = sm.der[(m + 1) % kDer];
        decays(rw.k, rw.lw, rw.r, de.kt, de.d, &de);
      }
      if (m >= 1) {
        // round m - 1 (chunk chunks - m): the NQ shares in rank order; then
        // the slot is armed for round m + 1 and every CTA told that its
        // shares here are summed
        const int rd = m - 1, t0 = (chunks - m) * kC;
        wait_bar(smem_u32(&sm.recv_full[rd & 1]), (rd >> 1) & 1);
        const float(*rc)[kC][kG] = sm.recv[rd & 1];
        const int j = lane & 15;
        const long long step = 2LL * heads * HD;
        const long long o0 = at(t0 + (lane >> 4), q * kG + j);
        const int valid = t_len - t0 - (lane >> 4);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int s = 2 * x + (lane >> 4);
          float acc = rc[0][s][j];
#pragma unroll
          for (int r = 1; r < NQ; ++r) acc += rc[r][s][j];
          if (2 * x < valid) store(dv + o0 + x * step, acc);
        }
        __syncwarp();
        if (loader && rd + 2 < chunks)
          mbar_expect_tx(smem_u32(&sm.recv_full[rd & 1]), kRecvTx);
        if (lane < NQ) mbar_arrive_at(smem_u32(&sm.recv_empty[rd & 1]), lane);
      }
    } else if (warp == kLoop1Warp || warp == kLoop2Warp) {
      // --------------------------------------------- the decay loops --
      if (m + 1 < chunks && m + 1 >= 0) {
        const bool one = warp == kLoop1Warp;
        const Raw<T, HD>& rw = raw_of(m + 1);
        Der& de = sm.der[(m + 1) % kDer];
        LoopScr& sc = sm.scr[one ? 0 : 1];
        const float(*dA)[17] = sm.da[(m + 1) & 1];    // warp 4's, a step ago
        CLK_MARK(2);
        // lane (row t, channels 8h..8h+7): w, and k (loop 1) or r (loop 2)
        const int t = lane >> 1, h = lane & 1;
        float x[8], rq[8], kq[8], uu[8];
        load8(&rw.lw[t][8 * h], x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = ex2(x[e] * kLog2e);
        store8(&sc.w[t][8 * h], x);
        load8(&rw.r[t][8 * h], rq);
        load8(&rw.k[t][8 * h], kq);
        if (one) {
          store8(&sc.x[t][8 * h], kq);
        } else {
          store8(&sc.x[t][8 * h], rq);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) uu[e] = sm.u[8 * h + e];
        __syncwarp();     // the warp's rows of w and k or r written
        CLK_MARK(6);
        const float dtt = dA[t][t];
        float acc[8], W[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[e] = 0.0f;
          W[e] = 0.0f;
        }
        if (one) {
          // row t: s = 14 down to 0, every lane at the same s (so that the
          // rows of w and k are broadcast reads); lanes with s >= t keep
          // W = 0. acc = Σ_{s<t} dA[t][s] k_s ⊙ W[t][s], whence Σ_s M[t][s]
          // = r_t ⊙ acc. Each step's rows are read a step ahead.
          float wr[8], kr[8];
          load8(&sc.w[kC - 1][8 * h], wr);
          load8(&sc.x[kC - 2][8 * h], kr);
#pragma unroll
          for (int s = kC - 2; s >= 0; --s) {
            float wn[8], kn[8];
            if (s > 0) {
              load8(&sc.w[s][8 * h], wn);
              load8(&sc.x[s - 1][8 * h], kn);
            }
            const float st = s == t - 1 ? 1.0f : 0.0f;
            const float da = dA[t][s];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              W[e] = fmaf(W[e], wr[e], st);     // 1 at s = t - 1, 0 before
              acc[e] = fmaf(da, kr[e] * W[e], acc[e]);
            }
            if (s > 0) {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                wr[e] = wn[e];
                kr[e] = kn[e];
              }
            }
          }
          CLK_MARK(7);
          float mm[8], dc[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            mm[e] = rq[e] * acc[e];
            dc[e] = rq[e] * kq[e] * dtt;
            acc[e] = fmaf(uu[e] * kq[e], dtt, acc[e]);
          }
          store8(&de.drp[t][8 * h], acc);
          store8(&de.rowm[t][8 * h], mm);
          store8(&de.duc[t][8 * h], dc);
        } else {
          // column s = t: t' = 1 up to 15, every lane at the same t'; lanes
          // with t' <= s keep W = 0. acc = Σ_{t'>s} dA[t'][s] r_t' ⊙
          // W[t'][s], whence Σ_t' M[t'][s] = k_s ⊙ acc. A's column s too
          // (this loop has the lighter arithmetic): the lane's 8 channels'
          // share of each entry is kept in registers, summed with the lane
          // pair's after the loop and stored then, so that the loop holds
          // no shuffle and no store. Each step's rows are read a step ahead.
          const int s = t;
          float dg = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dg = fmaf(rq[e] * uu[e], kq[e], dg);
          float res[kC], wr[8], rr[8];
          load8(&sc.w[0][8 * h], wr);
          load8(&sc.x[1][8 * h], rr);
#pragma unroll
          for (int tt = 1; tt < kC; ++tt) {
            float wn[8], rn[8];
            if (tt < kC - 1) {
              load8(&sc.w[tt][8 * h], wn);
              load8(&sc.x[tt + 1][8 * h], rn);
            }
            const float st = tt == s + 1 ? 1.0f : 0.0f;
            const float da = dA[tt][s];
            float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              W[e] = fmaf(W[e], wr[e], st);     // 1 at t' = s + 1, 0 before
              const float xr = rr[e] * W[e];
              acc[e] = fmaf(da, xr, acc[e]);
              if (e & 1) {
                a1 = fmaf(kq[e], xr, a1);
              } else {
                a0 = fmaf(kq[e], xr, a0);
              }
            }
            res[tt] = a0 + a1;
            if (tt < kC - 1) {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                wr[e] = wn[e];
                rr[e] = rn[e];
              }
            }
          }
          CLK_MARK(7);
          dg += __shfl_xor_sync(0xffffffffu, dg, 1);
#pragma unroll
          for (int tt = 1; tt < kC; ++tt)
            res[tt] += __shfl_xor_sync(0xffffffffu, res[tt], 1);
          float mm[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            mm[e] = kq[e] * acc[e];
            acc[e] = fmaf(uu[e] * rq[e], dtt, acc[e]);
          }
          store8(&de.dkp[s][8 * h], acc);
          store8(&de.colm[s][8 * h], mm);
          if (h == 0) {
            de.aq[s][s] = dg;
#pragma unroll
            for (int tt = 1; tt < kC; ++tt)
              if (tt > s) de.aq[tt][s] = res[tt];
          }
        }
      }
    } else if (m >= 1) {
      // ------------------------------------------------------------ finals --
      // chunk chunks - 1 - (m - 1): lane (channel i, steps 8hh..8hh+7)
      const int mc = m - 1;
      const int t0 = (chunks - 1 - mc) * kC;
      const Der& de = sm.der[mc % kDer];
      const Part& pt = sm.part[mc & 1];
      const int i = lane & 15, hh = lane >> 4;
      float dD = pt.dd[0][i];
#pragma unroll
      for (int w = 1; w < NQ; ++w) dD += pt.dd[w][i];
      const float base = de.d[i] * dD;
      // the lane's 8 steps in the outputs, one head row apart; only the
      // last chunk has steps past T
      const long long step = static_cast<long long>(heads) * HD;
      const long long o0 = at(t0 + 8 * hh, q * kG + i);
      const int valid = t_len - t0 - 8 * hh;
      float a[8], b[8], c[8];
      float ta = 0.0f, tb = 0.0f, tc = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = 8 * hh + e;
        float drt = pt.drt[0][t][i], dkt = pt.dkt[0][t][i];
#pragma unroll
        for (int w = 1; w < NQ; ++w) {
          drt += pt.drt[w][t][i];
          dkt += pt.dkt[w][t][i];
        }
        a[e] = fmaf(de.rt[t][i], drt, de.rowm[t][i]);
        b[e] = de.kt[t][i] * dkt;
        c[e] = de.colm[t][i];
        ta += a[e];
        tb += b[e];
        tc += c[e];
        du_acc += de.duc[t][i];
        if (e < valid) {
          store(dr + o0 + e * step, fmaf(drt, de.p[t][i], de.drp[t][i]));
          store(dk + o0 + e * step, fmaf(dkt, de.qd[t][i], de.dkp[t][i]));
        }
      }
      // the other half's totals: Σ_{t>τ} a and Σ_{s>=τ} c take the later
      // half's, Σ_{s<τ} b the earlier half's
      const float oa = __shfl_xor_sync(0xffffffffu, ta, 16);
      const float ob = __shfl_xor_sync(0xffffffffu, tb, 16);
      const float oc = __shfl_xor_sync(0xffffffffu, tc, 16);
      float sa = hh == 0 ? oa : 0.0f, sc = hh == 0 ? oc : 0.0f;
      float dl[8];
#pragma unroll
      for (int e = 7; e >= 0; --e) {
        sc += c[e];
        dl[e] = sa - sc;
        sa += a[e];
      }
      float pb = hh == 1 ? ob : 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < valid) dlogw[o0 + e * step] = (base + pb) + dl[e];
        pb += b[e];
      }
    }
    CLK_MARK(2);
    __syncthreads();
    CLK_MARK(3);
  }
  // no CTA leaves while a peer may still write to or arrive on it
  cluster_sync_all();
  if (warp == 7) {
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 16);
    if (lane < 16)
      du_part[static_cast<long long>(bh) * HD + q * kG + lane] = du_acc;
  }
#ifdef RWKV6_BWD_CLOCK
  if (lane == 0 && dstate != nullptr) {
    unsigned* out = reinterpret_cast<unsigned*>(const_cast<float*>(dstate)) +
                    (static_cast<long long>(blockIdx.x) * 8 + warp) * 8;
    for (int x = 0; x < 8; ++x) out[x] = clk[x];
  }
#endif
}

// du[h][c] = Σ_b du_part[b][h][c], in order; n = H · hd.
__global__ void wkv_du_kernel(const float* __restrict__ part,
                              float* __restrict__ du, int batch, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float s = 0.0f;
  for (int b = 0; b < batch; ++b) s += part[static_cast<long long>(b) * n + x];
  du[x] = s;
}

// A contiguous (b, s, h, d) tensor as (b, s, h·d), read in boxes of `box_w`
// elements (from a head's start: its d and the next head's first box_w - d)
// x `box_s` rows, not swizzled. What lies past h·d or s reads as zero.
int encode_flat(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int bytes, int b, int s, int hd_all, int box_w, int box_s) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd_all),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd_all) * bytes;
  const cuuint64_t strides[2] = {row, row * s};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_s), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(Smem<T, HD>);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* dy, const void* dstate, void* ckpt,
           void* dr, void* dk, void* dv, void* dlogw, void* du_part, void* du,
           int batch, int t, int heads, cudaStream_t stream) {
  constexpr int NQ = HD / kG;
  CUtensorMap mr, mk, mw, mv, mdy;
  const CUtensorMapDataType ty = tma_type<T>();
  const int es = static_cast<int>(sizeof(T));
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = encode_rows(&mr, r, ty, es, batch, t, heads, HD, kG, kC);
  if (err == 0) err = encode_rows(&mk, k, ty, es, batch, t, heads, HD, kG, kC);
  if (err == 0)
    err = encode_rows(&mw, logw, f32, 4, batch, t, heads, HD, kG, kC);
  if (err == 0)
    err = encode_flat(&mv, v, ty, es, batch, t, heads * HD, HD + kPad, kC);
  if (err == 0)
    err = encode_flat(&mdy, dy, f32, 4, batch, t, heads * HD, HD + kPad, kC);
  if (err != 0) return err;
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t cerr = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * heads * NQ, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NQ;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cerr = cudaLaunchKernelEx(
      &cfg, wkv_bwd_kernel<T, HD>, mr, mk, mw, mv, mdy,
      static_cast<const float*>(u), static_cast<const float*>(dstate),
      static_cast<float*>(ckpt), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dlogw),
      static_cast<float*>(du_part), t, heads);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  wkv_du_kernel<<<(heads * HD + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), batch,
      heads * HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int max_clusters() {
  constexpr int NQ = HD / kG;
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t cerr = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NQ * 1024, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NQ;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cerr = cudaOccupancyMaxActiveClusters(&n, wkv_bwd_kernel<T, HD>, &cfg);
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  return n;
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv: contiguous (b, t, H, hd) of float32 (bf16 = 0) or
// bf16 (bf16 = 1); logw, dy, dlogw (b, t, H, hd) float32; u (H, hd)
// float32; dstate (b, H, hd, hd) float32 or null; scratch: ckpt (b, H,
// ceil(t / 16), hd, hd) and du_part (b, H, hd), float32; du (H, hd)
// float32. hd is 16 or 64; r, k, v, logw and dy start on 16 bytes (TMA).
// Two kernels on the stream: the sweeps, then du's sum over the batch.
// Returns 0, the cudaError_t of the first launch that failed, or
// kEncodeError plus the CUresult of a failed tensor-map encoding.
int rwkv6_wkv_bwd_launch(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* dy,
                         const void* dstate, void* ckpt, void* dr, void* dk,
                         void* dv, void* dlogw, void* du_part, void* du,
                         int batch, int t, int heads, int hd, int bf16,
                         void* stream) {
  if (hd != 16 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || t == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(r, k, v, logw, u, dy, dstate,
                                            ckpt, dr, dk, dv, dlogw, du_part,
                                            du, batch, t, heads, st)
                : launch<float, 64>(r, k, v, logw, u, dy, dstate, ckpt, dr,
                                    dk, dv, dlogw, du_part, du, batch, t,
                                    heads, st);
  }
  return bf16 ? launch<__nv_bfloat16, 16>(r, k, v, logw, u, dy, dstate, ckpt,
                                          dr, dk, dv, dlogw, du_part, du,
                                          batch, t, heads, st)
              : launch<float, 16>(r, k, v, logw, u, dy, dstate, ckpt, dr, dk,
                                  dv, dlogw, du_part, du, batch, t, heads,
                                  st);
}

// The dynamic shared memory a CTA takes at head size hd, in bytes.
int rwkv6_wkv_bwd_smem_bytes(int hd, int bf16) {
  if (hd == 16)
    return static_cast<int>(bf16 ? smem_bytes<__nv_bfloat16, 16>()
                                 : smem_bytes<float, 16>());
  return static_cast<int>(bf16 ? smem_bytes<__nv_bfloat16, 64>()
                               : smem_bytes<float, 64>());
}

// How many clusters of this kernel the current device holds at once at
// head size hd: at least b · H of them run together. Returns it, or minus
// the cudaError_t of the query.
int rwkv6_wkv_bwd_clusters(int hd, int bf16) {
  if (hd == 16)
    return bf16 ? max_clusters<__nv_bfloat16, 16>() : max_clusters<float, 16>();
  return bf16 ? max_clusters<__nv_bfloat16, 64>() : max_clusters<float, 64>();
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
