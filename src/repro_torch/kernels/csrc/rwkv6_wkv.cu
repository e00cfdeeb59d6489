// W: RWKV6's WKV recurrence, a whole sequence in one launch, in chunks on
// the tensor cores.
//
// Port only: no Pallas kernel stands behind it. It stands for the
// jax.lax.scan over T in rwkv6_apply and rwkv6_prefill
// (src/repro/models/rwkv6.py:97-111, :123-137), which eager PyTorch would
// run as a Python loop of some six launches a step.
//
// What it computes, for each batch row and head, from r, k, v (b, T, H, hd)
// of the model's type T, the log-decay logw (b, T, H, hd) float32 and the
// bonus u (H, hd) float32, with a float32 (dk x dv) state S from zero:
//   y_t[j]  = sum over i of r_t[i] · (S[i][j] + u[i] · k_t[i] · v_t[j])
//   S[i][j] = exp(logw_t[i]) · S[i][j] + k_t[i] · v_t[j]
// y float32 (b, T, H, hd) and the last S float32 (b, H, hd, hd): the plain
// version's function (kernels/rwkv6_wkv/ref.py::wkv_ref) in another
// arithmetic, so it is held to it by a tolerance (1e-5 of the largest
// value), not bit for bit. Every sum runs in a fixed order and there are
// no atomics: two runs give the same bits.
//
// The chunked form (ref.py::wkv_chunked is its plain mirror). Over a chunk
// of C steps from S0, with lb_t the base-2 log of the decay before step t
// within the chunk (the sum of logw · log2 e over the chunk's earlier
// steps), L the chunk's total and w_t = 2^(logw_t · log2 e):
//   r̃_t = r_t · 2^lb_t,  K̂_s = k_s · 2^(L - lb_{s+1}),  D = 2^L,
//   A[t][s] = sum over i of r_t[i] k_s[i] · (w_{s+1} ⊙ ... ⊙ w_{t-1})[i]
//             for s < t,  A[t][t] = r_t · (u ⊙ k_t),
//   y_t = r̃_tᵀ S0 + sum over s <= t of A[t][s] v_s,
//   S_C = D ⊙ S0 + K̂ᵀ V.
// Every factor is at most 1, so nothing overflows however fast the decay
// (a factor e^b_t · e^-b_s over the chunk would: at logw = -12 a step,
// e^-b passes float32's range in 8 steps). A's decays are taken as
// products of w, a multiply a term, in float32 on the CUDA cores. The
// products r̃ᵀS0, K̂ᵀV and A·V run on the tensor cores (mma.sync m16n8k8)
// in split TF32: a float32 operand as hi + lo (hi rounded to TF32 by an
// integer add and a mask), hi·hi + hi·lo + lo·hi, ~2^-21 of a product
// where plain TF32 keeps ~2^-11, which would miss the tolerance; a bf16 v
// is exact in TF32 and is not split.
//
// C = 16 and no sub-chunks (the mirror's sub = chunk). The products with
// the state cost the same per step at any C (hd x hd a step each); what a
// longer chunk adds is A's blocks between sub-chunks and a wider A·V, all
// more work. The chain from chunk to chunk is S ← D ⊙ S + U, one
// multiply-add an element in registers, with U = K̂ᵀV and everything else
// computed off the chain, so a short chunk costs the chain nothing.
//
// Layout. A cluster of hd / 16 CTAs takes one (batch, head): four at hd 64,
// one at hd 16. CTA q keeps S's columns 16q..16q+15 in registers over all
// of T and stages the head's channels 16q..16q+15 (channel group q). Nine
// warps, in roles that meet at mbarriers, a stage of two chunks at a time:
//   - warp 4's lane 0 brings each stage's 32 x 16 tiles of r, k, v (the
//     CTA's columns) and logw by TMA into a ring of 2 slots;
//   - warps 4-5 (the decays): lane (chunk, channel) takes its channel's
//     prefix over the chunk in registers, then r̃, K̂, D of half the steps,
//     and v's mma.sync fragments;
//   - warps 6-7 (A): one a chunk, its group's share of A (a sum over the
//     group's 16 channels), lane (row t, 8 channels), every lane at the
//     same entry s so that the rows of w and k are broadcast reads;
//   - the group's tiles (r̃, K̂, A's share, D; 6.3 KB a stage) go to the
//     cluster's other CTAs by bulk copies (cp.async.bulk, shared to shared,
//     counted by the receiving slot's mbarrier), into 3 slots;
//   - warps 0-3 (the products): warp w holds Sᵀ (cols x dk) for dk group
//     w in the mma.sync accumulator layout, which is both the A operand of
//     its share of yᵀ = Sᵀ r̃ᵀ (the dk order permuted within each 8 so that
//     the accumulator's pairs are the operand's) and where Uᵀ = Vᵀ K̂ lands;
//     A is the four groups' shares added in group order;
//   - warp 8 adds the four warps' shares of y in order w = 0..3, stores y,
//     and tells every CTA's staging that the slot is free.
// The tiles are 16 x 16 floats with rows 2 and 3 of every 4 half-swapped,
// so that the fragments' 8-byte reads meet no bank twice with no pad to
// copy. At rwkv6-3b's (1, 8192, 40, 64) that is 160 CTAs of nine warps in
// 40 clusters, 256 stages each, with 110.8 KB of shared memory a CTA: two
// fit on an SM, so the 160 CTAs are resident at once on 132 SMs, 28 or
// more of them two to an SM.
//
// Bound on an H100 at that shape: bytes. r, k, v in bf16 and logw read
// once, y and the last state written once in float32: 294.3 MB, 0.0878 ms
// at 3.35 TB/s. The
// operations (5·H·hd²·T = 6.71e9 float32: 0.100 ms on the CUDA cores, the
// previous design's bound) run here as tensor-core products, ~0.04 ms even
// at three TF32 products each. The kernel sits well above both: each
// CTA's stages are a chain of waits between roles and across the cluster,
// and two CTAs share an SM's issue slots and shared-memory bandwidth
// (benchmarks_torch/w_variants.py takes the parts out in turns).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 16;            // steps a chunk
constexpr int kPer = 2;           // chunks a stage
constexpr int kS = kC * kPer;     // steps a stage
constexpr int kG = 16;            // channels (and S's columns) a CTA
// warps 0-3 take the products; of the staging warps, 4-5 the decays and v's
// fragments, half each, and 6-7 A's share, one chunk a warp
// warp 8 adds the product warps' shares of y, stores y and tells the
// cluster's staging that a stage's products are done
constexpr int kThreads = 288;
constexpr int kRing = 2;          // TMA slots, a stage each
constexpr int kSlots = 3;         // slots of staged stages
constexpr int kWW = 20;           // floats a row of w, kf: 16 and a pad
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kPer == 2, "two warps stage A, a chunk each");

// Element (row, col) of a 16 x 16 float tile (rt, kt, ap, yp): rows 2 and
// 3 of every 4 have their two halves swapped, so that the fragments' 8-byte
// reads (four rows of a column pair a phase) meet no bank twice, and the
// tiles carry no pad into the copies between CTAs.
__device__ __forceinline__ int at(int row, int col) {
  return row * 16 + (col ^ ((row & 2) << 2));
}

// One stage's tiles as TMA lands them: kS steps x 16 channels (or, for v,
// the CTA's 16 columns).
template <typename T>
struct __align__(128) Raw {
  T r[kS][kG];
  T k[kS][kG];
  T v[kS][kG];
  float lw[kS][kG];
};

// One chunk staged for a channel group: what every CTA of the cluster
// reads, copied from the group's CTA to the others.
struct __align__(16) Group {
  float rt[kC * kG];              // r̃[t][channel]
  float kt[kC * kG];              // K̂[step][channel]
  float ap[kC * kC];              // the group's share of A[t][s]
  float d[kG];                    // 2^L
};
static_assert(sizeof(Group) % 16 == 0, "bulk copies move 16-byte units");

// An A warp's chunk: each step's decay w = 2^(logw · log2 e) and k, as
// float.
struct __align__(16) AScratch {
  float w[kC][kWW];
  float kf[kC][kWW];
};

template <typename T, int NQ>
struct Smem {
  Raw<T> raw[kRing];
  // [slot][channel group][chunk]: group q's chunks of a slot are one copy
  Group grp[kSlots][NQ][kPer];
  // Vᵀ's mma.sync fragments for this CTA's columns, a lane, step half h:
  // [h] hi, [2 + h] lo (a float32 v only; a bf16 v is exact in TF32)
  float4 vf[kSlots][kPer][sizeof(T) == 2 ? 2 : 4][32];
  // product warps' shares of yᵀ (cols x steps), a stage in each of two
  float yp[2][kPer][4][kG * kC];
  AScratch scr[kPer];
  float u[kG];
  unsigned long long raw_full[kRing];
  unsigned long long full[kSlots];   // a stage staged here, every group
  unsigned long long empty[kSlots];  // a stage's products done everywhere
  unsigned long long y_full[2];      // a stage's shares of y written
  unsigned long long y_empty[2];     // and read
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 128 threads of one role (id 1 the products, 2 the staging).
__device__ __forceinline__ void role_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// This CTA's shared address `a` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t in_cta(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// One arrival on the mbarrier at `bar` in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   in_cta(bar, rank))
               : "memory");
}

// Copies `bytes` at this CTA's `src` to the same place in CTA `rank`, whose
// mbarrier at `bar` counts them as they land (the bulk-copy engine, in the
// async proxy: no thread waits on it).
__device__ __forceinline__ void copy_to(uint32_t src, uint32_t bytes,
                                        uint32_t bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(in_cta(src, rank)),
      "r"(src), "r"(bytes), "r"(in_cta(bar, rank))
      : "memory");
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

__device__ __forceinline__ void to_u32(const float4 f, uint32_t (&a)[4]) {
  a[0] = __float_as_uint(f.x);
  a[1] = __float_as_uint(f.y);
  a[2] = __float_as_uint(f.z);
  a[3] = __float_as_uint(f.w);
}

// One CTA: (batch, head) = blockIdx.x / NQ, rank q = blockIdx.x % NQ in its
// cluster of NQ = HD / 16.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const __grid_constant__ CUtensorMap map_r,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap map_w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int t_len, int heads) {
  constexpr int NQ = HD / kG;
  constexpr bool kExactV = sizeof(T) == 2;
  constexpr uint32_t kTx = (3 * sizeof(T) + sizeof(float)) * kS * kG;
  constexpr uint32_t kGroupBytes = kPer * sizeof(Group);
  // (taken as a shared array, not through an integer, so that every access
  // stays a shared-memory one)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, NQ>& sm = *reinterpret_cast<Smem<T, NQ>*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / NQ;
  const int head = bh % heads;
  const int batch = bh / heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warp-uniform to the compiler (a shuffle's result), so that the roles'
  // branches hold no divergent shuffles
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int n_stages = (t_len + kS - 1) / kS;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(smem_u32(&sm.raw_full[s]), 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), NQ);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_u32(&sm.y_full[s]), 1);
      mbar_init(smem_u32(&sm.y_empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // above the diagonal A stays zero: its entries are never written
  for (int s = 0; s < kSlots; ++s)
    for (int c = 0; c < kPer; ++c)
      for (int e = tid; e < kC * kC; e += kThreads)
        sm.grp[s][q][c].ap[e] = 0.0f;
  if (tid < kG) sm.u[tid] = u[head * HD + q * kG + tid];
  __syncthreads();
  cluster_arrive();
  cluster_wait();     // every CTA's barriers initialised

  // Sᵀ: columns (rows g, g + 8) x the warp's dk group (n-tile j: 8j + 2 c4
  // and + 1), the accumulator layout; warps 0..NQ-1 of the products
  float sacc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;

  if (warp >= 4 && warp < 8) {
    // ------------------------------------------------------------ staging --
    const int pt_id = tid - 128;
    auto issue = [&](int n) {   // stage n's tiles into its TMA slot
      const int s = n % kRing;
      const uint32_t bar = smem_u32(&sm.raw_full[s]);
      const int t0 = n * kS, c0 = q * kG;
      mbar_expect_tx(bar, kTx);
      tma_load(&sm.raw[s].r[0][0], &map_r, bar, c0, head, t0, batch);
      tma_load(&sm.raw[s].k[0][0], &map_k, bar, c0, head, t0, batch);
      tma_load(&sm.raw[s].v[0][0], &map_v, bar, c0, head, t0, batch);
      tma_load(&sm.raw[s].lw[0][0], &map_w, bar, c0, head, t0, batch);
    };
    if (pt_id == 0) {
      for (int n = 0; n < min(kRing, n_stages); ++n) issue(n);
    }
    for (int n = 0; n < n_stages; ++n) {
      const int slot = n % kSlots;
      const Raw<T>& rw = sm.raw[n % kRing];
      // every CTA's products are done with this slot's last stage
      mbar_wait(smem_u32(&sm.empty[slot]), ((n / kSlots) & 1) ^ 1);
      mbar_wait(smem_u32(&sm.raw_full[n % kRing]), (n / kRing) & 1);
      if (warp < 6) {
        // the decays: lane (chunk c, channel i) of warp 4 + hs takes its
        // channel's prefix over the chunk's 16 steps in registers, then r̃
        // and K̂ of steps 8hs..8hs+7 (and D)
        const int hs = warp - 4, c = lane >> 4, i = lane & 15;
        Group& gr = sm.grp[slot][q][c];
        float lb[kC + 1];               // log2 of the decay before step t
        lb[0] = 0.0f;
#pragma unroll
        for (int t = 0; t < kC; ++t)
          lb[t + 1] = lb[t] + rw.lw[kC * c + t][i] * kLog2e;
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          if ((t >> 3) != hs) continue;   // (t static: lb stays in registers)
          gr.rt[at(t, i)] = to_f(rw.r[kC * c + t][i]) * ex2(lb[t]);
          gr.kt[at(t, i)] =
              to_f(rw.k[kC * c + t][i]) * ex2(lb[kC] - lb[t + 1]);
        }
        if (hs == 0) gr.d[i] = ex2(lb[kC]);
        // and Vᵀ's fragments for the products of chunk hs, step half h:
        // lane l's a0..a3 are v[8h + 2 c4][g], v[..][g + 8],
        // v[8h + 2 c4 + 1][g], v[..][g + 8]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gg = lane >> 2, s = kC * hs + 8 * h + 2 * (lane & 3);
          const float a[4] = {to_f(rw.v[s][gg]), to_f(rw.v[s][gg + 8]),
                              to_f(rw.v[s + 1][gg]),
                              to_f(rw.v[s + 1][gg + 8])};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(a[j], hi[j], lo[j]);
          *reinterpret_cast<uint4*>(&sm.vf[slot][hs][h][lane]) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          if constexpr (!kExactV) {
            *reinterpret_cast<uint4*>(&sm.vf[slot][hs][2 + h][lane]) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
      } else {
        // A's share of chunk c over this CTA's 16 channels, lane (row t,
        // channels 8h..8h+7): the decays taken as products, so it needs no
        // prefix, and the two halves added by a shuffle. The entries are
        // kept in registers and stored after the loop, which then holds no
        // store for its loads to wait behind.
        const int c = warp - 6, t = lane >> 1, h = lane & 1;
        AScratch& sc = sm.scr[c];
        const int row = kC * c + t;
        float x[8], kk[8], qq[8];
        load8(&rw.lw[row][8 * h], x);
        load8(&rw.k[row][8 * h], kk);
        load8(&rw.r[row][8 * h], qq);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = ex2(x[i] * kLog2e);
        store8(&sc.w[t][8 * h], x);
        store8(&sc.kf[t][8 * h], kk);
        float dg0 = 0.0f, dg1 = 0.0f;     // the diagonal, r_t · (u ⊙ k_t)
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          dg0 = fmaf(qq[i] * sm.u[8 * h + i], kk[i], dg0);
          dg1 = fmaf(qq[i + 1] * sm.u[8 * h + i + 1], kk[i + 1], dg1);
        }
        float dg = dg0 + dg1;
        dg += __shfl_xor_sync(0xffffffffu, dg, 1);
        __syncwarp();
        // entries s = 14 down to 0, every lane at the same s (so that the
        // rows of w and k are broadcast reads): q = r_t from s = t - 1,
        // then q ← q ⊙ w_{s+1}; lanes with s >= t hold q = 0
        float res[kC - 1], rq[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rq[i] = qq[i];
          qq[i] = 0.0f;
        }
#pragma unroll
        for (int s = kC - 2; s >= 0; --s) {
          load8(&sc.w[s + 1][8 * h], x);
          load8(&sc.kf[s][8 * h], kk);
          const bool start = s == t - 1;
#pragma unroll
          for (int i = 0; i < 8; ++i) qq[i] = start ? rq[i] : qq[i] * x[i];
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            a0 = fmaf(qq[i], kk[i], a0);
            a1 = fmaf(qq[i + 1], kk[i + 1], a1);
          }
          res[s] = a0 + a1;
          res[s] += __shfl_xor_sync(0xffffffffu, res[s], 1);
        }
        if (h == 0) {
          Group& gr = sm.grp[slot][q][c];
          gr.ap[at(t, t)] = dg;
#pragma unroll
          for (int s = 0; s < kC - 1; ++s)
            if (s < t) gr.ap[at(t, s)] = res[s];
        }
      }
      role_sync(2);     // the stage is staged here; its TMA slot is read
      if (pt_id == 0) {
        // this CTA's group to the others, by the bulk-copy engine (the
        // async proxy reads what the threads wrote: a proxy fence first);
        // the slot's barrier here counts the other groups' bytes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(smem_u32(&sm.full[slot]), (NQ - 1) * kGroupBytes);
        for (int r = 1; r < NQ; ++r) {
          const int to = (q + r) % NQ;
          copy_to(smem_u32(&sm.grp[slot][q][0]), kGroupBytes,
                  smem_u32(&sm.full[slot]), to);
        }
        if (n + kRing < n_stages) issue(n + kRing);
      }
    }
  } else if (warp == 8) {
    // ------------------------------------------------------------------ y --
    // each stage's y from the product warps' shares, added in the order w =
    // 0, 1, ...; item e = (chunk, step tt, column pair cp)
    const long long ystep = static_cast<long long>(heads) * HD;
    const long long ybase =
        (static_cast<long long>(batch) * t_len * heads + head) * HD + q * kG;
    for (int n = 0; n < n_stages; ++n) {
      mbar_wait(smem_u32(&sm.y_full[n & 1]), (n >> 1) & 1);
      // the products are done with the stage's slot: tell every CTA's
      // staging (here, off the product warps' path)
      if (lane < NQ) mbar_arrive_at(smem_u32(&sm.empty[n % kSlots]), lane);
#pragma unroll
      for (int m = 0; m < kPer * kC * kG / 2 / 32; ++m) {
        const int e = lane + 32 * m;
        const int c = e / (kC * kG / 2), tt = (e >> 3) % kC, cp = e & 7;
        const int ts = n * kS + kC * c + tt;
        if (ts < t_len) {
          const float(*yp)[kG * kC] = sm.yp[n & 1][c];
          float y0 = yp[0][at(2 * cp, tt)], y1 = yp[0][at(2 * cp + 1, tt)];
#pragma unroll
          for (int w = 1; w < NQ; ++w) {
            y0 += yp[w][at(2 * cp, tt)];
            y1 += yp[w][at(2 * cp + 1, tt)];
          }
          *reinterpret_cast<float2*>(&y[ybase + ts * ystep + 2 * cp]) =
              make_float2(y0, y1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&sm.y_empty[n & 1]));
    }
  } else {
    // ----------------------------------------------------------- products --
    const int g = lane >> 2;     // the fragments' row group
    const int c4 = lane & 3;     // and thread within it
    // this lane's places in the tiles (at() worked out once): element
    // (8i + g, 8j + 2 c4) of rt, ap, yp at rg[j] + 128 i; (8j + 2 c4, 8i + g)
    // of kt at kg[i] + 128 j
    const int rg[2] = {16 * g + 2 * c4 + (g & 2) * 4,
                       16 * g + 2 * c4 + 8 - (g & 2) * 4};
    const int kg[2] = {32 * c4 + g + (c4 & 1) * 8,
                       32 * c4 + g + 8 - (c4 & 1) * 8};
    for (int n = 0; n < n_stages; ++n) {
      const int slot = n % kSlots;
      mbar_wait(smem_u32(&sm.full[slot]), (n / kSlots) & 1);
      if (warp < NQ) {
        // this warp's share of yᵀ in each chunk, stored after both chunks'
        // products so that no store stands between the chunks' loads
        float yo[kPer][2][4];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const Group& src = sm.grp[slot][warp][c];
          float2 rtf[2][2], ktf[2][2], dd[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              rtf[i][j] = *reinterpret_cast<const float2*>(
                  &src.rt[rg[j] + 128 * i]);
              ktf[i][j] = make_float2(src.kt[kg[i] + 128 * j],
                                      src.kt[kg[i] + 128 * j + 16]);
            }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            dd[j] = *reinterpret_cast<const float2*>(&src.d[8 * j + 2 * c4]);
          uint32_t vh[2][4], vl[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            to_u32(sm.vf[slot][c][h][lane], vh[h]);
            if constexpr (!kExactV) to_u32(sm.vf[slot][c][2 + h][lane], vl[h]);
          }
          // yᵀ's share: Sᵀ r̃ᵀ over dk group w, k-step j (dk 8j..8j+7; slot
          // c4 dk 8j + 2 c4, slot c4 + 4 dk 8j + 2 c4 + 1, so that the
          // accumulator's (c0, c2, c1, c3) are the operand's (a0..a3)), one
          // accumulator a (step tile, k-step)
          float ya[2][2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t ah[4], al[4];
            split_tf32(sacc[j][0], ah[0], al[0]);
            split_tf32(sacc[j][2], ah[1], al[1]);
            split_tf32(sacc[j][1], ah[2], al[2]);
            split_tf32(sacc[j][3], ah[3], al[3]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(rtf[i][j].x, bh0, bl0);
              split_tf32(rtf[i][j].y, bh1, bl1);
#pragma unroll
              for (int e = 0; e < 4; ++e) ya[i][j][e] = 0.0f;
              mma_tf32(ya[i][j], al, bh0, bh1);
              mma_tf32(ya[i][j], ah, bl0, bl1);
              mma_tf32(ya[i][j], ah, bh0, bh1);
            }
          }
          // + Vᵀ Aᵀ for the (step tile i, step half h) pairs x = 2i + h this
          // warp takes (x % NQ == w); A is the groups' shares added in
          // group order
          float va[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) va[i][e] = 0.0f;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (x % NQ != warp) continue;
            const int i = x >> 1, h = x & 1;
            float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
            for (int r = 0; r < NQ; ++r) {
              const float2 f = *reinterpret_cast<const float2*>(
                  &sm.grp[slot][r][c].ap[rg[h] + 128 * i]);
              a0 = r == 0 ? f.x : a0 + f.x;
              a1 = r == 0 ? f.y : a1 + f.y;
            }
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(a0, bh0, bl0);
            split_tf32(a1, bh1, bl1);
            if constexpr (!kExactV) mma_tf32(va[i], vl[h], bh0, bh1);
            mma_tf32(va[i], vh[h], bl0, bl1);
            mma_tf32(va[i], vh[h], bh0, bh1);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              yo[c][i][e] = (ya[i][0][e] + ya[i][1][e]) + va[i][e];
          // Uᵀ = Vᵀ K̂ over dk group w (n-tile j: dk 8j + g), one
          // accumulator a (n-tile, step half); then S ← D ⊙ S + U
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float ua[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(ktf[j][h].x, bh0, bl0);
              split_tf32(ktf[j][h].y, bh1, bl1);
#pragma unroll
              for (int e = 0; e < 4; ++e) ua[h][e] = 0.0f;
              if constexpr (!kExactV) mma_tf32(ua[h], vl[h], bh0, bh1);
              mma_tf32(ua[h], vh[h], bl0, bl1);
              mma_tf32(ua[h], vh[h], bh0, bh1);
            }
            sacc[j][0] = fmaf(dd[j].x, sacc[j][0], ua[0][0] + ua[1][0]);
            sacc[j][1] = fmaf(dd[j].y, sacc[j][1], ua[0][1] + ua[1][1]);
            sacc[j][2] = fmaf(dd[j].x, sacc[j][2], ua[0][2] + ua[1][2]);
            sacc[j][3] = fmaf(dd[j].y, sacc[j][3], ua[0][3] + ua[1][3]);
          }
        }
        // the y warp is done with these shares' last stage
        mbar_wait(smem_u32(&sm.y_empty[n & 1]), ((n >> 1) & 1) ^ 1);
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          float* yp = sm.yp[n & 1][c][warp];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            *reinterpret_cast<float2*>(&yp[rg[i]]) =
                make_float2(yo[c][i][0], yo[c][i][1]);
            *reinterpret_cast<float2*>(&yp[rg[i] + 128]) =
                make_float2(yo[c][i][2], yo[c][i][3]);
          }
        }
      }
      role_sync(1);     // every warp's products of the stage are done
      if (tid == 0) mbar_arrive(smem_u32(&sm.y_full[n & 1]));
    }
  }
  // every CTA past its last stage: no access to this CTA's shared memory
  // is left
  cluster_arrive();
  cluster_wait();
  if (warp < NQ) {
    const int g = lane >> 2, c4 = lane & 3;
    float* out = s_out + static_cast<long long>(bh) * HD * HD + q * kG;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + 8 * j + 2 * c4 + (e & 1);
        out[static_cast<long long>(i) * HD + g + 8 * (e >> 1)] = sacc[j][e];
      }
  }
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(Smem<T, HD / kG>);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* y, void* s_out, int batch, int t, int heads,
           cudaStream_t stream) {
  constexpr int NQ = HD / kG;
  CUtensorMap mr, mk, mv, mw;
  const CUtensorMapDataType ty = tma_type<T>();
  const int es = static_cast<int>(sizeof(T));
  int err = encode_rows(&mr, r, ty, es, batch, t, heads, HD, kG, kS);
  if (err == 0)
    err = encode_rows(&mk, k, ty, es, batch, t, heads, HD, kG, kS);
  if (err == 0)
    err = encode_rows(&mv, v, ty, es, batch, t, heads, HD, kG, kS);
  if (err == 0)
    err = encode_rows(&mw, logw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, batch, t,
                      heads, HD, kG, kS);
  if (err != 0) return err;
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t cerr = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  cerr = cudaLaunchKernelEx(&cfg, wkv_kernel<T, HD>, mr, mk, mv, mw,
                            static_cast<const float*>(u),
                            static_cast<float*>(y),
                            static_cast<float*>(s_out), t, heads);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v: contiguous (batch, t, heads, hd) float32 (bf16 = 0) or bf16
// (bf16 = 1); logw of that shape and u (heads, hd), float32; y (batch, t,
// heads, hd) and s_out (batch, heads, hd, hd) float32. hd is 16 or 64; r,
// k, v and logw start on 16 bytes (TMA). Writes nothing when t is 0 (the
// wrapper zeroes s_out). Returns 0, the cudaError_t of the launch, or
// kEncodeError plus the CUresult of a failed tensor-map encoding.
int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, void* y, void* s_out,
                     int batch, int t, int heads, int hd, int bf16,
                     void* stream) {
  if (hd != 16 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || t == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(r, k, v, logw, u, y, s_out,
                                            batch, t, heads, st)
                : launch<float, 64>(r, k, v, logw, u, y, s_out, batch, t,
                                    heads, st);
  }
  return bf16 ? launch<__nv_bfloat16, 16>(r, k, v, logw, u, y, s_out, batch,
                                          t, heads, st)
              : launch<float, 16>(r, k, v, logw, u, y, s_out, batch, t,
                                  heads, st);
}

// The dynamic shared memory a CTA takes at head size hd, in bytes.
int rwkv6_wkv_smem_bytes(int hd, int bf16) {
  if (hd == 16)
    return static_cast<int>(bf16 ? smem_bytes<__nv_bfloat16, 16>()
                                 : smem_bytes<float, 16>());
  return static_cast<int>(bf16 ? smem_bytes<__nv_bfloat16, 64>()
                               : smem_bytes<float, 64>());
}

const char* kernel_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                   "= code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
