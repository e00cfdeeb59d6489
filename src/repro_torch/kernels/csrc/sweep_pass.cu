// K1: one whole ABO pass of Griewank over an (n_blocks, block) solution,
// each block worked by a thread-block cluster of C CTAs.
//
// Replaces the TPU kernel src/repro/kernels/coord_sweep/kernel.py
// (sweep_pass_kernel, body _sweep_kernel, helpers _griewank_planes and
// _combine). On the TPU the grid runs the blocks in order ("arbitrary") and
// carries [S, L, K] in SMEM from one grid step to the next: Gauss-Seidel
// across blocks, Jacobi within a block.
//
// Hopper's CTAs run in no order, so one CTA per block would be Jacobi
// across blocks: other math. Instead ONE cluster of C CTAs (C = 16, the
// non-portable cluster size, by default) walks the blocks in order; every
// thread of every CTA holds the same [S, L, K] in registers and takes the
// same guarded-commit decision. Only the blocks depend on each other: the
// probes of one block depend only on the block's entry aggregates, so they
// are spread over the C SMs.
//
// The bits are those of a single CTA of 1024 threads (C = 1, the first
// version of this kernel), at every C:
//   * The 1024 "virtual threads" t of that CTA each own coordinates
//     t, t + 1024, ... of the block and sum their three selected deltas in
//     that order; a shared-memory tree then folds the 1024 partials with
//     w = 512 ... 1. At every level with w >= C, t and t + w share the
//     residue t mod C, so CTA r owns the virtual threads t = r + C*j and
//     runs levels 512 ... C of that tree locally (a 1024/C-leaf tree). It
//     leaves its partial in its shared memory; after one barrier.cluster
//     every CTA reads the C partials over distributed shared memory and
//     folds them with levels C/2 ... 1, in the same order. The partial
//     slots are double-buffered by block parity, so one cluster barrier a
//     block suffices.
//   * A virtual thread's m candidates are split over C lanes (lane l takes
//     j = l, l + C, ...). jnp.argmin's rule (the first NaN, else the first
//     strict minimum) is exact under any grouping when the lanes merge
//     (value, index) pairs by that rule, and the selected x and deltas
//     follow the chosen index.
//   * The base planes of a coordinate (its current s, l, k) are computed
//     once, by one thread, into shared memory.
// Candidate offsets are j * (2 / (m - 2)) - 1, the kernel's own formula
// (not the plain tensor path's linspace); the incumbent is column m - 1 and
// padding coordinates (index >= n_valid) keep x. No atomics, no contracted
// FMAs (griewank.cuh), float32 aggregates. Each CTA writes only its own
// coordinates of x, in place; CTA 0 writes aggs_out. While block b is
// probed, cp.async brings the CTA's coordinates of block b + 1 (block b
// never writes them).
//
// Bound on an H100: operations, not bytes. A pass reads and writes x once
// (8 bytes a coordinate) but probes every coordinate m times, each probe a
// sin/cos pair, a log1p or log and an expm1 or exp. One cluster uses C of
// the 132 SMs; the pace is then the probes of one block on C SMs plus the
// cluster barrier and fold per block.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "griewank.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kVirt = 1024;     // virtual threads of the fixed-shape sum
constexpr int kThreads = 1024;  // real threads a CTA

// jnp.argmin's rule for a running minimum: a NaN, once taken, stays; a NaN
// is taken over any number; otherwise only a strictly smaller value.
__device__ __forceinline__ bool argmin_takes(float f, float best) {
  return !(best != best) && ((f != f) || f < best);
}

// Whether candidate (fo, jo) precedes (f, j) under jnp.argmin's rule: NaNs
// first, then smaller values, ties to the lower index. A strict total order
// on distinct indices, so merging by it is associative and commutative.
__device__ __forceinline__ bool argmin_precedes(float fo, int jo, float f,
                                                int j) {
  const bool nan = f != f, nano = fo != fo;
  if (nan) return nano && jo < j;
  return nano || fo < f || (fo == f && jo < j);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
sweep_pass_kernel(float* __restrict__ x, long long n_blocks, int block, int m,
                  long long n_valid, float lower, float upper, float center0,
                  float hw, float step, float lam, int is_first,
                  const float* __restrict__ aggs_in,
                  float* __restrict__ aggs_out) {
  constexpr int kL = C;          // lanes a virtual thread
  constexpr int kV = kVirt / C;  // virtual threads a CTA
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[3][kV];
  __shared__ float part[2][3];   // this CTA's partial, by block parity
  __shared__ float total[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, vj = tid / kL, lane = tid % kL;
  // Local slot s = k * kV + j holds coordinate k * 1024 + r + C * j of the
  // block: virtual thread j's k-th coordinate.
  const int n_k = (block + kVirt - 1) / kVirt;
  const int n_slot = n_k * kV;
  float* xbuf = smem;                 // [2][n_slot]: x, then the selection
  float* so_s = smem + 2 * n_slot;    // base planes, [n_slot] each
  float* lo_s = so_s + n_slot;
  float* ko_s = lo_s + n_slot;
  auto coord = [&](int s) { return (s / kV) * kVirt + r + C * (s % kV); };
  auto prefetch = [&](long long b, float* dst) {
    const float* xb = x + b * block;
    for (int s = tid; s < n_slot; s += kThreads) {
      const int i = coord(s);
      if (i < block) cp_async4(dst + s, xb + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float s0 = aggs_in[0], l0 = aggs_in[1], k0 = aggs_in[2];
  prefetch(0, xbuf);
  for (long long b = 0; b < n_blocks; ++b) {
    const int cur = static_cast<int>(b & 1);
    float* xs = xbuf + cur * n_slot;
    const long long base = b * block;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // block b's x has landed; block b - 1 is committed
    if (b + 1 < n_blocks) prefetch(b + 1, xbuf + (cur ^ 1) * n_slot);

    for (int s = tid; s < n_slot; s += kThreads) {
      const int i = coord(s);
      if (i < block) {
        const float rs = rsqrtf(static_cast<float>(base + i + 1));
        griewank_planes(xs[s], rs, so_s + s, lo_s + s, ko_s + s);
      }
    }
    __syncthreads();

    float acc_s = 0.0f, acc_l = 0.0f, acc_k = 0.0f;
    for (int kk = 0; kk < n_k; ++kk) {
      const int s = kk * kV + vj;
      const int i = kk * kVirt + r + C * vj;
      const bool has = i < block;   // the same for all lanes of vj
      const long long gi = base + i;
      const bool valid = gi < n_valid;
      const float xv = has ? xs[s] : 0.0f;
      const float so = has ? so_s[s] : 0.0f, lo = has ? lo_s[s] : 0.0f,
                  ko = has ? ko_s[s] : 0.0f;
      const float rs = rsqrtf(static_cast<float>(gi + 1));
      const float center = is_first ? center0 : xv;
      float best_f = 0.0f, best_x = xv, best_s = 0.0f, best_l = 0.0f,
            best_k = 0.0f;
      int best_j = INT_MAX;   // no candidate yet
      for (int j = lane; j < (has ? m : 0); j += kL) {
        float c = xv;
        if (valid && j != m - 1) {
          const float offs =
              __fsub_rn(__fmul_rn(static_cast<float>(j), step), 1.0f);
          c = min_nan(max_nan(__fadd_rn(center, __fmul_rn(hw, offs)), lower),
                      upper);
        }
        float sn, ln, kn;
        griewank_planes(c, rs, &sn, &ln, &kn);
        const float ds = __fsub_rn(sn, so);
        const float dl = __fsub_rn(ln, lo);
        const float dk = __fsub_rn(kn, ko);
        const float f = griewank_combine(__fadd_rn(s0, ds), __fadd_rn(l0, dl),
                                         __fadd_rn(k0, dk), lam);
        if (best_j == INT_MAX || argmin_takes(f, best_f)) {
          best_f = f;
          best_j = j;
          best_x = c;
          best_s = ds;
          best_l = dl;
          best_k = dk;
        }
      }
#pragma unroll
      for (int o = kL / 2; o > 0; o >>= 1) {
        const float of = __shfl_xor_sync(0xffffffffu, best_f, o, kL);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j, o, kL);
        const float ox = __shfl_xor_sync(0xffffffffu, best_x, o, kL);
        const float os = __shfl_xor_sync(0xffffffffu, best_s, o, kL);
        const float ol = __shfl_xor_sync(0xffffffffu, best_l, o, kL);
        const float ok = __shfl_xor_sync(0xffffffffu, best_k, o, kL);
        if (oj != INT_MAX &&
            (best_j == INT_MAX || argmin_precedes(of, oj, best_f, best_j))) {
          best_f = of;
          best_j = oj;
          best_x = ox;
          best_s = os;
          best_l = ol;
          best_k = ok;
        }
      }
      if (has) {
        if (lane == 0) xs[s] = best_x;   // every lane has read xs[s]
        acc_s = __fadd_rn(acc_s, best_s);
        acc_l = __fadd_rn(acc_l, best_l);
        acc_k = __fadd_rn(acc_k, best_k);
      }
    }
    if (lane == 0) {
      red[0][vj] = acc_s;
      red[1][vj] = acc_l;
      red[2][vj] = acc_k;
    }
    __syncthreads();
    for (int w = kV / 2; w > 0; w >>= 1) {   // levels 512/C*C ... C
      if (tid < w) {
        red[0][tid] = __fadd_rn(red[0][tid], red[0][tid + w]);
        red[1][tid] = __fadd_rn(red[1][tid], red[1][tid + w]);
        red[2][tid] = __fadd_rn(red[2][tid], red[2][tid + w]);
      }
      __syncthreads();
    }
    if (tid < 3) part[cur][tid] = red[tid][0];
    cluster.sync();    // every CTA's partial of block b is in place
    if (tid < 32) {    // levels C/2 ... 1 over the C partials
      float ps = 0.0f, pl = 0.0f, pk = 0.0f;
      if (tid < C) {
        const float* rp = cluster.map_shared_rank(&part[cur][0], tid);
        ps = rp[0];
        pl = rp[1];
        pk = rp[2];
      }
#pragma unroll
      for (int w = C / 2; w > 0; w >>= 1) {
        ps = __fadd_rn(ps, __shfl_down_sync(0xffffffffu, ps, w));
        pl = __fadd_rn(pl, __shfl_down_sync(0xffffffffu, pl, w));
        pk = __fadd_rn(pk, __shfl_down_sync(0xffffffffu, pk, w));
      }
      if (tid == 0) {
        total[0] = ps;
        total[1] = pl;
        total[2] = pk;
      }
    }
    __syncthreads();
    const float s1 = __fadd_rn(s0, total[0]);
    const float l1 = __fadd_rn(l0, total[1]);
    const float k1 = __fadd_rn(k0, total[2]);
    const bool accept = griewank_combine(s1, l1, k1, lam) <=
                        griewank_combine(s0, l0, k0, lam);
    if (accept) {
      for (int s = tid; s < n_slot; s += kThreads) {
        const int i = coord(s);
        if (i < block) x[base + i] = xs[s];
      }
      s0 = s1;
      l0 = l1;
      k0 = k1;
    }
  }
  cluster.sync();      // no CTA leaves while another reads its partials
  if (r == 0) {
    for (int i = tid; i < REPRO_LANES; i += kThreads) {
      aggs_out[i] = i == 0 ? s0 : i == 1 ? l0 : i == 2 ? k0 : 0.0f;
    }
  }
}

size_t dynamic_smem(int block, int c) {
  const size_t n_slot = static_cast<size_t>((block + kVirt - 1) / kVirt) *
                        (kVirt / c);
  return 5 * n_slot * sizeof(float);
}

template <int C>
cudaError_t configure(int block, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, cudaStream_t stream) {
  const size_t smem = dynamic_smem(block, C);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_pass_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(sweep_pass_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int C>
int launch(float* x, long long n_blocks, int block, int m, long long n_valid,
           float lower, float upper, float center0, float hw, float step,
           float lam, int is_first, const float* aggs_in, float* aggs_out,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<C>(block, &cfg, &attr, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, sweep_pass_kernel<C>, x, n_blocks, block, m,
                           n_valid, lower, upper, center0, hw, step, lam,
                           is_first, aggs_in, aggs_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int max_clusters(int block, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<C>(block, &cfg, &attr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, sweep_pass_kernel<C>, &cfg));
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). x is updated in
// place; aggs_in holds [S, L, K] in its first three floats; aggs_out holds
// REPRO_LANES floats. One cluster of `cluster` CTAs (1, 2, 4, 8 or 16) of
// 1024 threads, 20 bytes of dynamic shared memory a coordinate slot each
// (coord_sweep/ops.py::smem_bytes checks the total).
int sweep_pass_launch(float* x, long long n_blocks, int block, int m,
                      long long n_valid, float lower, float upper,
                      float center0, float hw, float step, float lam,
                      int is_first, const float* aggs_in, float* aggs_out,
                      int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SWEEP_LAUNCH(C)                                                \
  case C:                                                                    \
    return launch<C>(x, n_blocks, block, m, n_valid, lower, upper, center0, \
                     hw, step, lam, is_first, aggs_in, aggs_out, s);
  switch (cluster) {
    REPRO_SWEEP_LAUNCH(1)
    REPRO_SWEEP_LAUNCH(2)
    REPRO_SWEEP_LAUNCH(4)
    REPRO_SWEEP_LAUNCH(8)
    REPRO_SWEEP_LAUNCH(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SWEEP_LAUNCH
}

// How many clusters of `cluster` CTAs the card can hold at once
// (cudaOccupancyMaxActiveClusters) for this block size, into *out.
int sweep_pass_max_active_clusters(int block, int cluster, int* out) {
  switch (cluster) {
    case 1: return max_clusters<1>(block, out);
    case 2: return max_clusters<2>(block, out);
    case 4: return max_clusters<4>(block, out);
    case 8: return max_clusters<8>(block, out);
    case 16: return max_clusters<16>(block, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
