// K1: one whole ABO pass of Griewank over an (n_blocks, block) solution.
//
// Replaces the TPU kernel src/repro/kernels/coord_sweep/kernel.py
// (sweep_pass_kernel, body _sweep_kernel, helpers _griewank_planes and
// _combine). On the TPU the grid runs the blocks in order ("arbitrary") and
// carries [S, L, K] in SMEM from one grid step to the next: Gauss-Seidel
// across blocks, Jacobi within a block.
//
// Hopper's CTAs run in no order, so one CTA per block would be Jacobi
// across blocks: other math. This first version is ONE CTA that loops over
// the blocks in order, with [S, L, K] in registers (every thread holds the
// same copy and updates it identically). Within a block each thread owns
// whole coordinates (i = tid, tid + kThreads, ...) and loops over the m
// candidates with its own running argmin: the first NaN wins, else the
// first strict minimum, as jnp.argmin. The three selected deltas are summed
// per thread in coordinate order and then through a shared-memory tree of
// fixed shape (no atomics: the same bits on every run). Every thread takes
// the same guarded-commit decision and writes its coordinates of x IN PLACE.
// The candidate x values wait in shared memory (block floats) until then.
//
// Candidate offsets are j * (2 / (m - 2)) - 1, the kernel's own formula
// (not the plain tensor path's linspace); the incumbent is column m - 1 and
// padding coordinates (index >= n_valid) keep x.
//
// Bound on an H100: operations, not bytes. A pass reads and writes x once
// (8 bytes a coordinate) but probes every coordinate m times, each probe a
// sin/cos pair, a log1p or log and an expm1 or exp. One CTA uses 1 of the
// 132 SMs, so this version sits far below the whole-card bound; filling the
// card needs a decomposition across CTAs that keeps the math (span_coords,
// Jacobi across shards), which is later work.
#include <cuda_runtime.h>

#include "griewank.cuh"

namespace {

constexpr int kThreads = 1024;

// jnp.argmin's rule for a running minimum: a NaN, once taken, stays; a NaN
// is taken over any number; otherwise only a strictly smaller value.
__device__ __forceinline__ bool argmin_takes(float f, float best) {
  return !(best != best) && ((f != f) || f < best);
}

__global__ void __launch_bounds__(kThreads)
sweep_pass_kernel(float* __restrict__ x, long long n_blocks, int block, int m,
                  long long n_valid, float lower, float upper, float center0,
                  float hw, float step, float lam, int is_first,
                  const float* __restrict__ aggs_in,
                  float* __restrict__ aggs_out) {
  extern __shared__ float x_sel[];  // block floats
  __shared__ float red[3][kThreads];
  const int tid = threadIdx.x;
  float s0 = aggs_in[0], l0 = aggs_in[1], k0 = aggs_in[2];

  for (long long b = 0; b < n_blocks; ++b) {
    float* xb = x + b * block;
    float acc_s = 0.0f, acc_l = 0.0f, acc_k = 0.0f;
    for (int i = tid; i < block; i += kThreads) {
      const long long gi = b * block + i;
      const float xv = xb[i];
      const bool valid = gi < n_valid;
      const float rs = rsqrtf(static_cast<float>(gi + 1));
      float so, lo, ko;
      griewank_planes(xv, rs, &so, &lo, &ko);
      const float center = is_first ? center0 : xv;
      float best_f = 0.0f, best_x = xv, best_s = 0.0f, best_l = 0.0f,
            best_k = 0.0f;
      for (int j = 0; j < m; ++j) {
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
        if (j == 0 || argmin_takes(f, best_f)) {
          best_f = f;
          best_x = c;
          best_s = ds;
          best_l = dl;
          best_k = dk;
        }
      }
      x_sel[i] = best_x;
      acc_s = __fadd_rn(acc_s, best_s);
      acc_l = __fadd_rn(acc_l, best_l);
      acc_k = __fadd_rn(acc_k, best_k);
    }
    red[0][tid] = acc_s;
    red[1][tid] = acc_l;
    red[2][tid] = acc_k;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) {
        red[0][tid] = __fadd_rn(red[0][tid], red[0][tid + w]);
        red[1][tid] = __fadd_rn(red[1][tid], red[1][tid + w]);
        red[2][tid] = __fadd_rn(red[2][tid], red[2][tid + w]);
      }
      __syncthreads();
    }
    const float s1 = __fadd_rn(s0, red[0][0]);
    const float l1 = __fadd_rn(l0, red[1][0]);
    const float k1 = __fadd_rn(k0, red[2][0]);
    const bool accept = griewank_combine(s1, l1, k1, lam) <=
                        griewank_combine(s0, l0, k0, lam);
    if (accept) {
      for (int i = tid; i < block; i += kThreads) xb[i] = x_sel[i];
      s0 = s1;
      l0 = l1;
      k0 = k1;
    }
    __syncthreads();  // red[*][0] is read by all before the next block's writes
  }
  for (int i = tid; i < REPRO_LANES; i += kThreads) {
    aggs_out[i] = i == 0 ? s0 : i == 1 ? l0 : i == 2 ? k0 : 0.0f;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). x is updated in
// place; aggs_in holds [S, L, K] in its first three floats; aggs_out holds
// REPRO_LANES floats. One CTA of kThreads threads, block * 4 bytes of
// dynamic shared memory.
int sweep_pass_launch(float* x, long long n_blocks, int block, int m,
                      long long n_valid, float lower, float upper,
                      float center0, float hw, float step, float lam,
                      int is_first, const float* aggs_in, float* aggs_out,
                      void* stream) {
  const size_t smem = static_cast<size_t>(block) * sizeof(float);
  const size_t static_smem = 3 * kThreads * sizeof(float);  // red
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_pass_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n_blocks, block, m, n_valid, lower, upper, center0, hw, step, lam,
      is_first, aggs_in, aggs_out);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
