// P: ABO-ZO's perturbation, dst = (src.f32 + scale · u).astype(dtype) with
// u = ±1 regenerated from threefry-2x32, bit for bit the reference's
// jax.random.rademacher draw. Port only: the TPU package has no kernel for
// it (src/repro/train/abo_zo.py::_perturb is jnp under jit); this is its
// fused elementwise pass on the training path
// (kernels/perturb/ops.py::abo_zo_perturb).
//
// What it computes, for element j of a tensor that is the slice of a
// reference leaf starting at flat offset `offset` (a stacked group leaf's
// layer g starts at g times one layer's numel): with c = offset + j and
// (x0, x1) = threefry2x32(leaf key, (c >> 32, c mod 2^32)), u = +1 where bit
// 31 of x0 ^ x1 is 0, else -1 (jax.random.bernoulli(p = 0.5) is
// uniform < 0.5, the top mantissa bit; rademacher is 2b - 1); then
// src + u · scale in float32, rounded once to dst's dtype (bf16 round to
// nearest even). u · scale is exact, so the product and sum cannot round
// twice. dst may be src (in place).
//
// Design: CUDA rather than Triton, because the port's other kernels are
// built the same way (one nvcc per source, a plain C interface), and a
// Triton kernel would add a JIT compile at first use to the training
// step. A grid-stride loop, one element a thread an iteration; the
// threefry rounds are uint32 adds, funnel-shift rotations and xors in
// registers.
//
// Bound on an H100 over the whole bf16 mistral-nemo-12b (1.22e10
// parameters): 4 bytes an element (read 2, write 2), 49 GB, 14.6 ms at
// 3.35 TB/s, against threefry's 20 rounds of add, rotate and xor plus the
// key schedule, ~80 integer operations an element at 64 a clock on each of
// 132 SMs: ~59 ms at 1.98 GHz. Integer issue bounds it; chip_smoke prints
// the count (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define REPRO_ROUND(r)  \
  x0 += x1;             \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32 with 20 rounds (Salmon et al. 2011), as jax.random's.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  REPRO_ROUND(13) REPRO_ROUND(15) REPRO_ROUND(26) REPRO_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  REPRO_ROUND(17) REPRO_ROUND(29) REPRO_ROUND(16) REPRO_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  REPRO_ROUND(13) REPRO_ROUND(15) REPRO_ROUND(26) REPRO_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  REPRO_ROUND(17) REPRO_ROUND(29) REPRO_ROUND(16) REPRO_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  REPRO_ROUND(13) REPRO_ROUND(15) REPRO_ROUND(26) REPRO_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef REPRO_ROUND

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
abo_zo_perturb(const T* src, T* dst, long long n, uint32_t k0, uint32_t k1,
               unsigned long long offset, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n; j += stride) {
    const unsigned long long c = offset + static_cast<unsigned long long>(j);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry(k0, k1, x0, x1);
    const float step = ((x0 ^ x1) >> 31) ? -scale : scale;
    store_f(dst + j, __fadd_rn(load_f(src + j), step));
  }
}

}  // namespace

extern "C" {

// src, dst: n contiguous elements, float32 (dtype 0) or bfloat16 (dtype 1);
// dst may equal src. (k0, k1): the leaf's key; offset: the tensor's first
// element's flat index in the leaf; scale: the float32 step. Returns the
// cudaError_t of the launch (0 on success); the wrapper checks the rest.
int abo_zo_perturb_launch(const void* src, void* dst, int dtype, long long n,
                          unsigned k0, unsigned k1, unsigned long long offset,
                          float scale, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    abo_zo_perturb<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), n, k0, k1,
        offset, scale);
  } else {
    abo_zo_perturb<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<__nv_bfloat16*>(dst), n, k0, k1, offset, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
