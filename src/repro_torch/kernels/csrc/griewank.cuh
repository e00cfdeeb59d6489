// Griewank's per-coordinate term planes and its relaxed combine, shared by
// the two kernels of this directory.
//
// Every float32 operation is the one the plain PyTorch version performs, in
// the same order. Each multiply that feeds an add is written with
// __fmul_rn/__fadd_rn/__fsub_rn: nvcc contracts a*b+c into one FMA by
// default (-fmad=true), which rounds once where the plain version rounds
// twice and would move a candidate or a probe by an ulp. Constants are hex
// literals of the float32 values the plain version rounds its Python
// constants to.
#pragma once

#include <cuda_runtime.h>

#define REPRO_LANES 128  // packed aggregates: [S, L, K] in lanes 0..2, zeros after

// max/min that propagate NaN, as torch.clamp and jnp.maximum/minimum do.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : fminf(a, b);
}

// Terms of coordinate x with rs = rsqrt(i + 1):
//   s = x*x/4000, l = log|cos(x*rs)|, k = 1{cos(x*rs) < 0}.
// l is ½·log1p(−sin²u) where sin²u < 0.5, else log(max(|cos u|, 1e-38)).
__device__ __forceinline__ void griewank_planes(float x, float rs, float* s,
                                                float* l, float* k) {
  const float u = __fmul_rn(x, rs);
  const float c = cosf(u);
  const float sn = sinf(u);
  const float s2 = __fmul_rn(sn, sn);
  if (s2 < 0.5f) {
    *l = __fmul_rn(0.5f, log1pf(-min_nan(s2, 0x1.ffffdep-1f)));  // 0.999999
  } else {
    *l = logf(max_nan(fabsf(c), 0x1.b38fb8p-127f));               // 1e-38
  }
  *s = __fmul_rn(__fmul_rn(x, x), 0x1.0624dep-12f);                // 1/4000
  *k = (c < 0.0f) ? 1.0f : 0.0f;
}

// f_λ = S − λ·(−1)^K·exp(L) + λ, with expm1 on the positive-sign branch.
// The parity test is floor-mod (jnp.mod, torch.remainder): C's fmodf would
// keep the sign of k.
__device__ __forceinline__ float griewank_combine(float s, float l, float k,
                                                  float lam) {
  const float r = k - 2.0f * floorf(k * 0.5f);
  if (r < 0.5f) return __fsub_rn(s, __fmul_rn(lam, expm1f(l)));
  return __fadd_rn(s, __fmul_rn(lam, __fadd_rn(expf(l), 1.0f)));
}
