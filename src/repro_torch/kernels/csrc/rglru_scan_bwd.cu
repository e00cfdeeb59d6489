// S-bwd: the gradient of S (rglru_scan.cu), the RG-LRU's gates and
// recurrence, for training recurrentgemma's recurrent layers.
//
// Port only: no Pallas kernel stands behind it. The JAX package's gradient
// is autodiff of _gates and jax.lax.associative_scan
// (src/repro/models/rglru.py:37-46, :74); this stands for that autodiff on
// the training path (kernels/rglru_scan/ops.py::rglru_lru_bwd). Its plain
// version is kernels/rglru_scan/ref.py::rglru_lru_bwd_ref.
//
// What it computes, per (batch, channel), from u, xi, xr (the model's type
// T), dh (T), the optional dlast (float32, the last h's gradient), nsp =
// -C · softplus(Λ) and Λ (float32), every step in float32:
//   i = T(σ(xi)), r = T(σ(xr)), a = exp(nsp · r), x = 1 - a²,
//   s = √max(x, 1e-12), g = s · i · u, h_t = a_t · h_{t-1} + g_t;
//   dH_t = dh_t + a_{t+1} · dH_{t+1}, dH_{T-1} = dh_{T-1} + dlast;
//   da = dH · h_{t-1} - 2a · dx, dx = dH · i · u · 0.5 / s · c, where c
//     is 1 above the clamp, 0 below it and 0.5 at it (JAX's rule for
//     maximum: a tie splits the gradient);
//   dxr = da · a · nsp · r(1 - r), dxi = dH · s · u · i(1 - i),
//   du = dH · s · i, all rounded to T;
//   dΛ = -C · σ(Λ) · Σ_{batch} Σ_T da · a · r, float32 (channels,).
// h_{t-1} is recomputed in float32 here, never read back from the forward's
// output (which is rounded to T).
//
// Design. A CTA owns one batch row and a strip of 4 channels (one of the
// first 4 lanes of warp 0 each), so that recurrentgemma-2b's 2560 channels
// give 640 CTAs, ~5 an SM, whose serial chains overlap; T goes in tiles of
// kRows steps. Two sweeps over T:
//   * forward: the 8 warps compute the tile's (a, g) into shared memory,
//     a thread an element (kRows x 4 = 256); warp 0 steps h over the tile
//     and first writes the h the tile starts from into a float32
//     checkpoint in device memory ((batch, tiles, d), the wrapper's
//     scratch);
//   * backward, tiles from the last: the warps recompute the tile's gates
//     (kept in registers) and stage dh; warp 0 recomputes h_{t-1} over the
//     tile from its checkpoint, then steps dH backwards, carrying a_{t}·dH_t
//     into the tile before; the warps then form each element's gradients
//     and write them. Each thread's share of Σ da · a · r sums over its
//     steps in a fixed order, then the CTA's 64 in order, into a
//     (batch, d) partial; a second kernel sums the partials over the batch
//     in order and applies -C · σ(Λ). No atomics: two runs give the same
//     bits.
//
// Bound on an H100 at recurrentgemma-2b's (1, 4096, 2560) bf16: bytes. u,
// xi, xr and dh read once and du, dxi, dxr written once (bf16): 146.8 MB,
// 0.0438 ms at 3.35 TB/s. This first version reads u, xi and xr twice (the
// forward sweep and the backward) and runs 640 CTAs, each over all of T in
// order; strips of 32, 16 and 8 channels read 1.165, 0.755 and 0.547 ms
// on an H100 80GB HBM3 at 700 W; PERF.md has its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kC = 8.0f;     // Griffin's recurrence sharpness constant
constexpr int kStrip = 4;      // channels a CTA
constexpr int kRows = 64;      // steps a tile (ops.py BWD_ROWS)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsWarp = 32 / kStrip;              // a warp's rows at once
constexpr int kSlots = kWarps * kRowsWarp;          // threads a channel
constexpr int kPer = kRows / kSlots;   // steps a thread in a tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_t(float x, float) { return x; }
__device__ __forceinline__ float round_t(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// One element's gates, as the forward computes them.
struct Gates {
  float u, i, r, a, x, s;
};

template <typename T>
__device__ __forceinline__ Gates gates(T u, T xi, T xr, float nsp) {
  Gates e;
  e.u = to_f(u);
  e.i = round_t(sigmoid(to_f(xi)), T());
  e.r = round_t(sigmoid(to_f(xr)), T());
  e.a = expf(__fmul_rn(nsp, e.r));
  e.x = __fadd_rn(1.0f, -__fmul_rn(e.a, e.a));
  e.s = __fsqrt_rn(fmaxf(e.x, 1e-12f));
  return e;
}

__device__ __forceinline__ float gated(const Gates& e) {
  return __fmul_rn(__fmul_rn(e.s, e.i), e.u);
}

// Grid (strips, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ u, const T* __restrict__ xi,
                 const T* __restrict__ xr, const float* __restrict__ nsp_g,
                 const T* __restrict__ dh, const float* __restrict__ dlast,
                 float* __restrict__ ckpt, T* __restrict__ du,
                 T* __restrict__ dxi, T* __restrict__ dxr,
                 float* __restrict__ part, int t_len, int d) {
  __shared__ float a_s[kRows][kStrip + 1];
  __shared__ float g_s[kRows][kStrip + 1];    // g, then dh and dH
  __shared__ float hp_s[kRows][kStrip + 1];   // h_{t-1}
  __shared__ float red[kSlots][kStrip];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane % kStrip;                   // the thread's channel
  const int slot = warp * kRowsWarp + lane / kStrip;
  const bool chain = threadIdx.x < kStrip;        // warp 0's first lanes
  const int ch = blockIdx.x * kStrip + cl;
  const bool valid = ch < d;
  const int b = blockIdx.y;
  const long long row0 = static_cast<long long>(b) * t_len;
  const int tiles = (t_len + kRows - 1) / kRows;
  const float nsp = valid ? nsp_g[ch] : 0.0f;
  float* ck = ckpt + static_cast<long long>(b) * tiles * d + ch;

  // ---- forward: each tile's starting h into the checkpoints ----
  float h = 0.0f;
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kRows;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int row = slot + kSlots * j, t = t0 + row;
      float a = 1.0f, g = 0.0f;
      if (valid && t < t_len) {
        const long long at = (row0 + t) * d + ch;
        const Gates e = gates<T>(u[at], xi[at], xr[at], nsp);
        a = e.a;
        g = gated(e);
      }
      a_s[row][cl] = a;
      g_s[row][cl] = g;
    }
    __syncthreads();
    if (chain && valid) {
      ck[static_cast<long long>(k) * d] = h;
      const int rows = min(kRows, t_len - t0);
#pragma unroll 16
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(a_s[r][cl], h), g_s[r][cl]);
      }
    }
    __syncthreads();
  }

  // ---- backward, tiles from the last ----
  float carry = (valid && dlast != nullptr) ? dlast[static_cast<long long>(b)
                                                    * d + ch]
                                            : 0.0f;   // a_{t+1} · dH_{t+1}
  float dnsp = 0.0f;
  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * kRows;
    Gates e[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int row = slot + kSlots * j, t = t0 + row;
      float dhv = 0.0f;
      e[j] = Gates{0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 1.0f};
      if (valid && t < t_len) {
        const long long at = (row0 + t) * d + ch;
        e[j] = gates<T>(u[at], xi[at], xr[at], nsp);
        dhv = to_f(dh[at]);
      }
      a_s[row][cl] = e[j].a;
      hp_s[row][cl] = gated(e[j]);
      g_s[row][cl] = dhv;
    }
    __syncthreads();
    if (chain && valid) {
      const int rows = min(kRows, t_len - t0);
      float hh = ck[static_cast<long long>(k) * d];
#pragma unroll 16
      for (int r = 0; r < rows; ++r) {        // g -> h_{t-1}, in place
        const float g = hp_s[r][cl];
        hp_s[r][cl] = hh;
        hh = __fadd_rn(__fmul_rn(a_s[r][cl], hh), g);
      }
#pragma unroll 16
      for (int r = rows - 1; r >= 0; --r) {   // dh -> dH, in place
        const float dH = __fadd_rn(g_s[r][cl], carry);
        g_s[r][cl] = dH;
        carry = __fmul_rn(a_s[r][cl], dH);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int row = slot + kSlots * j, t = t0 + row;
      if (!valid || t >= t_len) continue;
      const Gates& v = e[j];
      const float dH = g_s[row][cl];
      const float c = v.x > 1e-12f ? 1.0f : (v.x == 1e-12f ? 0.5f : 0.0f);
      const float dx = dH * v.i * v.u * 0.5f / v.s * c;
      const float da = dH * hp_s[row][cl] - 2.0f * v.a * dx;
      const float dloga = da * v.a;
      dnsp += dloga * v.r;
      const long long at = (row0 + t) * d + ch;
      store(dxr + at, dloga * nsp * v.r * (1.0f - v.r));
      store(dxi + at, dH * v.s * v.u * v.i * (1.0f - v.i));
      store(du + at, dH * v.s * v.i);
    }
    __syncthreads();
  }
  red[slot][cl] = dnsp;
  __syncthreads();
  if (chain && valid) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) s += red[w][cl];
    part[static_cast<long long>(b) * d + ch] = s;
  }
}

// dΛ_c = -C · σ(Λ_c) · Σ_b part[b][c], the batch summed in order.
__global__ void rglru_dlam_kernel(const float* __restrict__ part,
                                  const float* __restrict__ lam,
                                  float* __restrict__ dlam, int batch, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.0f;
  for (int b = 0; b < batch; ++b) s += part[static_cast<long long>(b) * d + c];
  dlam[c] = s * -kC * sigmoid(lam[c]);
}

template <typename T>
int launch(const void* u, const void* xi, const void* xr, const void* nsp,
           const void* lam, const void* dh, const void* dlast, void* ckpt,
           void* du, void* dxi, void* dxr, void* part, void* dlam, int batch,
           int t, int d, cudaStream_t stream) {
  const dim3 grid((d + kStrip - 1) / kStrip, batch);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(xi),
      static_cast<const T*>(xr), static_cast<const float*>(nsp),
      static_cast<const T*>(dh), static_cast<const float*>(dlast),
      static_cast<float*>(ckpt), static_cast<T*>(du), static_cast<T*>(dxi),
      static_cast<T*>(dxr), static_cast<float*>(part), t, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_dlam_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(lam),
      static_cast<float*>(dlam), batch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u, xi, xr, dh, du, dxi, dxr: contiguous (batch, t, d) of float32 (bf16 =
// 0) or bf16 (bf16 = 1); nsp and lam (d,) float32 (-C · softplus(Λ) and Λ);
// dlast (batch, d) float32 or null; ckpt (batch, ceil(t / 64), d) and part
// (batch, d) float32 scratch; dlam (d,) float32. Two kernels on the stream:
// the sweeps, then the batch sum into dlam. Returns 0 or the cudaError_t of
// the first launch that failed.
int rglru_scan_bwd_launch(const void* u, const void* xi, const void* xr,
                          const void* nsp, const void* lam, const void* dh,
                          const void* dlast, void* ckpt, void* du, void* dxi,
                          void* dxr, void* part, void* dlam, int batch, int t,
                          int d, int bf16, void* stream) {
  if (batch == 0 || t == 0 || d == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(u, xi, xr, nsp, lam, dh, dlast, ckpt, du,
                                 dxi, dxr, part, dlam, batch, t, d, st);
  }
  return launch<float>(u, xi, xr, nsp, lam, dh, dlast, ckpt, du, dxi, dxr,
                       part, dlam, batch, t, d, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
