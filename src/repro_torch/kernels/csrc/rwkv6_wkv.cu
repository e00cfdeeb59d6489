// W: RWKV6's WKV recurrence, every step of a sequence in one launch.
//
// Port only: no Pallas kernel stands behind it. It stands for the
// jax.lax.scan over T in rwkv6_apply and rwkv6_prefill
// (src/repro/models/rwkv6.py:97-111, :123-137), which eager PyTorch would
// run as a Python loop of some six launches a step.
//
// What it computes, for each batch row and head, from r, k, v (b, T, H, hd)
// of the model's type T, the log-decay logw (b, T, H, hd) float32 and the
// bonus u (H, hd) float32, with a float32 (dk x dv) state S from zero:
//   kv[i][j] = k_t[i] · v_t[j]
//   y_t[j]   = sum over i of r_t[i] · (S[i][j] + u[i] · kv[i][j])
//   S[i][j]  = expf(logw_t[i]) · S[i][j] + kv[i][j]
// y float32 (b, T, H, hd) and the last S float32 (b, H, hd, hd). That is
// the plain version's function (kernels/rwkv6_wkv/ref.py::wkv_ref) in
// another order of the dk sum (a fixed one: see below) and with
// multiply-adds fused, so it is held to it by a tolerance, not bit for bit.
// expf is the accurate library call (no --use_fast_math). No atomics: two
// runs give the same bits.
//
// Design. Column j of S and y_t[j] read only column j, so the columns are
// independent: a CTA owns one (batch, head) and kCols columns, and keeps
// its part of S in registers over all of T. A column's dk sum is split over
// kSplit = hd / R threads, each holding R rows of the column; each sums its
// rows in a fixed order and leaves the partial in shared memory, and after
// the tile the kSplit partials of each (step, column) are added in the
// order of their rows, the same every run. No step waits on another
// thread: the only chain from step to step is each state element's own
// multiply-add. Steps go in tiles of kSteps: each thread loads its share of
// the next tile's r, k, logw (the head's whole rows) and v (the CTA's
// columns) into registers with coalesced loads while the CTA steps through
// the current tile from shared memory, where the tile was staged as
// float32 with the decay's expf taken once a (step, row). A step reads r,
// k and w as 16-byte vectors: the kSplit threads of a column read one
// contiguous run, the columns' threads the same one (a broadcast), so
// there is no bank conflict. y leaves a tile at a time, kCols columns a
// step.
// hd 64 runs R = 8 (kSplit 8, 128 threads, four CTAs a head); hd 16 R = 4
// (kSplit 4, 64 threads, one CTA a head). At rwkv6-3b's (1, 8192, 40, 64)
// that is 160 CTAs of four warps for 132 SMs.
//
// Bound on an H100 at that shape: operations. Five float32 operations an
// element of the state a step (5·H·hd²·T = 6.71e9: y_t regrouped as
// r_tᵀS + (r_t·(u ⊙ k_t))·v_t is one multiply-add an element, the update
// one multiply and one multiply-add) at 67 TFLOP/s take 0.100 ms; the bytes (r, k, v in bf16 and logw read once, y written once
// in float32: 293.6 MB) 0.088 ms at 3.35 TB/s. The state never leaves the
// registers, so the bytes are those; what this simple design pays for is
// instruction throughput: a thread's R products and 3R multiply-adds a
// step, besides its shared-memory reads, on one warp a scheduler. A chunked tensor-core form
// would need ratios of cumulative decays within a chunk, which overflow at
// RWKV6's decays without sub-chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;   // steps a tile
constexpr int kCols = 16;    // columns of S (dv) a CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// One CTA: batch row blockIdx.x / heads, head blockIdx.x % heads, columns
// blockIdx.y · kCols ... + kCols - 1. HD = dk = dv; R rows of a column a
// thread.
template <typename T, int HD, int R>
__global__ void __launch_bounds__(kCols * (HD / R))
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int t_len, int heads) {
  constexpr int kSplit = HD / R;
  constexpr int kThreads = kCols * kSplit;
  constexpr int kQuads = R / 4;
  constexpr int kPerRow = kSteps * HD / kThreads;   // r, k, logw a thread
  constexpr int kPerCol = kSteps * kCols / kThreads;  // v a thread
  static_assert(R % 4 == 0 && HD % R == 0, "layout");
  static_assert(kSteps * HD % kThreads == 0, "tile of rows");
  static_assert(kSteps * kCols % kThreads == 0, "tile of columns");

  __shared__ __align__(16) float sr[kSteps][HD];
  __shared__ __align__(16) float sk[kSteps][HD];
  __shared__ __align__(16) float sw[kSteps][HD];
  __shared__ float sv[kSteps][kCols];
  // each thread's partial of y a step, a column's kSplit side by side with
  // one float of padding (no bank conflict writing by thread or reading
  // by column)
  __shared__ float sp[kSteps][kCols * (kSplit + 1)];

  const int bh = blockIdx.x;
  const int head = bh % heads;
  const int batch = bh / heads;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int g = tid % kSplit;      // which rows of the column
  const int c = tid / kSplit;      // which column of the CTA's

  // Element (batch, t, head, i) lies at base + t · step + i.
  const long long step = static_cast<long long>(heads) * HD;
  const long long base =
      (static_cast<long long>(batch) * t_len * heads + head) * HD;

  // Rows of this thread: quad q holds rows 4 (q · kSplit + g) ... + 3.
  float s[R], uu[R];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * q + e] = 0.0f;
      uu[4 * q + e] = u[head * HD + 4 * (q * kSplit + g) + e];
    }
  }

  T pr[kPerRow], pk[kPerRow], pv[kPerCol];
  float pw[kPerRow];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kPerRow; ++m) {
      const int e = tid + m * kThreads;
      const int t = t0 + e / HD;
      const long long off = base + t * step + e % HD;
      const bool ok = t < t_len;
      pr[m] = ok ? r[off] : zero<T>();
      pk[m] = ok ? k[off] : zero<T>();
      pw[m] = ok ? logw[off] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kPerCol; ++m) {
      const int e = tid + m * kThreads;
      const int t = t0 + e / kCols;
      const long long off = base + t * step + col0 + e % kCols;
      pv[m] = t < t_len ? v[off] : zero<T>();
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int m = 0; m < kPerRow; ++m) {
      const int e = tid + m * kThreads;
      sr[e / HD][e % HD] = to_f(pr[m]);
      sk[e / HD][e % HD] = to_f(pk[m]);
      sw[e / HD][e % HD] = expf(pw[m]);
    }
#pragma unroll
    for (int m = 0; m < kPerCol; ++m) {
      const int e = tid + m * kThreads;
      sv[e / kCols][e % kCols] = to_f(pv[m]);
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    __syncthreads();     // the last tile's shared memory is read and out
    stage();
    __syncthreads();
    if (t0 + kSteps < t_len) fetch(t0 + kSteps);
    const int n = min(kSteps, t_len - t0);
#pragma unroll 2
    for (int st = 0; st < n; ++st) {
      const float vj = sv[st][c];
      float acc[kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int row = 4 * (q * kSplit + g);
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[st][row]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[st][row]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[st][row]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kk[e] * vj;
          a = fmaf(rr[e], fmaf(uu[i], kv, s[i]), a);
          s[i] = fmaf(ww[e], s[i], kv);
        }
        acc[q] = a;
      }
      float sum = acc[0];
#pragma unroll
      for (int q = 1; q < kQuads; ++q) sum += acc[q];
      sp[st][c * (kSplit + 1) + g] = sum;
    }
    __syncthreads();
    // y of the tile: a (step, column)'s kSplit partials summed in the order
    // g = 0, 1, ..., kSplit - 1
    for (int e = tid; e < n * kCols; e += kThreads) {
      const float* part = &sp[e / kCols][(e % kCols) * (kSplit + 1)];
      float sum = part[0];
#pragma unroll
      for (int m = 1; m < kSplit; ++m) sum += part[m];
      y[base + (t0 + e / kCols) * step + col0 + e % kCols] = sum;
    }
  }

  // the last state: S[i][j] at ((batch · heads + head) · HD + i) · HD + j
  float* out = s_out + static_cast<long long>(bh) * HD * HD + col0 + c;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[static_cast<long long>(4 * (q * kSplit + g) + e) * HD] =
          s[4 * q + e];
    }
  }
}

template <typename T, int HD, int R>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* y, void* s_out, int batch, int t, int heads,
           cudaStream_t stream) {
  const dim3 grid(batch * heads, HD / kCols);
  wkv_kernel<T, HD, R><<<grid, kCols * (HD / R), 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_out), t, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v: contiguous (batch, t, heads, hd) float32 (bf16 = 0) or bf16
// (bf16 = 1); logw of that shape and u (heads, hd), float32; y (batch, t,
// heads, hd) and s_out (batch, heads, hd, hd) float32. hd is 16 or 64.
// Writes nothing when t is 0 (the wrapper zeroes s_out). Returns 0 or the
// cudaError_t of the launch.
int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, void* y, void* s_out,
                     int batch, int t, int heads, int hd, int bf16,
                     void* stream) {
  if (hd != 16 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || t == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return bf16 ? launch<__nv_bfloat16, 64, 8>(r, k, v, logw, u, y, s_out,
                                               batch, t, heads, st)
                : launch<float, 64, 8>(r, k, v, logw, u, y, s_out, batch, t,
                                       heads, st);
  }
  return bf16 ? launch<__nv_bfloat16, 16, 4>(r, k, v, logw, u, y, s_out,
                                             batch, t, heads, st)
              : launch<float, 16, 4>(r, k, v, logw, u, y, s_out, batch, t,
                                     heads, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
