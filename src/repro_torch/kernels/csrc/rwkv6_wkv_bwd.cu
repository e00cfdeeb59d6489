// W-bwd: the gradient of W (rwkv6_wkv.cu), RWKV6's WKV recurrence, for
// training rwkv6 on the card.
//
// Port only: no Pallas kernel stands behind it. The JAX package's gradient
// is autodiff of the jax.lax.scan of rwkv6_apply
// (src/repro/models/rwkv6.py:97-111); this stands for that autodiff on the
// training path (kernels/rwkv6_wkv/ops.py::rwkv6_wkv_bwd). Its plain
// version is kernels/rwkv6_wkv/ref.py::wkv_bwd_ref.
//
// What it computes, per (batch, head), with S_{t-1} the float32 (dk x dv)
// state before step t (from zero), w_t = exp(logw_t), G the gradient of the
// state after step t (dS, or zero, after the last), dy_t float32, from the
// last step back:
//   dr_t = S_{t-1} dy_t + u ⊙ k_t (dy_t · v_t)
//   dk_t = G v_t + r_t ⊙ u (dy_t · v_t)
//   dv_t = Gᵀ k_t + dy_t (r_t · (u ⊙ k_t))
//   dlogw_t = w_t ⊙ rowsum(G ⊙ S_{t-1})
//   du += r_t ⊙ k_t (dy_t · v_t)          (over T, then the batch)
//   G ← diag(w_t) G + r_tᵀ dy_t
// dr, dk and dv in the inputs' type (bf16 or float32), dlogw float32, du
// float32 (H, hd).
//
// Design, simple first. A CTA owns one (batch, head) and a slice of 16 rows
// i of the state (hd / 16 CTAs a head: 4 at head size 64, 1 at 16), so
// that every sum over the columns j (dr, dk, dlogw) stays inside it; 256
// threads, thread (row il = tid / 16, column group jg = tid % 16) holding
// the columns jg + 16e of its row in registers, the row's sums taken by
// shuffles within a half-warp. Two sweeps over T:
//   * forward: the state S (the thread's hd / 16 elements) is stepped over
//     T, chunk by chunk of kL = 16 steps staged in shared memory, and the
//     state a chunk starts from written to a float32 checkpoint in device
//     memory ((b, H, chunks, hd, hd), the wrapper's scratch);
//   * backward, chunks from the last: the chunk's 16 states S_{t-1} are
//     rebuilt in registers from its checkpoint, then the reverse step runs
//     over them, G in registers. dr, dk and dlogw go to shared memory a step
//     and out a chunk. dv sums over the rows: each warp's two rows are added
//     by a shuffle, the eight warps' partials in order at the chunk's end,
//     plus the slice's dy_t (r_t · (u ⊙ k_t)), into a float32 partial a
//     slice ((slices, b, T, H, hd)); du's r ⊙ k (dy · v) is summed over T by
//     the row's first thread, into a (b, H, hd) partial.
// A second kernel sums dv's slices in order and writes dv in the inputs'
// type, and a third du's partials over the batch in order. No atomics: two
// runs give the same bits.
//
// Bound on an H100 at rwkv6-3b's (1, 4096, 40, 64): operations. The step
// form is 12 float32 operations an element of the state a step (6
// multiply-adds: S rebuilt, G·v, G ⊙ S, dy·S, G·k and G's update), 8.1e9
// FLOP, 0.12 ms at 67 TFLOP/s on the CUDA cores; its bytes (r, k, v, logw,
// dy read, dr, dk, dv, dlogw written) take 0.075 ms. This first version
// runs 160 CTAs over T in order; PERF.md has its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 16;          // steps a chunk (ops.py BWD_CHUNK)
constexpr int kRowsCta = 16;    // rows i of the state a CTA
constexpr int kThreads = 256;   // 16 rows x 16 column groups
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sum over the 16 threads of a row (a half-warp).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Grid (hd / 16 slices, b · H).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ dy,
               const float* __restrict__ dstate, float* __restrict__ ckpt,
               T* __restrict__ dr, T* __restrict__ dk,
               float* __restrict__ dlogw, float* __restrict__ dv_part,
               float* __restrict__ du_part, int t_len, int heads) {
  constexpr int NJ = HD / 16;     // columns a thread
  __shared__ float r_s[kL][kRowsCta], k_s[kL][kRowsCta], w_s[kL][kRowsCta];
  __shared__ float v_s[kL][HD], dy_s[kL][HD];
  __shared__ float dyv_s[kL], ruk_s[kL];
  __shared__ float dk_s[kL][kRowsCta], dr_s[kL][kRowsCta],
      dw_s[kL][kRowsCta];
  __shared__ float dvp_s[kL][kWarps][HD];

  const int slice = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int il = tid >> 4, jg = tid & 15;
  const int i = slice * kRowsCta + il;
  const int chunks = (t_len + kL - 1) / kL;
  // element (b, t, h, c) of a (b, T, H, hd) tensor
  auto at = [&](int t, int c) -> long long {
    return ((static_cast<long long>(b) * t_len + t) * heads + h) * HD + c;
  };
  float* ck = ckpt + (static_cast<long long>(bh) * chunks * HD + i) * HD;

  // the chunk's k, w (the slice's rows) and v; r and dy too when `back`
  auto stage = [&](int t0, bool back) {
    for (int x = tid; x < kL * kRowsCta; x += kThreads) {
      const int s = x / kRowsCta, c = slice * kRowsCta + x % kRowsCta;
      const bool in = t0 + s < t_len;
      k_s[s][x % kRowsCta] = in ? to_f(k[at(t0 + s, c)]) : 0.0f;
      w_s[s][x % kRowsCta] = in ? expf(logw[at(t0 + s, c)]) : 1.0f;
      if (back) r_s[s][x % kRowsCta] = in ? to_f(r[at(t0 + s, c)]) : 0.0f;
    }
    for (int x = tid; x < kL * HD; x += kThreads) {
      const int s = x / HD, c = x % HD;
      const bool in = t0 + s < t_len;
      v_s[s][c] = in ? to_f(v[at(t0 + s, c)]) : 0.0f;
      if (back) dy_s[s][c] = in ? dy[at(t0 + s, c)] : 0.0f;
    }
  };

  // ---- forward: the state each chunk starts from ----
  float S[NJ];
#pragma unroll
  for (int e = 0; e < NJ; ++e) S[e] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int e = 0; e < NJ; ++e) {
      ck[static_cast<long long>(c) * HD * HD + jg + 16 * e] = S[e];
    }
    stage(c * kL, false);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      const float w = w_s[s][il], kk = k_s[s][il];
#pragma unroll
      for (int e = 0; e < NJ; ++e) {
        S[e] = fmaf(w, S[e], kk * v_s[s][jg + 16 * e]);
      }
    }
    __syncthreads();
  }

  // ---- backward, chunks from the last ----
  float G[NJ];
#pragma unroll
  for (int e = 0; e < NJ; ++e) {
    G[e] = dstate != nullptr
               ? dstate[(static_cast<long long>(bh) * HD + i) * HD + jg +
                        16 * e]
               : 0.0f;
  }
  float du_acc = 0.0f;    // the row's, in its jg == 0 thread
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kL;
    const int rows = min(kL, t_len - t0);
    stage(t0, true);
    __syncthreads();
    if (tid < kL) {         // dy_t · v_t and Σ_{slice rows} r u k, a step
      float dyv = 0.0f, ruk = 0.0f;
      for (int j = 0; j < HD; ++j) dyv = fmaf(dy_s[tid][j], v_s[tid][j], dyv);
      for (int x = 0; x < kRowsCta; ++x) {
        ruk = fmaf(r_s[tid][x] * u[h * HD + slice * kRowsCta + x],
                   k_s[tid][x], ruk);
      }
      dyv_s[tid] = dyv;
      ruk_s[tid] = ruk;
    }
    // the chunk's states S_{t-1}, rebuilt from its checkpoint
    float Sp[kL][NJ];
#pragma unroll
    for (int e = 0; e < NJ; ++e) {
      Sp[0][e] = ck[static_cast<long long>(c) * HD * HD + jg + 16 * e];
    }
#pragma unroll
    for (int s = 1; s < kL; ++s) {
      const float w = w_s[s - 1][il], kk = k_s[s - 1][il];
#pragma unroll
      for (int e = 0; e < NJ; ++e) {
        Sp[s][e] = fmaf(w, Sp[s - 1][e], kk * v_s[s - 1][jg + 16 * e]);
      }
    }
#pragma unroll
    for (int s = kL - 1; s >= 0; --s) {
      if (s >= rows) continue;            // past T: the same for all threads
      const float w = w_s[s][il], rr = r_s[s][il], kk = k_s[s][il];
      float pk = 0.0f, pw = 0.0f, pr = 0.0f, col[NJ];
#pragma unroll
      for (int e = 0; e < NJ; ++e) {
        const int j = jg + 16 * e;
        pk = fmaf(G[e], v_s[s][j], pk);
        pw = fmaf(G[e], Sp[s][e], pw);
        pr = fmaf(dy_s[s][j], Sp[s][e], pr);
        col[e] = G[e] * kk;
        col[e] += __shfl_xor_sync(0xffffffffu, col[e], 16);
      }
      pk = row_sum(pk);
      pw = row_sum(pw);
      pr = row_sum(pr);
      if (jg == 0) {
        dk_s[s][il] = pk;
        dw_s[s][il] = pw * w;
        dr_s[s][il] = pr;
      }
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < NJ; ++e) dvp_s[s][warp][jg + 16 * e] = col[e];
      }
#pragma unroll
      for (int e = 0; e < NJ; ++e) {
        G[e] = fmaf(w, G[e], rr * dy_s[s][jg + 16 * e]);
      }
    }
    __syncthreads();
    // out: dr, dk, dlogw of the slice's rows; dv's partial; du's sum
    {
      const int s = tid / kRowsCta, x = tid % kRowsCta;
      const int col = slice * kRowsCta + x;
      if (s < rows) {
        const float dyv = dyv_s[s], rr = r_s[s][x], kk = k_s[s][x];
        const float uu = u[h * HD + col];
        const long long o = at(t0 + s, col);
        store(dr + o, dr_s[s][x] + uu * kk * dyv);
        store(dk + o, dk_s[s][x] + rr * uu * dyv);
        dlogw[o] = dw_s[s][x];
      }
    }
    for (int x = tid; x < kL * HD; x += kThreads) {
      const int s = x / HD, j = x % HD;
      if (s >= rows) continue;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += dvp_s[s][w][j];
      acc = fmaf(dy_s[s][j], ruk_s[s], acc);
      dv_part[static_cast<long long>(slice) * gridDim.y * t_len * HD +
              at(t0 + s, j)] = acc;
    }
    if (jg == 0) {
      for (int s = rows - 1; s >= 0; --s) {
        du_acc = fmaf(r_s[s][il] * k_s[s][il], dyv_s[s], du_acc);
      }
    }
    __syncthreads();
  }
  if (jg == 0) du_part[static_cast<long long>(bh) * HD + i] = du_acc;
}

// dv = Σ_slices dv_part, in order, in T; n = b · T · H · hd.
template <typename T>
__global__ void wkv_dv_kernel(const float* __restrict__ part,
                              T* __restrict__ dv, long long n, int slices) {
  const long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (x >= n) return;
  float s = 0.0f;
  for (int q = 0; q < slices; ++q) s += part[q * n + x];
  store(dv + x, s);
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

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* dy, const void* dstate, void* ckpt,
           void* dr, void* dk, void* dv, void* dlogw, void* dv_part,
           void* du_part, void* du, int batch, int t, int heads,
           cudaStream_t stream) {
  const dim3 grid(HD / kRowsCta, batch * heads);
  wkv_bwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(dstate), static_cast<float*>(ckpt),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<float*>(dlogw),
      static_cast<float*>(dv_part), static_cast<float*>(du_part), t, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * t * heads * HD;
  wkv_dv_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(static_cast<const float*>(dv_part),
                               static_cast<T*>(dv), n, HD / kRowsCta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_du_kernel<<<(heads * HD + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), batch,
      heads * HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* logw, const void* u, const void* dy,
              const void* dstate, void* ckpt, void* dr, void* dk, void* dv,
              void* dlogw, void* dv_part, void* du_part, void* du, int batch,
              int t, int heads, cudaStream_t stream) {
  if (hd == 16) {
    return launch<T, 16>(r, k, v, logw, u, dy, dstate, ckpt, dr, dk, dv,
                         dlogw, dv_part, du_part, du, batch, t, heads, stream);
  }
  if (hd == 64) {
    return launch<T, 64>(r, k, v, logw, u, dy, dstate, ckpt, dr, dk, dv,
                         dlogw, dv_part, du_part, du, batch, t, heads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv: contiguous (b, t, H, hd) of float32 (bf16 = 0) or
// bf16 (bf16 = 1); logw, dy, dlogw (b, t, H, hd) float32; u (H, hd)
// float32; dstate (b, H, hd, hd) float32 or null; scratch: ckpt (b, H,
// ceil(t / 16), hd, hd), dv_part (hd / 16, b, t, H, hd), du_part (b, H, hd),
// float32; du (H, hd) float32. hd is 16 or 64. Three kernels on the stream.
// Returns 0 or the cudaError_t of the first launch that failed.
int rwkv6_wkv_bwd_launch(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* dy,
                         const void* dstate, void* ckpt, void* dr, void* dk,
                         void* dv, void* dlogw, void* dv_part, void* du_part,
                         void* du, int batch, int t, int heads, int hd,
                         int bf16, void* stream) {
  if (batch == 0 || t == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_hd<__nv_bfloat16>(hd, r, k, v, logw, u, dy, dstate, ckpt,
                                    dr, dk, dv, dlogw, dv_part, du_part, du,
                                    batch, t, heads, st);
  }
  return launch_hd<float>(hd, r, k, v, logw, u, dy, dstate, ckpt, dr, dk, dv,
                          dlogw, dv_part, du_part, du, batch, t, heads, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
