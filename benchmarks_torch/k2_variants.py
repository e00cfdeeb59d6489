"""K2's design choices timed against the alternatives they were chosen over.

    PYTHONPATH=src python -m benchmarks_torch.k2_variants    # on the H100

Builds, from the text of ``csrc/griewank_aggregates.cu``, the kernel as it
stands (``kernel``) and each variant below, into ``build/k2_variants/``,
all at once (one ``nvcc`` a source). Every variant must give the kernel's
bits at n = 12,293 and n = 1e8 + 17 (n_valid = n - 3), or the script
fails. Then each is timed at n = 1e8 + 17 (x uniform in [-600, 600] from
``--seed``) by CUDA events over 20 calls after a warm-up, a call being the
zeroing of its scratch words and one launch, as the wrapper makes it. The
rounds run kernel, variants, variants reversed, kernel, ``--rounds`` times,
so that drift shows as spread. Prints one JSON line: each entry's times,
their mean and spread (max - min), and the card's name and power limit.

* ``fold_last_cta``: design (a) of the fold. Every CTA takes tiles, and the
  last one to finish (a completion counter) folds the tile partials in tile
  order after the pass: its threads stage 512 rows at a time in shared
  memory while threads 0, 1 and 2 add S, L and K of the previous 512. (One
  thread adding a 16-byte row a step, three chains side by side, measured
  slower.) In place of the fold CTA that follows per-tile flags while the
  pass runs (design (b)).
* ``library_log1pf``: the log1p branch calls the library's ``log1pf(-m)``
  in place of ``k2_log1p_neg(m)``, the same bits (the shortcut check).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess

SOURCE = "griewank_aggregates.cu"
N_MAIN = 10**8 + 17
N_SMALL = 3 * 4096 + 5

# Design (a), appended to the kernel's source (its tile code, tree and
# helpers are in the same translation unit). The launcher takes the
# wrapper's arguments; ``ready`` holds the tile counter and the completion
# counter.
_FOLD_LAST_CTA = r"""
namespace {

constexpr int kStageRows = 512;  // tile partials staged at once

__global__ void __launch_bounds__(kThreads)
k2_fold_last_cta_kernel(const float* __restrict__ x, long long n,
                        long long n_valid, long long n_tiles,
                        float4* partials, unsigned* counters,
                        float* __restrict__ out) {
  __shared__ float red[2][3][kWarps][32];
  __shared__ float4 stage[2][kStageRows];
  __shared__ unsigned next_tile[2];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long clean_end = n < n_valid ? n : n_valid;
  if (tid == 0) next_tile[0] = atomicAdd(counters, 1u);
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    const long long t = next_tile[buf];
    if (t >= n_tiles) break;
    if (tid == 0) next_tile[buf ^ 1] = atomicAdd(counters, 1u);
    const long long base = t * kTile;
    float s, l, k;
    if (base + kTile > clean_end || base + kTile > kIndex32End) {
      tile_leaves<true>(x, base, tid, n, n_valid, &s, &l, &k);
    } else {
      tile_leaves<false>(x, base, tid, n, n_valid, &s, &l, &k);
    }
    red[buf][0][warp][lane] = s;
    red[buf][1][warp][lane] = l;
    red[buf][2][warp][lane] = k;
    __syncthreads();
    if (warp == 0) {
      s = fold_lanes(fold_warps(red[buf][0], lane));
      l = fold_lanes(fold_warps(red[buf][1], lane));
      k = fold_lanes(fold_warps(red[buf][2], lane));
      if (lane == 0) partials[t] = make_float4(s, l, k, 0.0f);
    }
  }
  // thread 0 wrote this CTA's partials; the CTA that finishes last folds
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kEach = kStageRows / kThreads;
  float4 v[kEach];
#pragma unroll
  for (int j = 0; j < kEach; ++j) {
    const long long r = tid + kThreads * j;
    v[j] = r < n_tiles ? __ldcg(partials + r)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float acc = 0.0f;
  int buf = 0;
  for (long long b0 = 0; b0 < n_tiles; b0 += kStageRows, buf ^= 1) {
#pragma unroll
    for (int j = 0; j < kEach; ++j) stage[buf][tid + kThreads * j] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kEach; ++j) {  // the next batch, under this fold
      const long long r = b0 + kStageRows + tid + kThreads * j;
      v[j] = r < n_tiles ? __ldcg(partials + r)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (tid < 3) {  // thread a adds aggregate a, row by row
      const long long left = n_tiles - b0;
      const int rows = left < kStageRows ? static_cast<int>(left)
                                         : kStageRows;
      const float* col = reinterpret_cast<const float*>(stage[buf]) + tid;
#pragma unroll 8
      for (int i = 0; i < rows; ++i) acc = __fadd_rn(acc, col[4 * i]);
    }
  }
  if (tid < REPRO_LANES) out[tid] = tid < 3 ? acc : 0.0f;
}

}  // namespace

extern "C" int k2_variant_launch(const float* x, long long n,
                                 long long n_valid, float4* partials,
                                 unsigned* counters, float* out,
                                 void* stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k2_fold_last_cta_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  k2_fold_last_cta_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, n, n_valid, n_tiles, partials, counters, out);
  return static_cast<int>(cudaGetLastError());
}
"""

_LOG1P_CALL = "*l = __fmul_rn(0.5f, k2_log1p_neg(s2));"


def variant_sources(text: str) -> dict[str, tuple[str, bool]]:
    """{name: (source text, True if it brings its own launcher)}."""
    if text.count(_LOG1P_CALL) != 1:
        raise ValueError(f"{SOURCE} no longer has one `{_LOG1P_CALL}`")
    return {
        "kernel": (text, False),
        "fold_last_cta": (text + _FOLD_LAST_CTA, True),
        "library_log1pf": (text.replace(
            _LOG1P_CALL, "*l = __fmul_rn(0.5f, log1pf(-s2));"), False),
    }


def build(sources: dict[str, tuple[str, bool]]) -> dict[str, str]:
    """Compile every source at once; {name: path of its library}."""
    from repro_torch.kernels import _build
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name, (text, _) in sorted(sources.items()):
        h.update(name.encode() + text.encode())
    for f in sorted(_build.CSRC.iterdir()):
        h.update(f.name.encode() + f.read_bytes())
    out = _build.BUILD_ROOT.parent / "k2_variants" / h.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    jobs, libs = {}, {}
    for name, (text, _) in sources.items():
        src, lib = out / f"{name}.cu", out / f"{name}.so"
        libs[name] = str(lib)
        if lib.exists():
            continue
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"[build] {name}: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    return libs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import _build
    from repro_torch.objectives.base import REDUCE_TILE
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    text = (_build.CSRC / SOURCE).read_text()
    sources = variant_sources(text)
    libs = build(sources)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def caller(name, x, n_valid):
        lib = ctypes.CDLL(libs[name])
        fn = (lib.k2_variant_launch if sources[name][1]
              else lib.griewank_aggregates_launch)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        n = x.numel()
        n_tiles = -(-n // REDUCE_TILE)
        partials = torch.empty((n_tiles, 4), dtype=torch.float32,
                               device=dev)
        words = 2 if sources[name][1] else n_tiles + 1
        ready = torch.zeros(words, dtype=torch.int32, device=dev)
        out = torch.empty((1, 128), dtype=torch.float32, device=dev)

        def call():
            ready.zero_()
            code = fn(x.data_ptr(), n, n_valid, partials.data_ptr(),
                      ready.data_ptr(), out.data_ptr(), stream)
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code}")
            return out
        return call

    names = list(sources)
    x = None
    for n in (N_SMALL, N_MAIN):
        x = torch.rand(n, generator=gen, device=dev) * 1200.0 - 600.0
        want = caller("kernel", x, n - 3)().clone()
        for name in names[1:]:
            got = caller(name, x, n - 3)()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} gives other bits than the kernel "
                                 f"at n={n}: {got[0, :3].tolist()} against "
                                 f"{want[0, :3].tolist()}")
    calls = {name: caller(name, x, N_MAIN) for name in names}
    times = {name: [] for name in names}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    order = names + names[1:][::-1] + names[:1]
    for _ in range(args.rounds):
        for name in order:
            calls[name]()                                    # warm-up
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                calls[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 20)
    result = {"n": N_MAIN, "card": smi, "ms": times,
              "mean_ms": {k: sum(v) / len(v) for k, v in times.items()},
              "spread_ms": {k: max(v) - min(v) for k, v in times.items()}}
    for name in names:
        print(f"[k2_variants] {name}: mean {result['mean_ms'][name]:.4f} ms,"
              f" spread {result['spread_ms'][name]:.4f} ms over "
              f"{len(times[name])} timings | {smi}", flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
