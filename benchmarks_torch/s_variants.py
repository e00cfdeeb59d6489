"""Where S's time goes: its parts removed one at a time, and the read rate of
TMA boxes by strip width.

    PYTHONPATH=src python -m benchmarks_torch.s_variants            # H100
    PYTHONPATH=src python -m benchmarks_torch.s_variants --strips   # + reads

Builds text copies of ``csrc/rglru_scan.cu`` under
``build/s_variants/``, each with one part of the kernel taken out, loads
each with ctypes and times them in turns (two rounds, in opposite orders)
on recurrentgemma-2b's (1, 8192, 2560) bf16 with the device asleep while
the host queues the launches:

- ``base``: the kernel as it is;
- ``no_gate_math``: the gate rows write constants instead of the gates;
- ``no_scan``: warp 0 runs no recurrence (and writes no h);
- ``loads_only``: both of the above: the TMA reads, the (a, g) writes and
  the barriers;
- ``no_loads``: no TMA and no wait for it: the gates on whatever the ring
  holds, the recurrence;
- ``scan_only``: no loads and constant gates;
- ``sync_only``: no loads, constant gates, no recurrence: the tile loop,
  its shared-memory writes and its barriers.

Only ``base`` computes S; the others' outputs are not checked. With
``--strips``, a separate microbenchmark reads three (t, d) bf16 tensors in
TMA boxes of w channels x 96 steps, one strip of w channels a CTA over
all of t, 4 boxes of each in flight, for w from 8 to 64 channels (16 to
128 bytes a row) at 132 CTAs, t chosen so that the bytes are those of
S's inputs: the read rate a strip width allows. Prints one line a reading
and a JSON line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

SHAPE = (1, 8192, 2560)
OUT = Path(__file__).resolve().parents[1] / "build" / "s_variants"

GATES = """          gate_row(st[item[i]], st[tile_items + item[i]],
                   st[2 * tile_items + item[i]], dec[i], tab, v);"""
CONST = "for (int c = 0; c < E; ++c) v[c] = make_float2(0.5f, 0.25f);"
SCAN = "    } else if (warp == 0 && k > 0 && lane < nch) {"
NO_SCAN = "    } else if (false) {"
WAIT = "        mbar_wait(bar0 + 8 * (k % kStages), (k / kStages) & 1);"
REFILL = "    if (!producer || k >= tiles) return;"
NO_LOADS = [(WAIT, ""), (REFILL, "    return;")]
EDITS = {
    "base": [],
    "no_gate_math": [(GATES, CONST)],
    "no_scan": [(SCAN, NO_SCAN)],
    "loads_only": [(GATES, CONST), (SCAN, NO_SCAN)],
    "no_loads": NO_LOADS,
    "scan_only": NO_LOADS + [(GATES, CONST)],
    "sync_only": NO_LOADS + [(GATES, CONST), (SCAN, NO_SCAN)],
}

STRIPS_CU = r"""
#include "sm90.cuh"
namespace {
constexpr int R = 96, S = 4;
__global__ void __launch_bounds__(32)
read_strips(const __grid_constant__ CUtensorMap m0,
            const __grid_constant__ CUtensorMap m1,
            const __grid_constant__ CUtensorMap m2, int t, int w,
            int* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* buf = smem + 1024;
  const int tiles = (t + R - 1) / R, box = w * R * 2;
  if (threadIdx.x != 0) return;
  for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const CUtensorMap* maps[3] = {&m0, &m1, &m2};
  int acc = 0;
  for (int k = 0; k < tiles + S; ++k) {
    if (k >= S) {
      const int j = k - S;
      mbar_wait(bar0 + 8 * (j % S), (j / S) & 1);
      acc += buf[(j % S) * 3 * box];
    }
    if (k < tiles) {
      const uint32_t bar = bar0 + 8 * (k % S);
      mbar_expect_tx(bar, 3 * box);
      for (int i = 0; i < 3; ++i) {
        tma_load(buf + ((k % S) * 3 + i) * box, maps[i], bar, blockIdx.x * w,
                 k * R, 0, 0);
      }
    }
  }
  if (acc == 12345) sink[0] = acc;
}
}  // namespace
extern "C" int strips_launch(const void* a, const void* b, const void* c,
                             int t, int d, int w, int* sink, void* stream) {
  CUtensorMap m[3];
  const void* p[3] = {a, b, c};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, 1, 1};
    const cuuint64_t row = (cuuint64_t)d * 2;
    const cuuint64_t strides[3] = {row, row * t, row * t};
    const cuuint32_t box[4] = {(cuuint32_t)w, R, 1, 1};
    const cuuint32_t el[4] = {1, 1, 1, 1};
    if (fn(&m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p[i]),
           dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -2;
    }
  }
  const int smem = 1024 + S * 3 * w * R * 2;
  cudaFuncSetAttribute(read_strips,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  read_strips<<<d / w, 32, smem, (cudaStream_t)stream>>>(m[0], m[1], m[2], t,
                                                         w, sink);
  return (int)cudaGetLastError();
}
"""


def build(name: str, text: str):
    """Compile ``text`` to ``OUT/name.so`` with the port's flags."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` back to back, the host ahead."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parts(dev) -> dict:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan.ref import decay_rate, rglru_lru_ref
    from repro_torch.models.rglru import log_lambda_init

    src = (_build.CSRC / "rglru_scan.cu").read_text()
    fns = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        fn = build(name, text).rglru_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device=dev).manual_seed(0)
    u, xi, xr = (torch.randn(SHAPE, generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(3))
    lam = log_lambda_init(SHAPE[2], dev).to(torch.bfloat16)
    nsp = decay_rate(lam)
    h = torch.empty_like(u)
    last = torch.empty(SHAPE[0], SHAPE[2], device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        code = fn(u.data_ptr(), xi.data_ptr(), xr.data_ptr(), nsp.data_ptr(),
                  h.data_ptr(), last.data_ptr(), *SHAPE, 1, stream)
        if code != 0:
            raise RuntimeError(f"launch failed with {code}")

    run(fns["base"])
    want = rglru_lru_ref(u, xi, xr, lam)
    if not (torch.equal(h, want[0]) and torch.equal(last, want[1])):
        raise RuntimeError("the base copy is not S's plain version's bits")
    ms = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            ms[name].append(queued_ms(lambda: run(fns[name]), 50))
    for name, v in ms.items():
        print(f"[s_variants] {name}: {v} ms", flush=True)
    return ms


def strips(dev) -> dict:
    import torch
    fn = build("strips", STRIPS_CU).strips_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for w in (8, 16, 24, 32, 64):
        d = 132 * w
        t = (SHAPE[1] * SHAPE[2] // d) // 96 * 96
        xs = [torch.randn(t, d, device=dev).to(torch.bfloat16)
              for _ in range(3)]

        def run():
            code = fn(xs[0].data_ptr(), xs[1].data_ptr(), xs[2].data_ptr(),
                      t, d, w, sink.data_ptr(), stream)
            if code != 0:
                raise RuntimeError(f"strips launch failed with {code}")

        ms = queued_ms(run, 10)
        rate = 3 * t * d * 2 / ms / 1e9
        out[w] = {"ms": ms, "tb_s": rate, "t": t, "d": d}
        print(f"[s_variants] strips of {w} channels ({2 * w} bytes a row), "
              f"132 CTAs, (t, d) = ({t}, {d}): {ms:.4f} ms, {rate:.3f} TB/s",
              flush=True)
        del xs
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strips", action="store_true",
                    help="also time TMA reads by strip width")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("s_variants needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"card": card, "shape": SHAPE, "parts_ms": parts(dev)}
    if args.strips:
        result["strips"] = strips(dev)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
