"""K3 at head_dim 256 (``csrc/flash_attention_sm90_d256.cu``) against
variants of itself with one part taken out, timed in turns.

    PYTHONPATH=src python -m benchmarks_torch.k3_d256_variants   # on the H100
    PYTHONPATH=src python -m benchmarks_torch.k3_d256_variants \
        --only cluster1,no_softmax --ref build/k3_fwd_bits/ref_d256.cu

Each variant is the kernel's source (``sm90.cuh`` beside it) with a few
lines replaced, under ``build/k3_d256_variants/<name>/``, built by nvcc
with the kernels' own flags (``-Xptxas -v``: its registers, spills and
shared memory are printed) and called through its C entry at
recurrentgemma-2b's layer shape, (1, 10/1, 8192, 256) bf16, causal, window
2048, on the smoke's inputs (seed 0), with the launch ``ops.d256_plan``
gives unless the variant names its own:

* ``cluster1``: every tile a CTA's own, loading its own K and V (the same
  source, launched with clusters of one);
* ``nonpersistent``: one cluster a tile (the same source, the grid as
  large as the tiles);
* ``no_softmax``: no softmax: P a constant (1/64) that still waits for S,
  the rescale's factors 1 (no exp2f, no max, no mask);
* ``loads_only``: no products and no softmax: the consumers wait for each
  stage and release it;
* ``products_only``: no K or V loads and no waits for them, and no
  softmax: the products alone, on whatever the stages hold;
* ``no_rescale``: O is not rescaled (the rescale's share of the step);
* ``clocked``: the base with clock64 around each wait, the mean cycles a
  CTA's consumer 0 and producer spent in each written over O's start
  (O's stores dropped) and reported as ``wait_cycles``;

and, as design probes: ``kstages3`` and ``vstages3`` (a third K or V
stage: 224 KB of shared memory) and ``stride_walk`` (each worker's tiles
at a stride of the grid, not in a snake).
With ``--ref``, an earlier commit's source of the kernel whose C entry
has no cluster or grid arguments (the first design's) runs in the same
rounds as ``ref``.

The kernel has no ping-pong of its consumers: built and measured no
faster than running them in step, it was taken out (PERF.md has its
readings).
The base and the variants that compute the same function (``cluster1``,
``nonpersistent``, ``kstages3``, ``vstages3``, ``stride_walk``, ``ref``)
are held bit for bit to the base's output; the others compute something
else and are only timed. All run in alternating rounds (CUDA events over
20 launches each, after one), so that they share the card's state. Prints
one JSON line: per variant its times, mean, whether it is held, and its
build's report (registers, spills, shared memory and any ptxas warning),
and the SM clock and power that nvidia-smi sampled during the rounds;
``--sass DIR`` also writes each build's SASS there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "flash_attention_sm90_d256.cu"

_ISSUE_S = "    auto issue_s = [&](float (&sc)[32], int s) {\n"
_ISSUE_PV = "      auto issue_pv = [&](int s) {\n"
_SOFTMAX = ("      auto softmax = [&](float (&sc)[32], int k0, float& al0, "
            "float& al1) {\n")
# P a small constant kept dependent on S (the wait for S stays), no max,
# no exp2f; P is not garbage, whose bits would change the tensor cores'
# power draw and so their clock
_NO_SOFTMAX = _SOFTMAX + (
    "        al0 = al1 = 1.0f;\n"
    "#pragma unroll\n"
    "        for (int j = 0; j < 32; ++j)\n"
    "          sc[j] = fmaf(sc[j], 0.0f, 0.015625f);\n"
    "        return;\n")
_NO_S = (_ISSUE_S, _ISSUE_S + "      return;\n")
_NO_PV = (_ISSUE_PV, _ISSUE_PV + "          return;\n")
# no K or V load and no wait for one: the products on whatever the stages
# hold (each (text, replacement[, occurrences]))
_NO_LOADS = [
    ("        mbar_wait(empty, ((it / stages) & 1) ^ 1);\n",
     "        return;\n"),
    ("        mbar_wait(k_full(ks), (ki / kKStages) & 1);\n", ""),
    ("        mbar_wait(k_full(ks), (kit / kKStages) & 1);\n", ""),
    ("        mbar_wait(v_full(vs), (vi / kVStages) & 1);\n", "", 2)]

def _timed(stmt: str, into: str) -> str:
    """``stmt`` (one line) with its clock64 cycles added to ``into``."""
    pad = stmt[:len(stmt) - len(stmt.lstrip())]
    return (f"{pad}{{ const long long t0_ = clock64();\n{stmt}"
            f"{pad}  {into} += clock64() - t0_; }}\n")


_KW = "        mbar_wait(k_full(ks), (ki / kKStages) & 1);\n"
_KW0 = "        mbar_wait(k_full(ks), (kit / kKStages) & 1);\n"
_VW = "        mbar_wait(v_full(vs), (vi / kVStages) & 1);\n"
_SW = "        wgmma_wait<1>();          // S is done; P·V may still run\n"
_PW = "        wgmma_wait<0>();          // block i - 1's P·V is done\n"
_QW = "      mbar_wait(q_full, w & 1);\n"
_EW = "        mbar_wait(empty, ((it / stages) & 1) ^ 1);\n"
_IS = "        issue_s(sc, ks);\n        rescale();                // while S runs\n"
_IP = "        issue_pv(vs);\n"
_SM = "        softmax(sc, (kb0 + i) * kBN, al0, al1);\n"
_QE = "        if (w > 0) mbar_wait(q_empty, (w - 1) & 1);\n"
# Cycles (clock64 / 64) each consumer warpgroup waits for K, V, S, P·V and
# Q and spends issuing S, rescaling, issuing P·V and in the softmax, and
# the producer waits for a free K stage, V stage and Q, and each role's
# whole run, written over the start of O (whose stores are dropped): the
# kernel's own breakdown of where a step goes.
_CLOCKED = [
    ("    const unsigned char* q_base = smem + kQOff + cw * 64 * 128;\n",
     "    const unsigned char* q_base = smem + kQOff + cw * 64 * 128;\n"
     "    long long ck = 0, cv = 0, cs = 0, cp = 0, cq = 0, cis = 0, crs = 0,"
     " cip = 0, csm = 0;\n"
     "    const long long c0_ = clock64();\n"),
    (_KW, _timed(_KW, "ck")), (_KW0, _timed(_KW0, "ck")),
    (_VW, _timed(_VW, "cv"), 2), (_SW, _timed(_SW, "cs")),
    (_PW, _timed(_PW, "cp")), (_QW, _timed(_QW, "cq")),
    (_IS, _timed("        issue_s(sc, ks);\n", "cis")
     + _timed("        rescale();                // while S runs\n", "crs")),
    (_IP, _timed(_IP, "cip"), 2),
    (_SM, _timed(_SM, "csm")),
    ("  }\n  cluster_sync();             // no CTA leaves",
     "    if (wtid == 0) {\n"
     "      uint32_t* d_ = reinterpret_cast<uint32_t*>(o) + "
     "(blockIdx.x * 3 + cw) * 12;\n"
     "      d_[0] = ck >> 6; d_[1] = cv >> 6; d_[2] = cs >> 6;\n"
     "      d_[3] = cp >> 6; d_[4] = cq >> 6;\n"
     "      d_[5] = (clock64() - c0_) >> 6;\n"
     "      d_[6] = cis >> 6; d_[7] = crs >> 6; d_[8] = cip >> 6;\n"
     "      d_[9] = csm >> 6;\n"
     "    }\n"
     "  }\n  cluster_sync();             // no CTA leaves"),
    ("      auto stage_in = [&](",
     "      long long pk = 0, pv = 0, pq = 0;\n"
     "      const long long p0_ = clock64();\n"
     "      auto stage_in = [&]("),
    (_EW, _timed(_EW, "(map == &tk ? pk : pv)")), (_QE, _timed(_QE, "pq")),
    ("        kit += n_kb;\n      }\n    }\n  } else {",
     "        kit += n_kb;\n      }\n"
     "      uint32_t* d_ = reinterpret_cast<uint32_t*>(o) + "
     "(blockIdx.x * 3 + 2) * 12;\n"
     "      d_[0] = pk >> 6; d_[1] = pv >> 6; d_[2] = pq >> 6;\n"
     "      d_[5] = (clock64() - p0_) >> 6;\n"
     "    }\n  } else {"),
    ("        if (row0 < g.sq)\n          *reinterpret_cast",
     "        if (row0 < 0)\n          *reinterpret_cast"),
    ("        if (row1 < g.sq)\n          *reinterpret_cast",
     "        if (row1 < 0)\n          *reinterpret_cast")]
# name: (held to the base's bits, [(text, replacement), ...], launch)
VARIANTS = {
    "base": (True, [], None),
    "cluster1": (True, [], "cluster1"),
    "nonpersistent": (True, [], "nonpersistent"),
    "no_softmax": (False, [(_SOFTMAX, _NO_SOFTMAX)], None),
    "loads_only": (False, [(_SOFTMAX, _NO_SOFTMAX), _NO_S, _NO_PV], None),
    "products_only": (False, [(_SOFTMAX, _NO_SOFTMAX), *_NO_LOADS], None),
    "no_rescale": (False, [("      auto rescale = [&]() {\n",
                            "      auto rescale = [&]() {\n        return;\n")],
                   None),
    "clocked": (False, _CLOCKED, None),
    "kstages3": (True, [("constexpr int kKStages = 2;",
                         "constexpr int kKStages = 3;")], None),
    "vstages3": (True, [("constexpr int kVStages = 2;",
                         "constexpr int kVStages = 3;")], None),
    "stride_walk": (True, [("return r * p + ((r & 1) ? p - 1 - k : k);",
                            "return r * p + k;")], None),
}


def build(name: str, text: str):
    """Write ``text`` as the kernel's source under build/k3_d256_variants/
    <name>/ and start nvcc on it: (the library, the compiler's process)."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "k3_d256_variants" / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    (out / SOURCE).write_text(text)
    shutil.copy(_build.CSRC / "sm90.cuh", out / "sm90.cuh")
    lib = out / "kernel.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
         str(out / SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def variant_text(name: str, subs) -> str:
    from repro_torch.kernels import _build
    text = (_build.CSRC / SOURCE).read_text()
    for old, new, *count in subs:
        want = count[0] if count else 1
        if text.count(old) != want:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {SOURCE}, want {want}")
        text = text.replace(old, new)
    return text


def main(argv=None) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import D256_SHAPE, _qkv, nvidia_smi_line
    from repro_torch.kernels.flash_attention import ops

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names (base always runs)")
    ap.add_argument("--ref", default=None,
                    help="an earlier flash_attention_sm90_d256.cu without "
                         "the cluster and grid arguments, run as ref")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", default=None,
                    help="a directory for each build's cuobjdump -sass")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.only is None else (
        ["base"] + [n for n in args.only.split(",") if n != "base"])
    if not torch.cuda.is_available():
        raise SystemExit("k3_d256_variants needs a card")
    t0 = time.perf_counter()
    texts = {n: variant_text(n, VARIANTS[n][1]) for n in names}
    if args.ref:
        texts["ref"] = Path(args.ref).read_text()
    jobs = {n: build(n, t) for n, t in texts.items()}
    libs, logs = {}, {}
    for n, (lib, proc) in jobs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{logs[n]}")
        libs[n] = ctypes.CDLL(str(lib))
        if args.sass:
            from torch.utils.cpp_extension import CUDA_HOME
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"{n}.sass").write_text(subprocess.run(
                [f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                capture_output=True, text=True, check=True).stdout)
    build_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    b, hq, hkv, t, _, d, causal, window = D256_SHAPE
    q, k, v = _qkv(dev, 0, b, hq, hkv, t, t, d, torch.bfloat16)
    o = ops._new_out(q)
    stream = torch.cuda.current_stream().cuda_stream
    common = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
              hkv, t, t, *ops._tma_strides(q), *ops._tma_strides(k),
              *ops._tma_strides(v), *o.stride()[:3], int(causal),
              int(window or 0), d ** -0.5 * math.log2(math.e), None]
    calls = {}
    for n, lib in libs.items():
        fn = lib.flash_attention_sm90_d256_launch
        if n == "ref":
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            calls[n] = (fn, (*common, stream), None)
            continue
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        slots_fn = lib.flash_attention_sm90_d256_slots
        slots_fn.argtypes = [ctypes.c_int]
        slots_fn.restype = ctypes.c_int
        slots = {c: slots_fn(c) for c in (1, 2)}
        launch = VARIANTS[n][2]
        if launch == "cluster1":
            plan = (1, min(slots[1], -(-t // ops.D256_BLOCK_Q) * b * hq))
        elif launch == "nonpersistent":
            plan = ops.d256_plan(b, hq, hkv, t, {1: 1 << 30, 2: 1 << 30})
        else:
            plan = ops.d256_plan(b, hq, hkv, t, slots)
        calls[n] = (fn, (*common, *plan, stream), {"plan": plan,
                                                   "slots": slots})

    def call(n):
        fn, a, _ = calls[n]
        code = fn(*a)
        if code:
            raise RuntimeError(f"{n}: launch failed with {code}")

    out = {}
    base_bits = None
    for n in calls:
        print(f"[k3_d256_variants] {n}: first call", flush=True)
        o.fill_(float("nan"))
        call(n)
        torch.cuda.synchronize()
        bits = o.view(torch.int16).clone()
        clocks = None
        if n == "clocked":
            plan = calls[n][2]["plan"]
            raw = o.transpose(1, 2).reshape(-1).view(torch.int32)[
                :plan[1] * 36].view(plan[1], 3, 12).double() * 64
            names = {"consumer": ("k", "v", "s", "pv", "q", "all",
                                  "issue_s", "rescale", "issue_pv",
                                  "softmax"),
                     "producer": ("k_stage", "v_stage", "q", None, None,
                                  "all")}
            clocks = {role: {k: float(raw[:, r, j].mean())
                             for j, k in enumerate(names[role]) if k}
                      for role, r in (("consumer", 0), ("producer", 2))}
        if n == "base":
            base_bits = bits
        held = VARIANTS.get(n, (True,))[0]
        out[n] = {"ms": [], "held": held,
                  "same_bits": bool(torch.equal(bits, base_bits)) if held
                  else None,
                  **(calls[n][2] or {}),
                  **({"wait_cycles": clocks} if clocks else {}),
                  "build": [ln.split("ptxas info    : ")[-1]
                            for ln in logs[n].splitlines()
                            if any(w in ln for w in (
                                "registers", "spill", "smem", "arning"))]}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the SM clock and power while the rounds run, sampled every 50 ms
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for r in range(args.rounds):
        order = list(calls) if r % 2 == 0 else list(calls)[::-1]
        for n in order:
            call(n)
            start.record()
            for _ in range(20):
                call(n)
            end.record()
            torch.cuda.synchronize()
            out[n]["ms"].append(start.elapsed_time(end) / 20)
    smi.terminate()
    samples = [tuple(float(x) for x in ln.split(","))
               for ln in smi.communicate()[0].splitlines()
               if ln.count(",") == 1]
    for n in out:
        out[n]["mean_ms"] = sum(out[n]["ms"]) / len(out[n]["ms"])
    clocks = sorted(c for c, _ in samples)
    result = {"shape": D256_SHAPE, "device": nvidia_smi_line(),
              "build_s": build_s, "variants": out,
              "sm_mhz": {"samples": len(clocks),
                         "min": clocks[0] if clocks else None,
                         "median": clocks[len(clocks) // 2] if clocks
                         else None,
                         "max": clocks[-1] if clocks else None},
              "power_w_max": max((w for _, w in samples), default=None)}
    print(json.dumps(result))
    if not all(r["same_bits"] for r in out.values() if r["held"]):
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
