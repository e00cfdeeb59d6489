"""K3 at head_dim 64 (``csrc/flash_attention_sm90_d64.cu``): its launch
choices against each other, the mma.sync kernel and SDPA, timed in turns at
whisper-small's shapes.

    PYTHONPATH=src python -m benchmarks_torch.k3_d64_variants   # on the H100
    PYTHONPATH=src python -m benchmarks_torch.k3_d64_variants --only plan,mma

At whisper-small's three K3 shapes (bf16, batch 4, 12/12 heads, head_dim
64: the encoder's 1500 x 1500 and the cross-attention's 448 x 1500,
non-causal; the decoder's causal 448 x 448), on the smoke's inputs (seed
0), it runs:

* ``c2s1`` ... ``c3s4``: the kernel as built, launched with 2 or 3
  consumer warpgroups (128 or 192 query rows a CTA) and 1 to 4 key splits
  (1 only, where the shape is causal) on the persistent grid of the fewer
  of the SMs and the units; ``ops.d64_plan``'s launch is marked ``plan``,
  and ``unitgrid`` is that launch with one CTA a unit (no walk);
* ``mma`` (``flash_attention_mma``) and ``sdpa``
  (``scaled_dot_product_attention``, the yardstick).

Each kernel run is held per row to the plain version on float64 copies of
the inputs (``chip_smoke.row_rel_err``): within the smoke's ATTN_ROW_TOL
and no further than the bf16 plain version is (``held``); runs of the same
arithmetic as the plan's (every consumer count at the plan's split, and
``unitgrid``) must give its bits (``same_bits``). Then all run in alternating
rounds (four; each 20 launches after one, timed on the device alone by
``chip_smoke.queued_ms``: the host queues them while the device sleeps,
so a short kernel's host overhead does not count). Prints the build's
registers and spills, then one JSON line per shape: per run its times,
mean, the held readings, and the bound (products at 989 TFLOP/s, and the
exponentials at the MUFU's rate, ``chip_smoke.PIPE_RATE``, at the SM clock
nvidia-smi reads), beside the nvidia-smi line. Exits 1 if a run is not
held.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHAPES = {"encoder": (4, 12, 12, 1500, 1500, 64, False),
          "cross": (4, 12, 12, 448, 1500, 64, False),
          "self": (4, 12, 12, 448, 448, 64, True)}


def report(name: str, log: str) -> None:
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "warning" in line
                or "Compiling entry" in line):
            print(f"[{name}] {line.strip()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma list of run names (plan, c2s1, unitgrid, mma, "
                         "...); default all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke.import_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    only = set(args.only.split(",")) if args.only else None
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    info = _build.build_all()
    log = (_build.build_dir() / "flash_attention_sm90_d64.log")
    report("build", log.read_text() if log.exists() else "")
    print(f"[build] {len(info['built'])} kernels built in "
          f"{info['seconds']:.1f} s", flush=True)
    clock = chip_smoke.sm_clock_max_hz()
    sms = ops._sm_count(dev.index or 0)
    bad = []
    for what, (b, hq, hkv, sq, sk, d, causal) in SHAPES.items():
        q, k, v = chip_smoke._qkv(dev, args.seed, b, hq, hkv, sq, sk, d,
                                  torch.bfloat16)
        plan = ops.d64_plan(b, hq, sq, sk, causal, None, sms)
        runs = {}
        for c in (2, 3):
            for s in ((1,) if causal else (1, 2, 3, 4)):
                tiles, _ = ops.d64_units(b, hq, sq, sk, c, s)
                runs[f"c{c}s{s}"] = (c, s, min(sms, tiles * s))
        runs["plan"] = plan
        tiles, _ = ops.d64_units(b, hq, sq, sk, *plan[:2])
        runs["unitgrid"] = plan[:2] + (tiles * plan[1],)
        runs = {n: r for n, r in runs.items() if not only or n in only
                or n == "plan"}

        def kernel_run(launch):
            return lambda: ops.d64_call(q, k, v, causal, None, None, *launch)

        calls = {n: kernel_run(r) for n, r in runs.items()}
        if not only or "mma" in only:
            calls["mma"] = lambda: ops.flash_attention_mma(q, k, v,
                                                           causal=causal)
        if not only or "sdpa" in only:
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)
        want = ops.flash_attention_plain(q, k, v, causal=causal)
        exact = ops.flash_attention_plain(q.double(), k.double(), v.double(),
                                          causal=causal)
        row_plain = chip_smoke.row_rel_err(want, exact)
        ref = calls["plan"]()
        rows = {}
        for n, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            row = chip_smoke.row_rel_err(got, exact)
            same = None
            if n in runs and runs[n][1] == plan[1]:
                same = bool(torch.equal(got.contiguous().view(torch.int16),
                                        ref.contiguous().view(torch.int16)))
            held = (n == "sdpa" or (bool(torch.isfinite(got).all())
                                    and row < chip_smoke.ATTN_ROW_TOL[
                                        "bfloat16"]
                                    and row <= row_plain
                                    and same is not False))
            rows[n] = {"row_rel_err_f64": row, "same_bits": same,
                       "held": held}
            if not held:
                bad.append((what, n))
        del want, exact, got
        ms = {n: [] for n in calls}
        order = list(calls)
        for rnd in range(4):
            for n in (order if rnd % 2 == 0 else order[::-1]):
                ms[n].append(chip_smoke.queued_ms(calls[n], 20))
        pairs = b * hq * (sq * (sq + 1) / 2 if causal else sq * sk)
        bound_ops, _ = chip_smoke.bound_ms(0, 4 * d * pairs,
                                           chip_smoke.PEAK_BF16_OPS_S)
        bound_exp = 1e3 * pairs / (chip_smoke.PIPE_RATE["mufu"] * sms
                                   * clock)
        for n in calls:
            rows[n].update(ms=ms[n], mean=sum(ms[n]) / len(ms[n]))
        print(json.dumps({
            "shape": what, "dims": [b, hq, hkv, sq, sk, d, causal],
            "plan": plan, "row_rel_err_f64_bf16_plain": row_plain,
            "bound_products_ms": bound_ops, "bound_exp_ms": bound_exp,
            "sm_clock_max_hz": clock, "runs": rows, "nvidia_smi": smi}),
            flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    if bad:
        sys.exit(f"k3_d64_variants: not held: {bad}")


if __name__ == "__main__":
    main()
