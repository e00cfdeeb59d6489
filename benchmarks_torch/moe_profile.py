"""Where an MoE config's prefill step spends its time on the card.

    PYTHONPATH=src python -m benchmarks_torch.moe_profile    # on the card
    PYTHONPATH=src python -m benchmarks_torch.moe_profile --arch moonshot-v1-16b-a3b

Draws the config at full width (bf16, random weights from seed 0, as the
launchers do), warms the prefill step (``train.steps.make_prefill_step``:
the config's capacity, dispatched in chunks) up on one request of
``--tokens`` tokens, times it untraced three times, then runs it once under
``torch.profiler`` (CPU and CUDA activities). Prints the untraced walls,
the traced step's summed kernel time against its wall (the device's busy
share: the step's kernels run on one stream, so they do not overlap), and
the operators by the device time of the kernels each launched itself,
with their call counts. Then the same for one MoE layer's ``moe_apply`` on
the step's own input shape, lossless (capacity None, as prefill and decode
run it) and at the config's capacity. Fails without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.train.steps import make_prefill_step


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _traced(fn, what: str, top: int) -> None:
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(_device_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / 1e6
    ops = [e for e in events
           if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    print(f"{what}: untraced walls {[round(w, 4) for w in walls]} s; traced "
          f"wall {wall:.4f} s, kernels {busy:.4f} s of it (busy "
          f"{busy / wall:.1%}); operators by their kernels' device time:",
          flush=True)
    for e in sorted(ops, key=_device_us, reverse=True)[:top]:
        print(f"  {e.key[:60]:60s} {_device_us(e) / 1e3:9.3f} ms "
              f"{e.count:6d} calls", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    choices=[a for a, c in ARCHS.items() if c.n_experts])
    ap.add_argument("--tokens", type=int, default=8192)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[moe_profile] {args.arch}, 1 x {args.tokens} tokens | {smi}",
          flush=True)
    dev = torch.device("cuda")
    cfg = ARCHS[args.arch]
    model = Model(cfg, device=dev).init(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.tokens),
                           generator=gen, device=dev)
    step = make_prefill_step(model)
    _traced(lambda: step({"tokens": tokens}), "prefill step", args.top)

    layer = cfg.first_dense
    params = model.decoder[layer]["moe"]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, args.tokens, cfg.d_model, generator=g,
                    device=dev).to(cfg.param_dtype)
    for cf in (None, "cfg"):
        with torch.no_grad():
            _traced(lambda: moe.moe_apply(params, cfg, x, capacity_factor=cf),
                    f"layer {layer}'s moe_apply, capacity "
                    f"{cfg.moe_capacity_factor if cf else None}", args.top)


if __name__ == "__main__":
    main()
