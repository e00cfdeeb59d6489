"""Where the Hopper K3-bwd's time goes: the device time of each of its three
launches (the prep pass, dK/dV, dQ) at the training shapes.

    PYTHONPATH=src python -m benchmarks_torch.k3_bwd_split     # on the H100

For each shape of ``SHAPES`` (bf16, causal, the model's (b, t, h, d)
layout; inputs from ``--seed``, O and the lse from K3's forward), runs
``flash_attention_bwd_sm90`` 3 times to warm up, then ``--calls`` times
under ``torch.profiler`` (CUDA activity only) and reads each kernel's
average device time from ``key_averages()``. Beside each kernel: the
bf16 FLOP it computes (four products of 2·d a kept pair for dK/dV, three
for dQ, with the causal diagonal counted once) over its time. Prints one
JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (b, hq, hkv, T, d): mistral-nemo's AdamW shape, olmoe's, the long context
SHAPES = [(8, 32, 8, 512, 128), (8, 16, 16, 512, 128),
          (1, 32, 8, 8192, 128)]
PRODUCTS = {"bwd_prep": 0, "bwd_dkdv_sm90": 4, "bwd_dq_sm90": 3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa

    if not torch.cuda.is_available():
        sys.exit("k3_bwd_split needs a CUDA device")
    dev = torch.device("cuda")
    out = {"shapes": []}
    for b, hq, hkv, t, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))
        dout = torch.randn((b, hq, t, d), generator=g, device=dev).bfloat16()
        lse = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
        o = fa.flash_attention_sm90(q, k, v, lse=lse)
        for _ in range(3):
            fa.flash_attention_bwd_sm90(q, k, v, o, dout, lse)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fa.flash_attention_bwd_sm90(q, k, v, o, dout, lse)
            torch.cuda.synchronize()
        pairs = b * hq * t * (t + 1) / 2
        kernels = {}
        for e in prof.key_averages():
            name = next((n for n in PRODUCTS if n + "(" in e.key), None)
            if name is None:
                continue
            us = e.device_time_total / e.count
            flop = PRODUCTS[name] * 2 * d * pairs
            kernels[name] = {"us": us, "launches": e.count,
                             "tflop_s": flop / us / 1e6 if flop else None}
        out["shapes"].append({"shape": [b, hq, hkv, t, d], "kernels": kernels,
                              "total_us": sum(x["us"]
                                              for x in kernels.values())})
        del q, k, v, dout, lse, o
        torch.cuda.empty_cache()
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
