"""Where the Hopper K3-bwd kernels' time goes: the device time of each of
their launches at the training shapes.

    PYTHONPATH=src python -m benchmarks_torch.k3_bwd_split     # on the H100

For each shape of ``SHAPES`` (bf16, the model's (b, t, h, d) layout;
inputs from ``--seed``, O and the lse from K3's forward), runs the
backward kernel that ``choose_bwd_kernel`` names (``flash_attention_bwd_sm90``
at head_dim 128, ``flash_attention_bwd_sm90_d64`` at 64,
``flash_attention_bwd_sm90_d256`` at 256) 3 times to warm up, then
``--calls`` times under ``torch.profiler`` (CUDA activity only) and reads
each CUDA kernel's average device time from ``key_averages()``: the dQ
pass (its first sweep over the keys writes each row's D), dK/dV, and at
head_dim 256 with a split group the partials' sum. Beside each: the bf16
FLOP of its own products (``PRODUCTS``: S and dP in each of dQ's two
sweeps and dQ; Sᵀ, dPᵀ, dV and dK; none in the sum) of 2·d a kept pair,
over its time. Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (b, hq, hkv, sq, sk, d, causal, window): mistral-nemo's AdamW shape,
# olmoe's, the long context; whisper-small's encoder, cross- and decoder
# self-attention; recurrentgemma-2b's local attention
SHAPES = [(8, 32, 8, 512, 512, 128, True, None),
          (8, 16, 16, 512, 512, 128, True, None),
          (1, 32, 8, 8192, 8192, 128, True, None),
          (4, 12, 12, 1500, 1500, 64, False, None),
          (4, 12, 12, 448, 1500, 64, False, None),
          (4, 12, 12, 448, 448, 64, True, None),
          (1, 10, 1, 4096, 4096, 256, True, 2048)]
PRODUCTS = {"bwd_dq_sm90": 5, "bwd_dq_d64": 5, "bwd_dkdv_sm90": 4,
            "bwd_dq_d256": 5, "bwd_dkdv_d256": 4, "bwd_sum_d256": 0}


def kept_pairs(b, hq, sq, sk, causal, window) -> int:
    """The (query, key) pairs K3's masks keep (query row i sees key j when
    j <= i under causal and i - j < window)."""
    n = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return b * hq * n


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
    for b, hq, hkv, sq, sk, d, causal, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        q = torch.randn((b, sq, hq, d), generator=g,
                        device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn((b, sk, hkv, d), generator=g, device=dev)
                .bfloat16().transpose(1, 2) for _ in range(2))
        dout = torch.randn((b, hq, sq, d), generator=g, device=dev).bfloat16()
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        o = fa._KERNELS[fa.choose_kernel(q, k, v)](q, k, v, causal=causal,
                                                    window=window, lse=lse)
        name = fa.choose_bwd_kernel(q, k, v, o, dout)
        wrapper = getattr(fa, name)

        def call():
            return wrapper(q, k, v, o, dout, lse, causal=causal,
                           window=window)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                call()
            torch.cuda.synchronize()
        pairs = kept_pairs(b, hq, sq, sk, causal, window)
        kernels = {}
        for e in prof.key_averages():
            kname = next((n for n in PRODUCTS
                          if n + "(" in e.key or n + "<" in e.key), None)
            if kname is None:
                continue
            us = e.device_time_total / e.count
            flop = PRODUCTS[kname] * 2 * d * pairs
            kernels[kname] = {"us": us, "launches": e.count,
                              "tflop_s": flop / us / 1e6 if flop else None}
        out["shapes"].append({
            "shape": [b, hq, hkv, sq, sk, d, causal, window], "wrapper": name,
            "kept_pairs": pairs, "kernels": kernels,
            "total_us": sum(x["us"] for x in kernels.values())})
        print(json.dumps(out["shapes"][-1]), flush=True)
        del q, k, v, dout, lse, o
        torch.cuda.empty_cache()
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
