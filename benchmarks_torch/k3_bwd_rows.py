"""Where K3-bwd's bf16 gradient rows part from the plain version's, and why.

    PYTHONPATH=src python -m benchmarks_torch.k3_bwd_rows      # on the card

At three of ``chip_smoke.py``'s K3-bwd shapes in bf16 (the AdamW training
shape, a window, a ragged sq), takes dQ, dK and dV three ways on the same
bf16 inputs: the kernel (autograd through ``flash_attention``), the plain
version (autograd through ``flash_attention_plain`` in bf16) and autograd
through the plain attention in float32 on the upcast inputs (the exact
gradient of the bf16 inputs' function, to float32). For each tensor it
prints, per row (a row's max |diff| over its max |want|, floored at 1% and
at 5% of the tensor's max |want|), the kernel against the plain version,
the kernel against float32 and the plain version against float32, with
the three worst rows and their size over the tensor's max; then each
overall (max |diff| over the tensor's max |want|) against float32. This
is what set the per-row floor and limits of ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import json

import torch

from repro_torch.kernels.flash_attention import ops

SHAPES = [(8, 32, 8, 512, 512, 128, True, None),
          (2, 4, 4, 256, 256, 64, True, 96),
          (2, 4, 2, 200, 200, 64, True, None)]


def _qkv(dev, b, hq, hkv, sq, sk, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sq + d)
    return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _rows(got, want, floor):
    diff = (got.float() - want.float()).abs().amax(-1)
    w = want.float().abs()
    den = w.amax(-1).clamp_min(floor * float(w.max()))
    return diff / den, w.amax(-1) / float(w.max())


def _overall(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def main() -> None:
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, hq, hkv, sq, sk, d, causal, window = shape
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   .requires_grad_(True)
                   for t in _qkv(dev, b, hq, hkv, sq, sk, d))
        g = torch.Generator(device=dev).manual_seed(7)
        dout = torch.randn((b, hq, sq, d), generator=g, device=dev).to(
            torch.bfloat16)
        kernel = torch.autograd.grad(
            ops.flash_attention(q, k, v, causal=causal, window=window),
            (q, k, v), dout)
        plain = ops.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                              window=window)
        exact = ops.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), dout.float(), causal=causal,
            window=window)
        for i, name in enumerate(("dq", "dk", "dv")):
            out = {"shape": shape, "tensor": name}
            for floor in (1e-2, 5e-2):
                kp, size = _rows(kernel[i], plain[i], floor)
                top = torch.topk(kp.flatten(), 3).indices.tolist()
                worst = [tuple(int(x) for x in torch.unravel_index(
                    torch.tensor(j), kp.shape)) for j in top]
                out[f"floor {floor}"] = {
                    "kernel_vs_plain": float(kp.max()),
                    "kernel_vs_float32": float(
                        _rows(kernel[i], exact[i], floor)[0].max()),
                    "plain_vs_float32": float(
                        _rows(plain[i], exact[i], floor)[0].max()),
                    "worst_rows": worst,
                    "their_size": [float(size[w]) for w in worst]}
            out["overall_kernel_vs_float32"] = _overall(kernel[i], exact[i])
            out["overall_plain_vs_float32"] = _overall(plain[i], exact[i])
            print(json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
