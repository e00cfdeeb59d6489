"""What the smoke's K3 checks read when K3 has a planted fault.

    PYTHONPATH=src python -m benchmarks_torch.k3_fault_check [--seed 0]

On the card (CUDA required). For the kernel as it is and for each planted
fault of ``FAULTS``, it writes a copy of ``csrc/flash_attention.cu`` with
the fault into ``build/k3_faults/<fault>/`` (the source itself is never
changed), builds and loads that copy in place of the kernel, and runs the
checks of ``chip_smoke.py`` on it: K3 against its plain version at every
shape of ``ATTN_SHAPES`` (max abs and per row), and the full-width
``mistral-nemo-12b`` forward over 8192 tokens against the same forward
with the plain attention (K3 per row on each layer's own q, k, v; the
logits at every position). One JSON line per fault: each reading, its
limit, and which checks fail. A check that passes a planted fault cannot
see that fault. Imports torch, the port and ``chip_smoke`` only.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# name -> [(text of flash_attention.cu, replacement, occurrences)]
FAULTS = {
    "none": [],
    # query head h reads kv head h % hkv instead of h / (hq / hkv)
    "gqa_h_mod_hkv": [("kvh = h / g.group;", "kvh = h % (g.hq / g.group);",
                       2)],
    # rows with more than 8 kv blocks (>= 512 keys) skip the middle one
    "skip_mid_block": [
        ("    const int k0 = kb * kBN;\n",
         "    if (kb1 - kb0 > 8 && kb == (kb0 + kb1) / 2) continue;\n"
         "    const int k0 = kb * kBN;\n", 1),
        ("    const int k0 = kb * kFBN;\n",
         "    if (kb1 - kb0 > 8 && kb == (kb0 + kb1) / 2) continue;\n"
         "    const int k0 = kb * kFBN;\n", 1)],
    # from the 9th kv block on, a new running max does not rescale the
    # accumulator and denominator
    "late_no_rescale": [
        ("const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);",
         "const float al0 = kb - kb0 >= 8 ? 1.0f : expf(m0 - mx0),\n"
         "                al1 = kb - kb0 >= 8 ? 1.0f : expf(m1 - mx1);", 1),
        ("const float alpha = expf(m - mx);",
         "const float alpha = kb - kb0 >= 8 ? 1.0f : expf(m - mx);", 1)],
}


def use_kernel_source(fault: str) -> None:
    """Point the kernel build at the source with ``fault`` planted (the
    checkout's own for "none") and drop every loaded copy."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    src = Path(_build.__file__).resolve().parent / "csrc"
    text = (src / "flash_attention.cu").read_text()
    for old, new, count in FAULTS[fault]:
        if text.count(old) != count:
            raise RuntimeError(f"{fault}: {old!r} occurs {text.count(old)} "
                               f"times in flash_attention.cu, want {count}")
        text = text.replace(old, new)
    if FAULTS[fault]:
        src = ROOT / "build" / "k3_faults" / fault
        src.mkdir(parents=True, exist_ok=True)
        for stale in src.glob("*"):
            stale.unlink()
        (src / "flash_attention.cu").write_text(text)
    _build.CSRC = src
    _build._libs.clear()
    ops._launcher.cache_clear()
    _build.build_all()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke.import_port()
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    cfg = ARCHS[chip_smoke.LM_ARCH]
    model = Model(cfg, device=dev).init(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, chip_smoke.LM_T),
                           generator=gen, device=dev)
    for fault in args.faults:
        use_kernel_source(fault)
        attn = chip_smoke.attention_readings(dev, args.seed)
        lm, _ = chip_smoke.lm_agreement(model, tokens)
        torch.cuda.empty_cache()
        abs_tol, row_tol = chip_smoke.ATTN_TOL, chip_smoke.ATTN_ROW_TOL
        row = {
            "fault": fault,
            "attn": [{"shape": r["shape"], "dtype": r["dtype"],
                      "abs": r["abs"], "row": r["row"], "ok": r["ok"]}
                     for r in attn],
            "attn_abs_limit": abs_tol, "attn_row_limit": row_tol,
            "attn_abs_fails": sum(not r["abs"] < abs_tol[r["dtype"]]
                                  for r in attn),
            "attn_row_fails": sum(not r["row"] < row_tol[r["dtype"]]
                                  for r in attn),
            **{f"lm_{k}": lm[k] for k in (
                "layers_max", "pos_rel_max", "pos_rel_early", "pos_rel_last",
                "argmax_equal_share", "argmax_last_equal", "ok_layers",
                "ok_logits")}}
        row["caught"] = (not all(r["ok"] for r in attn)
                         or not lm["ok_layers"] or not lm["ok_logits"])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
