"""What the smoke's K3 checks read when K3 has a planted fault.

    PYTHONPATH=src python -m benchmarks_torch.k3_fault_check [--seed 0]

On the card (CUDA required). For the kernel as it is and for each planted
fault of ``FAULTS``, it writes a copy of ``csrc/flash_attention_sm90.cu``
(the Hopper kernel, which the dense models' prefill runs) with the fault
into ``build/k3_faults/<fault>/``, beside an unchanged copy of
``csrc/flash_attention.cu`` (the sources themselves are never changed),
builds and loads those copies in place of the kernels, and runs the checks
of ``chip_smoke.py`` on them: K3 against its plain version at every shape
of ``ATTN_SHAPES`` (max abs and per row; the bf16 shapes with head_dim 120
or 128 go to the Hopper kernel), and the full-width
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

FAULTY = "flash_attention_sm90.cu"
# name -> [(text of FAULTY, replacement, occurrences)]
FAULTS = {
    "none": [],
    # query head h reads kv head h % hkv instead of h / (hq / hkv)
    "gqa_h_mod_hkv": [("kvh = h / g.group;", "kvh = h % (g.hq / g.group);",
                       1)],
    # rows with more than 8 kv blocks (> 1024 keys) drop the middle one
    "skip_mid_block": [
        ("      const bool masked = needs_mask(g, qw0, 64, k0, kBN);\n",
         "      const bool skip = n_kb > 8 && k0 == (kb0 + n_kb / 2) * kBN;\n"
         "      const bool masked = skip || needs_mask(g, qw0, 64, k0, kBN);\n",
         1),
        ("!key_ok(g, e < 2 ? row0 : row1,",
         "skip || !key_ok(g, e < 2 ? row0 : row1,", 1)],
    # from the 9th kv block on, a new running max does not rescale the
    # accumulator and denominator
    "late_no_rescale": [
        ("      al0 = exp2f(m0 - mx0);\n      al1 = exp2f(m1 - mx1);\n",
         "      al0 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m0 - mx0);\n"
         "      al1 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m1 - mx1);\n", 1)],
}


def use_kernel_source(fault: str) -> None:
    """Point the kernel build at the sources with ``fault`` planted in
    FAULTY (the checkout's own for "none") and drop every loaded copy."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    src = Path(_build.__file__).resolve().parent / "csrc"
    text = (src / FAULTY).read_text()
    for old, new, count in FAULTS[fault]:
        if text.count(old) != count:
            raise RuntimeError(f"{fault}: {old!r} occurs {text.count(old)} "
                               f"times in {FAULTY}, want {count}")
        text = text.replace(old, new)
    if FAULTS[fault]:
        clean = src
        src = ROOT / "build" / "k3_faults" / fault
        src.mkdir(parents=True, exist_ok=True)
        for stale in src.glob("*"):
            stale.unlink()
        (src / FAULTY).write_text(text)
        (src / "flash_attention.cu").write_text(
            (clean / "flash_attention.cu").read_text())
    _build.CSRC = src
    _build._libs.clear()
    ops._launcher.cache_clear()
    ops._launcher_sm90.cache_clear()
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
                      "kernel": r["kernel"], "abs": r["abs"], "row": r["row"],
                      "ok": r["ok"]}
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
