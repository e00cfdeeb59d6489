"""What the smoke's K3 checks read when K3 has a planted fault.

    PYTHONPATH=src python -m benchmarks_torch.k3_fault_check [--seed 0]

On the card (CUDA required). For the kernels as they are and for each
planted fault of ``FAULTS``, it writes a copy of ``csrc/`` with the fault
planted in one Hopper K3 source (``flash_attention_sm90.cu``, which the
dense models' prefill runs, or ``flash_attention_sm90_d256.cu``,
recurrentgemma-2b's local attention) into ``build/k3_faults/<fault>/`` (the
sources themselves are never changed), builds and loads that copy in place
of the kernels, and runs the checks of ``chip_smoke.py`` on it: the
head_dim 256 kernel's stage releases in its SASS (none right after a
product with no wait: ``benchmarks_torch.k3_sass``), K3 against its plain
version at every shape of ``ATTN_SHAPES`` (max abs and per row, the
output's memory left NaN before each call, so a tile never written shows;
bf16 at head_dim 120 or 128 goes to the first kernel, at 256 to the
second), and the full-width forward over 8192 tokens against the same
forward with the plain attention (K3 per row on each attention layer's own
q, k, v; the logits at every position): ``mistral-nemo-12b`` for the first
kernel's faults, ``recurrentgemma-2b`` (with the plain scan) for the
second's. One JSON line per fault: each reading, its limit, and which
checks fail. A check that passes a planted fault cannot see that fault.
Exits 1 when a planted fault passes every check or the kernels as they are
("none") fail one, after the last line. Imports torch, the port and
``chip_smoke`` only.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SM90, D256 = "flash_attention_sm90.cu", "flash_attention_sm90_d256.cu"
# name -> (source, [(text of the source, replacement, occurrences)])
FAULTS = {
    "none": (SM90, []),
    # query head h reads kv head h % hkv instead of h / (hq / hkv)
    "gqa_h_mod_hkv": (SM90, [("kvh = h / g.group;",
                              "kvh = h % (g.hq / g.group);", 1)]),
    # rows with more than 8 kv blocks (> 1024 keys) drop the middle one
    "skip_mid_block": (SM90, [
        ("      const bool masked = needs_mask(g, qw0, 64, k0, kBN);\n",
         "      const bool skip = n_kb > 8 && k0 == (kb0 + n_kb / 2) * kBN;\n"
         "      const bool masked = skip || needs_mask(g, qw0, 64, k0, kBN);\n",
         1),
        ("!key_ok(g, e < 2 ? row0 : row1,",
         "skip || !key_ok(g, e < 2 ? row0 : row1,", 1)]),
    # from the 9th kv block on, a new running max does not rescale the
    # accumulator and denominator
    "late_no_rescale": (SM90, [
        ("      al0 = exp2f(m0 - mx0);\n      al1 = exp2f(m1 - mx1);\n",
         "      al0 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m0 - mx0);\n"
         "      al1 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m1 - mx1);\n", 1)]),
    # head_dim 256: the same two faults of the walk over kv blocks (64 keys
    # each, so > 512 keys), and two of its own 32-chunk accumulator: rows
    # gr + 8 rescaled with rows gr's factor, and the output keeping only
    # dims 0..127. (The GQA fault of the head_dim 128 kernel has its
    # counterpart in d256_peer_head. A wrong box stride for V reads past
    # shared memory: the launch faults, which any check sees.)
    "d256_skip_mid_block": (D256, [
        ("        const bool masked = needs_mask(g, qw0, 64, k0, kBN);\n",
         "        const bool skip = n_kb > 8 && k0 == (kb0 + n_kb / 2) * kBN;\n"
         "        const bool masked = skip || needs_mask(g, qw0, 64, k0, kBN);\n",
         1),
        ("            if (masked && (col < (e < 2 ? lo0 : lo1) ||",
         "            if (masked && (skip || col < (e < 2 ? lo0 : lo1) ||", 1)]),
    "d256_late_no_rescale": (D256, [
        ("        al0 = exp2f(m0 - mx0);\n        al1 = exp2f(m1 - mx1);\n",
         "        al0 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m0 - mx0);\n"
         "        al1 = k0 >= (kb0 + 8) * kBN ? 1.0f : exp2f(m1 - mx1);\n", 1)]),
    "d256_rescale_rows": (D256, [
        ("          acc[4 * nt + 2] *= al1;\n          acc[4 * nt + 3] *= al1;\n",
         "          acc[4 * nt + 2] *= al0;\n          acc[4 * nt + 3] *= al0;\n",
         1)]),
    "d256_half_output": (D256, [
        ("      for (int nt = 0; nt < 32; ++nt) {\n        const int col",
         "      for (int nt = 0; nt < 16; ++nt) {\n        const int col", 1)]),
    # the redesign's parts: a K stage freed as soon as S is issued, not
    # once S is done, so the producer's next load into it races S's reads
    # (in both CTAs of a shared tile); the second CTA of a cluster
    # computing its partner's head (its Q) into its own; the persistent
    # walk of cluster 0 dropping its last shared tile (its output stays as
    # the allocator left it)
    "d256_release_early": (D256, [
        ("        issue_pv(vs);\n"
         "        wgmma_wait<1>();          // S is done; P·V may still run\n"
         "        fence_acc(sc);\n"
         "        release(k_empty(ks));\n",
         "        issue_pv(vs);\n"
         "        release(k_empty(ks));\n"
         "        wgmma_wait<1>();          // S is done; P·V may still run\n"
         "        fence_acc(sc);\n", 1),
        ("        issue_s(sc, ks);\n"
         "        wgmma_wait<0>();\n"
         "        fence_acc(sc);\n"
         "        release(k_empty(ks));\n",
         "        issue_s(sc, ks);\n"
         "        release(k_empty(ks));\n"
         "        wgmma_wait<0>();\n"
         "        fence_acc(sc);\n", 1)]),
    "d256_peer_head": (D256, [
        ("                   tl.h, tl.b);",
         "                   tl.h - (tl.shared ? rank : 0), tl.b);", 1)]),
    "d256_walk_skip": (D256, [
        ("  const int mine = rounds + (snake(rounds, cluster, clusters) < "
         "g.n_shared);",
         "  const int mine = rounds + (snake(rounds, cluster, clusters) < "
         "g.n_shared) - (cluster == 0 && rounds > 1);", 1)]),
}


def use_kernel_source(fault: str) -> None:
    """Point the kernel build at a copy of ``csrc/`` with ``fault`` planted
    (the checkout's own for "none") and drop every loaded copy."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    clean = Path(_build.__file__).resolve().parent / "csrc"
    name, edits = FAULTS[fault]
    src = clean
    if edits:
        text = (clean / name).read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{fault}: {old!r} occurs "
                                   f"{text.count(old)} times in {name}, want "
                                   f"{count}")
            text = text.replace(old, new)
        src = ROOT / "build" / "k3_faults" / fault
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(clean, src)
        (src / name).write_text(text)
    _build.CSRC = src
    _build._libs.clear()
    ops._launcher.cache_clear()
    ops._launcher_sm90.cache_clear()
    ops._launcher_sm90_d256.cache_clear()
    ops._d256_slots.cache_clear()
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
    models = {}

    def lm_reading(source: str) -> dict:
        """The forward of the model whose path runs ``source``, drawn once,
        against its plain run."""
        arch = (chip_smoke.HYBRID_ARCH if source == D256
                else chip_smoke.LM_ARCH)
        if arch not in models:
            models.clear()
            torch.cuda.empty_cache()
            cfg = ARCHS[arch]
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            models[arch] = (Model(cfg, device=dev).init(args.seed),
                            torch.randint(0, cfg.vocab_size,
                                          (1, chip_smoke.LM_T),
                                          generator=gen, device=dev))
        model, tokens = models[arch]
        if source == D256:
            def plain(errs):
                return chip_smoke.plain_hybrid(errs, [])
        else:
            plain = chip_smoke.plain_attention
        return chip_smoke.lm_agreement(model, tokens, plain=plain)[0]

    missed = []
    for fault in sorted(args.faults, key=lambda f: FAULTS[f][0]):
        use_kernel_source(fault)
        attn = chip_smoke.attention_readings(dev, args.seed)
        order = chip_smoke.d256_release_order()
        lm = lm_reading(FAULTS[fault][0])
        torch.cuda.empty_cache()
        abs_tol, row_tol = chip_smoke.ATTN_TOL, chip_smoke.ATTN_ROW_TOL
        row = {
            "fault": fault, "source": FAULTS[fault][0],
            "attn": [{"shape": r["shape"], "dtype": r["dtype"],
                      "kernel": r["kernel"], "abs": r["abs"], "row": r["row"],
                      "repeat": r.get("repeat"), "ok": r["ok"]}
                     for r in attn],
            "attn_repeat_fails": sum(r.get("repeat") is False for r in attn),
            "attn_abs_limit": abs_tol, "attn_row_limit": row_tol,
            "attn_abs_fails": sum(not r["abs"] < abs_tol[r["dtype"]]
                                  for r in attn),
            "attn_row_fails": sum(not r["row"] < row_tol[r["dtype"]]
                                  for r in attn),
            "d256_sass_early": order["early"],
            **{f"lm_{k}": lm[k] for k in (
                "layers_max", "pos_rel_max", "pos_rel_early", "pos_rel_last",
                "argmax_equal_share", "argmax_last_equal", "ok_layers",
                "ok_logits")}}
        row["caught"] = (not all(r["ok"] for r in attn)
                         or bool(order["early"])
                         or not lm["ok_layers"] or not lm["ok_logits"])
        print(json.dumps(row), flush=True)
        if row["caught"] == (fault == "none"):
            missed.append(fault)
    if missed:
        sys.exit(f"k3_fault_check: wrong verdict for {missed}")


if __name__ == "__main__":
    main()
