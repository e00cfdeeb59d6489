"""End-to-end run: train an LM with AdamW vs ABO-ZO (the paper's
zero-state optimizer) on the synthetic bigram corpus, with checkpointing.

Port of ``examples/train_lm_abo.py`` on ``repro_torch.launch.train``: a
reduced olmoe (MoE) for ``--steps`` steps of each optimizer, on the card
unless ``--device cpu`` is given. Without ``--ckpt-dir`` the checkpoints go
to a fresh temporary directory, removed at the end (an existing directory
is resumed from, as the launcher does).

    PYTHONPATH=src python examples_torch/train_lm_abo.py --steps 200 [--device cpu]
"""
import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch.device import device_label, labelled_stdout, resolve_device
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_ckpt_")
    common = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
              "--seq-len", str(args.seq_len), "--batch", str(args.batch),
              "--log-every", "25", "--device", str(dev)]

    def timed(optimizer, extra):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        loss = train_main(common + ["--optimizer", optimizer, *extra,
                                    "--ckpt-dir",
                                    os.path.join(ckpt_dir, optimizer)])
        return loss, time.time() - t0    # the loss is a host number

    label = device_label(dev)
    try:
        # the launcher's step and done lines carry its times
        with labelled_stdout(label, lambda line: line.startswith(
                ("[train] step", "[train] done"))):
            print("=== AdamW baseline ===")
            loss_adamw, t_adamw = timed("adamw", ["--lr", "3e-3"])
            print("=== ABO-ZO (paper technique: zero optimizer state) ===")
            loss_zo, t_zo = timed("abo_zo", [])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    print(f"\nAdamW : loss {loss_adamw:.4f} in {t_adamw:.0f}s "
          f"(3 fp32 state copies) ({label})")
    print(f"ABO-ZO: loss {loss_zo:.4f} in {t_zo:.0f}s "
          f"(ZERO optimizer state — the paper's claim) ({label})")
    return loss_adamw, loss_zo


if __name__ == "__main__":
    main()
