"""Training launcher: --arch selectable, checkpoint/restart, preemption-safe.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --steps 200 --optimizer adamw --ckpt-dir /tmp/ckpt \\
        --device cpu

Port of :mod:`repro.launch.train` on one device: the same flags, log lines
and return value (the final loss). The model is drawn with
``Model(cfg).init(0)`` on ``--device`` (the card by default); the data is
``BigramStream`` at the reference's seed; ABO-ZO's key for step s is
``fold_in(PRNGKey(1), s)`` (``train.abo_zo``'s threefry). A checkpoint
(``checkpoint.manager``) holds the parameters, the optimizer state and the
step, every ``--ckpt-every`` steps and on SIGTERM/SIGINT (preemption); a
restart resumes from the latest committed one, the data cursor included.
bf16 leaves are stored as their int16 bit patterns. ``--model-parallel``
other than 1 raises (ROADMAP queue 1, item 10).

Determinism: the launcher turns on ``torch.use_deterministic_algorithms``
for its run, so that a resumed run's parameters equal an uninterrupted
run's bit for bit on the card too (the embedding's backward otherwise
accumulates with atomics).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, reduced as reduced_fn
from repro_torch.data.synthetic import BigramStream, StreamConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as steps_mod
from repro_torch.train.abo_zo import ABOZOConfig, fold_in, prng_key


def _to_disk(tree):
    """bf16 leaves as their int16 bit patterns (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: _to_disk(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.detach().view(torch.int16)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _restore_into(tree, saved) -> None:
    """Copy a restored tree (``_to_disk``'s layout, host tensors) into the
    live tensors of ``tree`` in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _restore_into(v, saved[k])
        elif v.dtype == torch.bfloat16:
            v.detach().view(torch.int16).copy_(saved[k])
        else:
            v.detach().copy_(saved[k])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "abo_zo"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 is not ported yet (ROADMAP queue 1, item "
            "10: multi-device)")

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_fn(cfg)
    model = Model(cfg, device=args.device).init(0)
    print(f"[train] arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M "
          f"mesh={{'data': 1, 'model': 1}} opt={args.optimizer}", flush=True)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    if model.device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        return _run(model, cfg, args, model.device)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _run(model, cfg, args, dev):
    step_fn = steps_mod.make_train_step(
        model, optimizer=args.optimizer, microbatches=args.microbatches,
        adamw_cfg=AdamWConfig(lr=args.lr), abo_cfg=ABOZOConfig())
    opt_state = steps_mod.init_opt_state(model, args.optimizer)
    params = dict(model.named_parameters())

    stream = BigramStream(StreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch))

    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            live = {"params": params, "opt": opt_state}
            _restore_into(live, ckpt.restore(latest, _to_disk(live)))
            start = latest
            print(f"[train] resumed from step {start}", flush=True)

    stop = {"now": False}

    def _sigterm(signum, frame):
        print(f"[train] signal {signum}: checkpointing before exit",
              flush=True)
        stop["now"] = True

    old = {s: signal.signal(s, _sigterm)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        key = prng_key(1)
        t0 = time.time()
        metrics = None
        for step in range(start, args.steps):
            batch = {"tokens": stream.torch_batch(step, dev)}
            if args.optimizer == "abo_zo":
                opt_state, metrics = step_fn(opt_state, batch,
                                             fold_in(key, step))
            else:
                opt_state, metrics = step_fn(opt_state, batch)
            if (step + 1) % args.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                print(f"[train] step {step+1:5d} loss={loss:.4f} "
                      f"({dt:.1f}s)", flush=True)
            if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                     or stop["now"]):
                ckpt.save(step + 1, _to_disk({"params": params,
                                             "opt": opt_state}),
                          blocking=stop["now"])
            if stop["now"]:
                ckpt and ckpt.wait()
                print("[train] clean preemption exit", flush=True)
                sys.exit(0)
        if ckpt is not None:
            ckpt.wait()
            if ckpt.latest_step() != args.steps:   # not already saved in-loop
                ckpt.save(args.steps, _to_disk({"params": params,
                                               "opt": opt_state}))
            ckpt.wait()
        final = float(metrics["loss"]) if metrics is not None else float("nan")
        print(f"[train] done: {args.steps} steps in {time.time()-t0:.1f}s "
              f"final_loss={final:.4f}", flush=True)
        return final
    finally:
        for s, h in old.items():
            signal.signal(s, h)


if __name__ == "__main__":
    main()
