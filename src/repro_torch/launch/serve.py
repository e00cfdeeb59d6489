"""Serving launcher: batched greedy decoding with slot-based continuous
batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --requests 8 --batch-slots 4 --prompt-len 16 --max-new 16

Port of :mod:`repro.launch.serve`: the same flags, the same slot-refill
loop and the same summary line. A fixed pool of ``batch-slots`` decode
lanes shares one decode step; finished requests are swapped out for queued
ones between steps. Prompt ingestion reuses the decode step token by token.
All lanes share one position counter, so a request that enters a lane late
starts at that position over the lane's earlier cache, as in the reference.
The model is drawn from seed 0 on ``--device`` (the card by default), the
prompts from ``numpy.random.RandomState(0)`` as in the reference.
``--model-parallel`` other than 1 raises (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced as reduced_fn
from repro_torch.models.model import Model
from repro_torch.train import steps as steps_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--model-parallel", type=int, default=1)
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
    dev = model.device
    B = args.batch_slots
    decode = steps_mod.make_decode_step(model, batch=B, max_len=args.max_len)
    cache = model.init_cache(B, args.max_len)

    rng = np.random.RandomState(0)
    queue = [rng.randint(0, cfg.vocab_size, size=args.prompt_len).tolist()
             for _ in range(args.requests)]
    # slot state: per-lane (request tokens, cursor, generated, start)
    slots = [None] * B
    done, steps = 0, 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    pos = 0
    outputs = []
    while done < args.requests and pos < args.max_len - 1:
        # refill idle lanes
        for i in range(B):
            if slots[i] is None and queue:
                slots[i] = {"prompt": queue.pop(), "cursor": 0,
                            "gen": [], "start_pos": pos}
        toks = np.zeros((B, 1), np.int64)
        for i, s in enumerate(slots):
            if s is None:
                continue
            if s["cursor"] < len(s["prompt"]):
                toks[i, 0] = s["prompt"][s["cursor"]]
            else:
                toks[i, 0] = s["gen"][-1]
        logits, cache = decode(torch.from_numpy(toks).to(dev), cache, pos)
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        steps += 1
        for i, s in enumerate(slots):
            if s is None:
                continue
            s["cursor"] += 1
            if s["cursor"] >= len(s["prompt"]):
                s["gen"].append(int(nxt[i]))
                if len(s["gen"]) >= args.max_new:
                    outputs.append((s["prompt"], s["gen"]))
                    slots[i] = None
                    done += 1
        pos += 1
    dt = time.time() - t0
    tok_s = steps * B / dt
    print(f"[serve] {done}/{args.requests} requests, {steps} steps, "
          f"{tok_s:.1f} tok/s (batch={B})", flush=True)
    print(f"[serve] {1e3 * dt / max(steps, 1):.3f} ms per decode step "
          f"(host clock, greedy argmax synced every step)", flush=True)
    for p, g in outputs[:2]:
        print(f"  prompt[:8]={p[:8]} -> gen[:8]={g[:8]}", flush=True)
    return outputs


if __name__ == "__main__":
    main()
