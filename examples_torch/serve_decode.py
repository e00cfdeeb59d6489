"""Batched serving example: continuous-batching greedy decode.

Runs the rwkv6 (attention-free, O(1) state) reduced model through the
slot-based serving loop of ``repro_torch.launch.serve``. Port of
``examples/serve_decode.py``: the same launcher arguments, on the card
unless ``--device cpu`` is given; the launcher's lines are printed with
the card's name and power limit beside each time.

    PYTHONPATH=src python examples_torch/serve_decode.py [--device cpu]
"""
import argparse

from repro_torch.device import device_label, labelled_stdout, resolve_device
from repro_torch.launch.serve import main as serve_main

SERVE_ARGS = ["--arch", "rwkv6-3b", "--reduced",
              "--requests", "12", "--batch-slots", "4",
              "--prompt-len", "12", "--max-new", "24",
              "--max-len", "128"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the launcher's "[serve]" lines carry its tok/s and ms per step
    with labelled_stdout(device_label(dev),
                         lambda line: line.startswith("[serve]")):
        return serve_main(SERVE_ARGS + ["--device", str(dev)])


if __name__ == "__main__":
    main()
