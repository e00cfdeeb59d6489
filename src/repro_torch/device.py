"""Device resolution for the port's entry points, and the label a printed
time carries."""
from __future__ import annotations

import contextlib
import sys
from typing import Callable

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it returns ``cuda`` and raises when CUDA is
    absent, so a run never carries on quietly on the CPU. An explicit
    device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) is taken as given,
    and a CUDA device without a card raises too.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def device_label(device) -> str:
    """What a printed time ran on: for a card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (a card may be held below its maximum power, and then runs slower
    under load); for the CPU, ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def peak_memory_mb(device) -> str:
    """Peak device memory allocated since the last reset, in MB, for a
    card; ``"n/a"`` on the CPU (its peak is the process's RSS)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "n/a"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MB"


class _Labelled:
    """A stdout that appends `` | label`` to each finished line for which
    ``timed(line)`` holds, and forwards every line as it ends."""

    def __init__(self, out, label: str, timed: Callable[[str], bool]):
        self.out, self.label, self.timed, self.buf = out, label, timed, ""

    def write(self, s: str) -> int:
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.out.write(f"{line} | {self.label}\n" if self.timed(line)
                           else line + "\n")
        return len(s)

    def flush(self) -> None:
        self.out.flush()


@contextlib.contextmanager
def labelled_stdout(label: str, timed: Callable[[str], bool]):
    """Within the block, the lines printed to stdout that ``timed`` picks
    (those that carry a time) get `` | label`` appended."""
    out = _Labelled(sys.stdout, label, timed)
    with contextlib.redirect_stdout(out):
        try:
            yield
        finally:
            if out.buf:
                out.write("\n")
            out.flush()
