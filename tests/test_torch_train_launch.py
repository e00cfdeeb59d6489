"""The port's training launcher (``launch.train``) on the CPU: a resume
from its checkpoint equal to the uninterrupted run bit for bit (AdamW and
ABO-ZO), the module entry point, the model-parallel refusal, and ABO-ZO's
loss never rising above its incumbent. The helpers are
``test_torch_train``'s.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as ttrain
from repro_torch.train import abo_zo as tabo
from repro_torch.train import steps as tsteps
from test_torch_train import CPU, _batch, _pair


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _train(tmp, steps, optimizer):
    return ttrain.main([
        "--arch", "mistral-nemo-12b", "--reduced", "--steps", str(steps),
        "--seq-len", "32", "--batch", "4", "--ckpt-dir", str(tmp),
        "--ckpt-every", "4", "--log-every", "100", "--optimizer", optimizer,
        "--device", CPU])


def _ckpt_leaves(directory, step):
    d = directory / f"step_{step:012d}"
    return [np.load(f) for f in sorted(d.glob("leaf_*.npy"))]


@pytest.mark.parametrize("optimizer", ["adamw", "abo_zo"])
def test_train_resume_determinism(tmp_path, optimizer):
    """launch/train.py resumes from its checkpoint and matches the
    uninterrupted run bit for bit: parameters, optimizer state, loss."""
    loss_full = _train(tmp_path / "a", 8, optimizer)
    _train(tmp_path / "b", 4, optimizer)
    loss_resumed = _train(tmp_path / "b", 8, optimizer)
    assert loss_full == loss_resumed
    a, b = _ckpt_leaves(tmp_path / "a", 8), _ckpt_leaves(tmp_path / "b", 8)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_train_launcher_runs_as_a_module():
    """``python -m repro_torch.launch.train`` trains, as the reference's
    docstring runs it (its example is olmoe-1b-7b)."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--reduced", "--steps", "2", "--seq-len", "16",
         "--batch", "2", "--device", CPU], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": src,
                          "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    assert "[train] done: 2 steps" in out.stdout, out.stdout


def test_train_launcher_model_parallel_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        ttrain.main(["--arch", "mistral-nemo-12b", "--reduced",
                     "--model-parallel", "2", "--device", CPU])


def test_train_launcher_abo_zo_loss_never_rises(capsys):
    """ABO-ZO's incumbent is among its candidates, so the step's loss is at
    most the incumbent's on the step's batch."""
    _, _, tm = _pair("mistral-nemo-12b")
    step = tsteps.make_train_step(tm, optimizer="abo_zo")
    state = tsteps.init_opt_state(tm, "abo_zo")
    batch = {"tokens": torch.from_numpy(_batch(tm.cfg, b=4, seed=40))}
    with torch.no_grad():
        f0 = float(tm.loss(batch)[0])
    state, met = step(state, batch, tabo.fold_in(tabo.prng_key(1), 0))
    assert float(met["loss"]) <= f0
    with torch.no_grad():
        assert float(tm.loss(batch)[0]) == float(met["loss"])
