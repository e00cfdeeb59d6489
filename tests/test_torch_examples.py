"""The port's examples (examples_torch/) on the CPU, with tiny arguments.

Each example's ``main`` runs with ``--device cpu`` and prints the
reference's lines (examples/), with the device beside every time; the
solve service's results are bit for bit the port's ``abo_minimize`` on the
same objective, n, config and seed (the engine's contract); the watershed
calibration agrees with the JAX package's on the same n. Run as a child
process, each example imports no JAX, none of the JAX package and none of
its benchmarks. The examples are lint-clean under the port's lint.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import lint as tlint
from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.objectives import OBJECTIVES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
NAMES = ["quickstart", "calibrate_watershed", "solve_service",
         "serve_decode", "train_lm_abo"]
TINY = {"quickstart": ["--n", "3000"],
        "calibrate_watershed": ["--n", "5000"],
        "solve_service": [],
        "serve_decode": [],
        "train_lm_abo": ["--steps", "2", "--seq-len", "16", "--batch", "2"]}
FOREIGN = ("jax", "jaxlib", "repro", "benchmarks")


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small tensor ops: torch's intra-op threads
    would only contend for them with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHILD = r"""
import runpy
import sys
path, args = sys.argv[1], sys.argv[2:]
sys.argv = [path] + args
runpy.run_path(path, run_name="__main__")
foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "repro", "benchmarks"))
print("FOREIGN", foreign)
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, capsys, extra=()):
    out = _load(name).main(TINY[name] + ["--device", "cpu", *extra])
    return out, capsys.readouterr().out.splitlines()


def test_quickstart(capsys):
    r, lines = _run("quickstart", capsys)
    assert lines[0] == ("ABO on Griewank, n=3,000 decision variables "
                        "(m = 250 probes/coordinate)")
    assert r.fun < 1e-6 and r.fe == 250 * 3000
    want = ["  best objective :", "  function evals : 750,000",
            "  wall time      :", "  probes/second  :", "  peak RSS       :",
            "  pass history   :"]
    assert [line[:len(w)] for line, w in zip(lines[1:], want)] == want
    assert lines[3].endswith("(cpu)") and lines[4].endswith("(cpu)")
    assert "peak device memory n/a" in lines[5]
    assert "the paper's laptop figure" in lines[1]
    assert not any("paper: 10.9s" in line or "~3.9e6" in line
                   for line in lines)


def test_calibrate_watershed_matches_reference(capsys):
    r, lines = _run("calibrate_watershed", capsys)
    assert lines[0] == ("calibrating 5,000 sub-catchment recession "
                        "parameters...")
    assert lines[1].startswith("  J(k) residual  : ")
    assert lines[2].startswith("  wall time      : ")
    assert "(1,500,000 probes)" in lines[2] and lines[2].endswith("(cpu)")
    assert lines[3].startswith("  k[0:5] found   : ")
    assert lines[4] == ("  k[0:5] true    : ['0.6085', '0.7023', '0.7687', "
                        "'0.7988', '0.7884']")
    # the JAX package's own example at the same n
    import repro.core as JC
    spec = importlib.util.spec_from_file_location(
        "examples_calibrate_watershed",
        os.path.join(ROOT, "examples", "calibrate_watershed.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    obj, _ = ref.make_watershed_objective(5000)
    rj = JC.abo_minimize(obj, 5000, config=JC.ABOConfig(n_passes=6))
    assert r.fe == rj.fe
    assert abs(r.fun - float(rj.fun)) <= 1e-3 * float(rj.fun)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), atol=2e-3)


def test_solve_service_is_abo_minimize_bit_for_bit(capsys):
    (job_ids, results), lines = _run("solve_service", capsys)
    mod = _load("solve_service")
    assert lines[0] == ("submitted 12 jobs over n in (1100, 1400, 1666, "
                        "1800) onto 4 lanes")
    assert any(line.startswith("drained in ") and line.endswith("(cpu)")
               for line in lines)
    assert all(r["status"] == "done" for r in results.values())
    for i, jid in enumerate(job_ids):
        spec = mod.job(i)
        want = abo_minimize(OBJECTIVES[spec["objective"]], spec["n"],
                            config=ABOConfig(**spec["config"]),
                            seed=spec["seed"], device="cpu")
        got = results[jid]
        assert got["fun"] == want.fun, jid
        assert got["history"] == want.history.tolist(), jid
        assert torch.equal(torch.tensor(got["x"], dtype=torch.float32),
                           want.x), jid


def test_serve_decode(capsys):
    outputs, lines = _run("serve_decode", capsys)
    assert len(outputs) == 12 and all(len(g) == 24 for _, g in outputs)
    serve = [line for line in lines if line.startswith("[serve]")]
    assert len(serve) == 2 and all(line.endswith(" | cpu") for line in serve)
    assert serve[0].startswith("[serve] 12/12 requests")


def test_train_lm_abo(capsys, tmp_path):
    (loss_adamw, loss_zo), lines = _run("train_lm_abo", capsys,
                                        ["--ckpt-dir", str(tmp_path)])
    assert np.isfinite(loss_adamw) and np.isfinite(loss_zo)
    assert lines[0] == "=== AdamW baseline ==="
    assert any(line.startswith("=== ABO-ZO") for line in lines)
    done = [line for line in lines if line.startswith("[train] done")]
    assert len(done) == 2 and all(line.endswith(" | cpu") for line in done)
    assert lines[-2].startswith("AdamW : loss") and lines[-2].endswith("(cpu)")
    assert lines[-1].startswith("ABO-ZO: loss")
    assert sorted(os.listdir(tmp_path)) == ["abo_zo", "adamw"]


@pytest.mark.parametrize("name", NAMES)
def test_example_child_imports_no_jax(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.join(EXAMPLES, f"{name}.py"),
         *TINY[name], "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "FOREIGN []", out.stdout[-2000:]


def test_examples_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main(TINY[name])


def test_examples_are_lint_clean():
    assert tlint.lint_paths([EXAMPLES]) == []
