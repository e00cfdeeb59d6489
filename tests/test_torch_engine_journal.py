"""The port's engine durable state, on the CPU: snapshots, the journal,
resume, the kill matrix and fsck.

The journal and resume cases of tests/test_engine_journal.py and the
checkpoint cases of tests/test_engine_faults.py, run on the port with
``device="cpu"`` and held to the port's own uninterrupted run bit for bit
(fun, x and history). Kill children go through ``subprocess.run(...,
timeout=120)``, so nothing can hang the suite. Then the formats against
the JAX engine on the same specs: the aux (job table without its
timestamps, queue, counters, every pool's capacity, slots, job ids, page
table and lane devices, the families seen) and the journal's bytes, after
0, 1 and 2 steps. A float64 family's snapshot resumes bit for bit too.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import repro.core.abo as JA
import repro.engine as JE
import repro_torch.core.abo as TA
import repro_torch.engine as TE
from repro_torch.checkpoint.fsck import fsck, main as fsck_main
from repro_torch.core import ABOConfig, abo_minimize
from repro_torch.engine import (CANCELLED, DONE, FAILED, QUEUED, JobSpec,
                                SolveEngine, SolveService)
from repro_torch.objectives import OBJECTIVES

CPU = "cpu"
CFG = ABOConfig(samples_per_pass=12, n_passes=3)
SHAPES = [("griewank", 64), ("sphere", 96), ("rastrigin", 80)]
REPO = pathlib.Path(__file__).resolve().parent.parent


def _mixed_specs(count, seed0=0):
    return [JobSpec(*SHAPES[i % len(SHAPES)], CFG, seed=seed0 + i)
            for i in range(count)]


def _engine(**kw):
    return SolveEngine(device=CPU, **kw)


def _resume(ck, **kw):
    return SolveEngine.resume(ck, device=CPU, **kw)


def _uninterrupted(specs, lanes=2, **kw):
    """{spec index: (fun, x bytes, history bytes)} of one engine run."""
    eng = _engine(lanes=lanes, **kw)
    ids = eng.submit_many(specs)
    eng.run()
    out = {}
    for i, jid in enumerate(ids):
        r = eng.result(jid)
        out[i] = (r.fun, r.x.numpy().tobytes(), r.history.numpy().tobytes())
    return out


def _same(rec, want, x=True):
    """A resumed job record against the uninterrupted run's result."""
    assert rec.status == DONE
    r = rec.result()
    assert r.fun == want[0]
    assert r.history.numpy().tobytes() == want[2]
    if x:
        assert r.x.numpy().tobytes() == want[1]


# ---------------------------------------------------------------------------
# the journal (tests/test_engine_journal.py)
# ---------------------------------------------------------------------------
def test_journal_records_inputs_and_bases_compact(tmp_path):
    eng = _engine(lanes=2, checkpoint_dir=tmp_path, journal_every=100,
                  max_fuse=1)
    ids = eng.submit_many(_mixed_specs(4))
    st = eng.ckpt.journal_stats()
    assert st["records"] == 4 and st["last_seq"] == 4
    eng.cancel(ids[3])
    assert eng.ckpt.journal_stats()["records"] == 5
    eng.run()
    assert eng.ckpt.latest_step() is None
    eng.result(ids[0])
    assert eng.ckpt.journal_stats()["records"] == 6
    eng.snapshot()                       # manual base -> compaction
    assert eng.ckpt.journal_stats()["records"] == 0
    assert eng.ckpt.journal_last_seq() == 6
    aux = eng.ckpt.aux(eng.ckpt.latest_step())
    assert aux["journal_seq"] == 6 and aux["journal_every"] == 100
    s = SolveService(eng).stats()
    assert s["journal"]["records"] == 0 and s["journal"]["last_seq"] == 6
    assert s["metrics"]["ckpt_journal_lag_records"] == 0


def test_resume_replays_journal_with_no_base_snapshot(tmp_path):
    specs = _mixed_specs(3, seed0=20)
    eng = _engine(lanes=2, checkpoint_dir=tmp_path, journal_every=50)
    ids = eng.submit_many(specs)
    eng.cancel(ids[1])
    del eng                              # killed: no snapshot was ever cut

    res = _resume(tmp_path, lanes=2, journal_every=50)
    assert [res.jobs[j].status for j in ids] == [QUEUED, CANCELLED, QUEUED]
    res.run()
    for spec, jid in ((specs[0], ids[0]), (specs[2], ids[2])):
        solo = abo_minimize(OBJECTIVES[spec.objective], spec.n,
                            config=spec.config, seed=spec.seed, device=CPU)
        got = res.result(jid)
        assert got.fun == solo.fun and torch.equal(got.x, solo.x)
    assert res.submit(specs[0]) == "job-000003"


def test_resume_replays_cancel_and_fetched_marks(tmp_path):
    specs = _mixed_specs(3, seed0=60)
    eng = _engine(lanes=1, checkpoint_dir=tmp_path, journal_every=1,
                  max_fuse=1)
    ids = eng.submit_many(specs)
    eng.step()                           # base at step 1; job 0 running
    eng.cancel(ids[1])                   # post-base: journal-only
    eng.run()
    eng.result(ids[0])                   # delivered after the last base
    del eng

    res = _resume(tmp_path)
    assert res.jobs[ids[1]].status == CANCELLED
    assert res.jobs[ids[0]].fetched
    res.run()
    assert res.jobs[ids[2]].status == DONE


def test_journal_resume_converges_after_retention_eviction(tmp_path):
    eng = _engine(lanes=1, checkpoint_dir=tmp_path, journal_every=1,
                  retain_done=0)
    jid = eng.submit(JobSpec("sphere", 64, CFG, seed=5))
    eng.run()
    eng.result(jid)                      # delivered -> evicted + journaled
    assert jid not in eng.jobs
    del eng

    res = _resume(tmp_path)
    assert jid not in res.jobs
    assert not res.pending()


def test_journal_resume_bit_identical_including_chunk_boundary(tmp_path):
    """A kill after a base with lanes mid-flight and journal-only
    submissions: every job equals the uninterrupted run bit for bit,
    including an n whose gathered row view crosses 1 MiB of coordinates."""
    big = ABOConfig(samples_per_pass=7, n_passes=2)
    specs = [JobSpec("sphere", 1_200_200, big, seed=0),
             JobSpec("sphere", 5_000, big, seed=1),
             JobSpec("sphere", 1_000_000, big, seed=2),
             JobSpec("sphere", 12_000, big, seed=3)]
    want = _uninterrupted(specs)

    eng = _engine(lanes=2, checkpoint_dir=tmp_path, journal_every=1,
                  max_fuse=1)
    ids = eng.submit_many(specs[:2])
    eng.step()                           # base at step 1: lanes mid-flight
    ids += eng.submit_many(specs[2:])    # post-base: journal-only
    del eng

    res = _resume(tmp_path)
    assert res.active_lanes == 2
    assert sum(res.jobs[j].status == QUEUED for j in ids) == 2
    res.run()
    for i, jid in enumerate(ids):
        _same(res.jobs[jid], want[i])


def test_legacy_resume_ignores_stale_journal(tmp_path):
    eng = _engine(lanes=1, checkpoint_dir=tmp_path, journal_every=50)
    eng.submit_many([JobSpec("sphere", 64, CFG, seed=1),
                     JobSpec("sphere", 64, CFG, seed=2)])  # journal-only
    del eng

    leg = _engine(lanes=1, checkpoint_dir=tmp_path)        # legacy mode
    jid = leg.submit(JobSpec("sphere", 96, CFG, seed=3))
    leg.run()
    del leg

    res = _resume(tmp_path)
    assert res.journal_every is None
    assert len(res.jobs) == 1
    assert res.jobs[jid].status == DONE and not res.pending()


# ---------------------------------------------------------------------------
# faults and the kill matrix (tests/test_engine_faults.py)
# ---------------------------------------------------------------------------
def test_failed_survives_snapshot_and_resume(tmp_path):
    ck = tmp_path / "ck"
    eng = _engine(lanes=2, checkpoint_dir=str(ck),
                  faults="objective_eval:every=2:seed=1")
    ids = eng.submit_many(_mixed_specs(4))
    eng.run()
    eng.snapshot()
    failed = [j for j in ids if eng.jobs[j].status == FAILED]
    assert len(failed) == 2

    res = _resume(str(ck))
    assert not res.faults.enabled
    for jid in ids:
        assert res.jobs[jid].status == eng.jobs[jid].status
    for jid in failed:
        assert "non-finite" in res.jobs[jid].error
    assert not res.pending()


def test_failed_set_rederived_on_journal_replay(tmp_path):
    ck = tmp_path / "ck"
    spec = "objective_eval:every=2:seed=1"
    eng = _engine(lanes=2, checkpoint_dir=str(ck), journal_every=50,
                  faults=spec)
    ids = eng.submit_many(_mixed_specs(4))
    eng.run()
    before = {j: eng.jobs[j].status for j in ids}
    assert sorted(before.values()) == [DONE, DONE, FAILED, FAILED]

    res = _resume(str(ck), journal_every=50, faults=spec)
    res.run()
    assert {j: res.jobs[j].status for j in ids} == before


def test_ttl_expiry_and_replay(tmp_path):
    ck = tmp_path / "ck"
    eng = _engine(lanes=2, checkpoint_dir=str(ck), journal_every=50)
    spec = _mixed_specs(2)
    jid_ttl = eng.submit(JobSpec(spec[0].objective, spec[0].n, CFG,
                                 seed=7, ttl_s=0.01))
    jid_ok = eng.submit(spec[1])
    time.sleep(0.05)
    eng.run()
    rec = eng.jobs[jid_ttl]
    assert rec.status == FAILED and "ttl expired" in rec.error
    assert eng.jobs[jid_ok].status == DONE
    assert eng.stats()["engine_jobs_failed_total"] == 1

    res = _resume(str(ck), journal_every=50)
    assert res.jobs[jid_ttl].status == FAILED
    assert "ttl expired" in res.jobs[jid_ttl].error
    assert res.jobs[jid_ok].status == QUEUED
    res.run()
    assert res.jobs[jid_ok].status == DONE


_KILL_CHILD = """
    from repro_torch.core import ABOConfig
    from repro_torch.engine import JobSpec, SolveEngine

    CFG = ABOConfig(samples_per_pass=12, n_passes=3)
    shapes = [("griewank", 64), ("sphere", 96), ("rastrigin", 80)]
    specs = [JobSpec(o, n, CFG, seed=i) for i, (o, n) in enumerate(shapes)]
    eng = SolveEngine(lanes=2, checkpoint_dir={ck!r}, {engine_kw}
                      faults={faults!r}, device="cpu")
    for s in specs:
        eng.submit(s)
    eng.run()
    raise SystemExit("fault never fired")   # the kill should preempt this
"""


def _run_child(script: str, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def _kill_reference():
    """The kill children's jobs (seed i over SHAPES), uninterrupted."""
    return _uninterrupted([JobSpec(o, n, CFG, seed=i)
                           for i, (o, n) in enumerate(SHAPES)])


def test_kill_matrix_snapshot_write(tmp_path):
    ck = str(tmp_path / "ck")
    out = _run_child(_KILL_CHILD.format(
        ck=ck, engine_kw="", faults="snapshot_write:kind=kill:nth=2"))
    assert out.returncode == 137, (out.returncode, out.stderr[-2000:])

    report = fsck(ck)
    assert not report["ok"]
    assert {f["kind"] for f in report["findings"]} == {"tmp_snapshot"}
    assert fsck(ck, repair=True)["ok"]
    assert fsck(ck)["ok"] and not fsck(ck)["findings"]

    res = _resume(ck)
    assert res.pending()                 # killed mid-flight: work left
    res.run()
    for i, want in _kill_reference().items():
        _same(res.jobs[f"job-{i:06d}"], want)


def test_kill_matrix_journal_append(tmp_path):
    ck = str(tmp_path / "ck")
    out = _run_child(_KILL_CHILD.format(
        ck=ck, engine_kw="journal_every=50,",
        faults="journal_append:kind=kill:nth=3"))
    assert out.returncode == 137, (out.returncode, out.stderr[-2000:])

    report = fsck(ck)
    assert {f["kind"] for f in report["findings"]} == {"torn_tail"}, report
    assert fsck(ck, repair=True)["ok"]

    res = _resume(ck, journal_every=50)
    replayed = sorted(res.jobs)
    assert replayed == ["job-000000", "job-000001"]
    res.run()
    want = _kill_reference()
    for i, jid in enumerate(replayed):
        _same(res.jobs[jid], want[i])


def test_fsck_journal_repairs(tmp_path):
    jdir = tmp_path / "journal"
    jdir.mkdir()

    def rec(seq):
        return json.dumps({"seq": seq, "kind": "submit",
                           "job_id": f"job-{seq:06d}"}) + "\n"

    seg0 = jdir / "seg_00000000.jsonl"
    seg1 = jdir / "seg_00000001.jsonl"
    seg0.write_text(rec(1) + rec(2) + rec(3))
    seg1.write_text(rec(4) + rec(5)[: len(rec(5)) // 2])  # torn tail
    (jdir / "SEQ").write_text("not-a-number")

    report = fsck(tmp_path)
    assert {f["kind"] for f in report["findings"]} == \
        {"torn_tail", "bad_seq_floor"}
    assert not report["ok"]
    assert fsck(tmp_path, repair=True)["ok"]
    assert seg1.read_text() == rec(4)
    assert (jdir / "SEQ").read_text() == "4"
    assert fsck(tmp_path)["ok"]

    seg0.write_text(rec(1) + rec(2) + rec(9) + rec(10))
    seg1.write_text(rec(11))
    report = fsck(tmp_path, repair=True)
    assert {f["kind"] for f in report["findings"]} == {"seq_gap"}
    assert report["dropped_records"] == 2
    assert seg0.read_text() == rec(1) + rec(2)
    assert not seg1.exists()
    assert fsck(tmp_path)["ok"]


def test_fsck_base_repairs_and_exit_codes(tmp_path, capsys):
    tmp = tmp_path / "step_000004.tmp"
    tmp.mkdir()
    (tmp / "leaf_00000.npy").write_bytes(b"partial")
    torn = tmp_path / "step_000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{not json")

    assert fsck_main([str(tmp_path)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert {f["kind"] for f in report["findings"]} == \
        {"tmp_snapshot", "torn_base"}
    assert fsck_main([str(tmp_path), "--repair"]) == 0
    capsys.readouterr()
    assert not tmp.exists() and not torn.exists()
    assert fsck_main([str(tmp_path)]) == 0


def test_fsck_accepts_committed_snapshot(tmp_path):
    eng = _engine(lanes=2, checkpoint_dir=str(tmp_path), journal_every=50)
    eng.submit_many(_mixed_specs(2))
    eng.run()
    eng.snapshot()
    report = fsck(tmp_path)
    assert report["ok"] and not report["findings"]


def test_sigterm_batch_mode_clean_shutdown(tmp_path):
    """SIGTERM to a batch solve_server stops at the next step boundary,
    cuts a final snapshot and exits 0; the directory resumes, and the
    resumed jobs equal the uninterrupted run."""
    ck = str(tmp_path / "ck")
    argv = ["--jobs", "16", "--lanes", "2", "--n", "900,1100",
            "--samples", "40", "--passes", "6", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.solve_server", *argv,
         "--ckpt-dir", ck, "--journal-every", "4"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # into the drain: the snapshot cut at submit is on disk
    deadline = time.time() + 60
    while not list(pathlib.Path(ck).glob("step_*")) \
            and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    assert fsck(ck)["ok"], fsck(ck)
    res = _resume(ck, journal_every=4)
    assert len(res.jobs) == 16
    assert "stopping after this step" in out, out
    assert "final snapshot cut" in out
    assert res.pending()                 # interrupted mid-drain
    res.run()
    from repro_torch.launch.solve_server import _mixed_specs as server_specs
    specs = server_specs(16, ["griewank", "sphere", "rastrigin"],
                         [900, 1100], ABOConfig(samples_per_pass=40,
                                                n_passes=6))
    want = _uninterrupted(specs)
    for i in range(16):
        # x is kept only for results the snapshots still hold
        rec = res.jobs[f"job-{i:06d}"]
        _same(rec, want[i], x=rec.x is not None)


# ---------------------------------------------------------------------------
# the formats against the JAX engine
# ---------------------------------------------------------------------------
FMT_CFG = dict(samples_per_pass=7, n_passes=4, block_size=64)
FMT_SHAPES = [("sphere", 300), ("griewank", 130), ("sphere", 700),
              ("rastrigin", 64), ("sphere", 90)]
JOB_TIMES = ("t_submit", "t_place", "t_done", "t_fetch")


def _fmt_run(E, A, root, steps):
    cfg = A.ABOConfig(**FMT_CFG)
    kw = dict(device=CPU) if E is not JE else {}
    eng = E.SolveEngine(lanes=3, checkpoint_dir=str(root), journal_every=1,
                        max_fuse=1, **kw)
    ids = eng.submit_many([E.JobSpec(o, n, cfg, seed=i)
                           for i, (o, n) in enumerate(FMT_SHAPES)])
    eng.cancel(ids[3])
    for _ in range(steps):
        eng.step()
    eng.snapshot()
    step = eng.ckpt.latest_step()
    aux = eng.ckpt.aux(step)
    for rec in aux["jobs"].values():
        for k in JOB_TIMES:
            rec.pop(k, None)
    manifest = json.loads(
        (root / f"step_{step:012d}" / "manifest.json").read_text())
    journal = {p.name: p.read_bytes()
               for p in sorted((root / "journal").glob("*"))}
    return aux, {k: manifest[k] for k in ("n_leaves", "shapes", "dtypes")}, \
        journal


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_aux_and_journal_match_jax_engine(tmp_path, steps):
    t_aux, t_man, t_jr = _fmt_run(TE, TA, tmp_path / "t", steps)
    j_aux, j_man, j_jr = _fmt_run(JE, JA, tmp_path / "j", steps)
    assert t_aux["step_count"] == steps
    for key in sorted(j_aux):
        if key != "jobs":
            assert t_aux[key] == j_aux[key], key
    assert sorted(t_aux) == sorted(j_aux)
    assert t_aux["jobs"] == j_aux["jobs"]
    assert t_man == j_man
    assert t_jr == j_jr
    assert any(pt for p in t_aux["pools"] for pt in p["page_table"]) \
        == (steps > 0)


def test_float64_family_resumes_bit_identical(tmp_path):
    cfg = ABOConfig(samples_per_pass=9, n_passes=4, block_size=128)
    specs = [JobSpec("griewank", 1000, cfg, seed=4),
             JobSpec("rastrigin", 700, cfg, seed=5),
             JobSpec("sphere", 300, cfg)]
    want = _uninterrupted(specs, dtype=torch.float64)
    eng = _engine(lanes=2, checkpoint_dir=tmp_path, max_fuse=1,
                  dtype=torch.float64)
    ids = eng.submit_many(specs)
    eng.step()
    eng.step()                           # snapshot at step 2, mid-flight
    del eng
    res = _resume(tmp_path)
    assert res.dtype == torch.float64 and res.pending()
    pool = next(iter(res.pools.values()))
    assert pool.state.aggs.dtype == torch.float64
    res.run()
    for i, jid in enumerate(ids):
        _same(res.jobs[jid], want[i])
        assert res.jobs[jid].result().history.dtype == torch.float64
    assert np.asarray(res.jobs[ids[0]].x).dtype == np.float64
