"""The port's solve engine inside the port, on the CPU: every job's fun, x
and history equal the port's ``abo_minimize`` bit for bit at any layout
(lane count, slot, pages, row-view rung, fuse depth, a pool relaid out by a
drain and a regrow), the tile sums that make that hold, the job lifecycle
(cancel, admission, quarantine, TTL, retention), the sanitizers, and the
``solve_server`` batch mode.

Small shapes (tests/test_engine.py's style): 7 or 12 candidates, 2-4
passes, blocks of 64-256, so the trajectories do not collapse onto exact
grid points and an ulp anywhere shows.
"""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis import (CompileBudgetExceeded, DonationError,
                                  HostSyncError, assert_donated,
                                  compile_guard, storage_ptrs, sync_guard)
from repro_torch.core.abo import ABOConfig, abo_minimize
from repro_torch.engine import (CANCELLED, DONE, FAILED, QUEUED, RUNNING,
                                JobSpec, MemoryBudgetError, QueueFullError,
                                SolveEngine, SolveService, batched)
from repro_torch.launch import solve_server
from repro_torch.objectives import OBJECTIVES

CPU = "cpu"
M7 = ABOConfig(samples_per_pass=7, n_passes=2, block_size=64)
M12 = ABOConfig(samples_per_pass=12, n_passes=3, block_size=256)
SPAN = ABOConfig(samples_per_pass=7, n_passes=3, block_size=128,
                 span_coords=512)


def _solo(spec):
    return abo_minimize(OBJECTIVES[spec.objective], spec.n,
                        config=spec.config, seed=spec.seed, x0=spec.x0,
                        device=CPU)


def _assert_solo(eng, specs, ids):
    """Each job's fun, x and history are abo_minimize's; a job whose solo
    fun is not finite was quarantined instead."""
    for spec, jid in zip(specs, ids):
        want = _solo(spec)
        if not np.isfinite(want.fun):
            assert eng.jobs[jid].status == FAILED, (spec, want.fun)
            continue
        got = eng.result(jid)
        assert got.fun == want.fun, (spec, got.fun, want.fun)
        assert torch.equal(got.x, want.x)
        assert torch.equal(got.history, want.history)
        assert got.fe == want.fe and got.n == want.n


def _mixed(cfg, seed0=0):
    shapes = [("griewank", 700), ("shifted_sphere", 3000), ("rastrigin", 1500),
              ("schwefel_2_22", 500), ("sphere", 4096 * 3 + 5),
              ("griewank", 100)]
    return [JobSpec(name, n, cfg, seed=seed0 + i)
            for i, (name, n) in enumerate(shapes)]


# ---------------------------------------------------------------------------
# the tile sum and the row aggregates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_tile_sum_does_not_depend_on_the_slab(name):
    obj = OBJECTIVES[name]
    tile, t_idx = obj.REDUCE_TILE, 1000
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(tile, generator=g) * 2 - 1) * obj.upper
    want = obj._tile_sums(x.view(1, tile), t_idx, 10**9, torch.float32)[0]
    for rows in (1, 2, 3, 17, 256):
        slab = (torch.rand((rows, tile), generator=g) * 2 - 1) * obj.upper
        slab[rows // 2] = x
        got = obj._tile_sums(slab, t_idx - rows // 2, 10**9,
                             torch.float32)[rows // 2]
        assert torch.equal(got, want), (name, rows)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_row_aggregates_equal_aggregates(name):
    obj = OBJECTIVES[name]
    ns = [1, 100, 4096, 3 * 4096 + 5, 2**20 + 4096 + 3]
    width = 2**20 + 4096 * 3
    g = torch.Generator().manual_seed(1)
    rows = torch.zeros((len(ns), width))
    for i, n in enumerate(ns):
        rows[i, :n] = (torch.rand(n, generator=g) * 2 - 1) * obj.upper
    got = obj.row_aggregates(rows, torch.tensor(ns))
    for i, n in enumerate(ns):
        assert torch.equal(got[i], obj.aggregates(rows[i, :n].clone(), n))


# ---------------------------------------------------------------------------
# bit-identical to abo_minimize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [M7, M12, SPAN], ids=["m7", "m12", "span"])
def test_engine_matches_abo_minimize(cfg):
    """Mixed objectives and n in one engine: ragged tail tiles, tiny n
    (exact Gauss-Seidel, block 1), Schwefel 2.22 with padding in its last
    block, and a span_coords config."""
    specs = _mixed(cfg)
    eng = SolveEngine(lanes=4, device=CPU)
    ids = eng.submit_many(specs)
    assert eng.run() == len(specs)
    _assert_solo(eng, specs, ids)


def test_golden_x0_and_seeded_starts_share_a_pool():
    specs = [JobSpec("griewank", 900, M7),
             JobSpec("griewank", 700, M7, seed=2**40 + 3),
             JobSpec("griewank", 640, M7,
                     x0=tuple(np.linspace(-300.0, 300.0, 640).tolist())),
             JobSpec("griewank", 1000, M7, seed=-7)]
    eng = SolveEngine(lanes=4, device=CPU)
    ids = eng.submit_many(specs)
    eng.run()
    assert len(eng.family_keys_seen) == 1
    _assert_solo(eng, specs, ids)


def test_layouts_are_bit_identical():
    """One lane, four lanes, strict pass-per-step stepping and a
    different admission order all give each job the same bits."""
    specs = _mixed(M12, seed0=20)
    runs = []
    for lanes, fuse, order in ((1, None, 1), (4, None, 1), (3, 1, -1)):
        eng = SolveEngine(lanes=lanes, max_fuse=fuse, device=CPU)
        ids = eng.submit_many(specs[::order])[::order]
        eng.run()
        runs.append([eng.result(j) for j in ids])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert a.fun == b.fun and torch.equal(a.x, b.x)


def test_chunk_boundary_and_mixed_row_view_rungs():
    """A lane across the 1 Mi chunk boundary and a small lane syncing in
    the same group, so the small one's re-sync gathers at the big lane's
    rung (tests/test_engine_journal.py's regression)."""
    big = ABOConfig(samples_per_pass=7, n_passes=2)
    specs = [JobSpec("sphere", 2**20 + 4096 * 20 + 13, big, seed=10),
             JobSpec("sphere", 3000, big, seed=11)]
    eng = SolveEngine(lanes=2, device=CPU)
    ids = eng.submit_many(specs)
    eng.run()
    assert len(eng.pools) == 1
    _assert_solo(eng, specs, ids)


def test_drain_and_regrow_relays_the_pool_without_new_shapes():
    """A burst drains, the pool shrinks to its smallest rung, and the same
    burst regrows it through the shapes it built the first time; the jobs
    placed on the relaid pool still match abo_minimize."""
    def burst(seed0):
        return [JobSpec("rastrigin", (300, 350, 440, 460)[i % 4], M7,
                        seed=seed0 + i) for i in range(12)]

    eng = SolveEngine(lanes=4, device=CPU)
    eng.submit_many(burst(0))
    peak = 0
    while eng.pending():
        eng.step()
        peak = max(peak, eng.memory_stats()["pool_device_bytes"])
    (pool,) = eng.pools.values()
    assert pool.capacity == 1 and pool.slots == 1
    assert eng.memory_stats()["pool_device_bytes"] < peak
    shapes = batched.compiled_executable_count(eng.family_keys_seen)
    with compile_guard(0, "regrow"):
        ids = eng.submit_many(burst(100))
        eng.run()
    assert batched.compiled_executable_count(eng.family_keys_seen) == shapes
    _assert_solo(eng, burst(100), ids)
    assert not pool.state.pool[batched.SCRATCH_PAGE].any()


def test_plan_bands_and_waste():
    eng = SolveEngine(lanes=4, max_fuse=1, device=CPU)
    eng.submit_many(JobSpec("rastrigin", n, M7, seed=i)
                    for i, n in enumerate((300, 350, 440, 460)))
    eng.step()
    (pool,) = eng.pools.values()
    assert [(r.w, r.n_rows) for r in pool.plan.runs] == \
        [(4, 5), (3, 1), (2, 1), (1, 1)]
    assert pool.plan.live_slots == pool.plan.swept_slots == 26
    assert eng.pad_stats()["swept_waste"] == 0.0
    assert eng.row_steps == 8


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_cancel_queued_and_running():
    specs = [JobSpec("sphere", 400 + i, M12, seed=i) for i in range(4)]
    eng = SolveEngine(lanes=2, max_fuse=1, device=CPU)
    ids = eng.submit_many(specs)
    assert eng.cancel(ids[3]) and eng.jobs[ids[3]].status == CANCELLED
    assert ids[3] not in eng.queue
    eng.step()
    assert eng.jobs[ids[0]].status == RUNNING
    assert eng.cancel(ids[0]) and eng.jobs[ids[0]].status == CANCELLED
    eng.run()
    assert not eng.cancel(ids[1])                    # already done
    _assert_solo(eng, specs[1:3], ids[1:3])
    with pytest.raises(RuntimeError):
        eng.result(ids[0])


def test_admission_control():
    eng = SolveEngine(lanes=1, max_queue=2, device=CPU)
    eng.submit(JobSpec("sphere", 100, M7))
    eng.submit(JobSpec("sphere", 100, M7))
    with pytest.raises(QueueFullError):
        eng.submit(JobSpec("sphere", 100, M7))
    one = eng._projected_job_bytes(JobSpec("sphere", 1000, M7))
    assert one == 16 * 64 * 4 + (1 + 2) * 4 + 8
    eng = SolveEngine(lanes=1, memory_budget_bytes=2 * one, device=CPU)
    eng.submit(JobSpec("sphere", 1000, M7))
    eng.submit(JobSpec("sphere", 1000, M7))
    with pytest.raises(MemoryBudgetError):
        eng.submit(JobSpec("sphere", 1000, M7))
    assert eng.stats()[
        'engine_admission_rejected_total{reason="memory_budget"}'] == 1


def test_quarantine_leaves_siblings_bit_identical():
    specs = [JobSpec("griewank", 500 + 50 * i, M7, seed=i) for i in range(8)]
    eng = SolveEngine(lanes=3, faults="objective_eval:every=3:seed=7",
                      device=CPU)
    ids = eng.submit_many(specs)
    assert eng.run() == len(specs)
    failed = [j for j in ids if eng.jobs[j].status == FAILED]
    assert failed == [ids[2], ids[5]]
    assert "non-finite" in eng.jobs[failed[0]].error
    ok = [(s, j) for s, j in zip(specs, ids) if j not in failed]
    _assert_solo(eng, *zip(*ok))
    assert eng.stats()["engine_jobs_failed_total"] == 2
    assert eng.stats()[
        'engine_faults_injected_total{site="objective_eval"}'] == 2


def test_ttl_expiry_and_retain_done():
    eng = SolveEngine(lanes=1, retain_done=1, device=CPU)
    a = eng.submit(JobSpec("sphere", 200, M7, seed=0))
    b = eng.submit(JobSpec("sphere", 200, M7, seed=1, ttl_s=1e-9))
    c = eng.submit(JobSpec("sphere", 200, M7, seed=2))
    eng.run()
    assert eng.jobs[b].status == FAILED and "ttl" in eng.jobs[b].error
    assert eng.jobs[a].status == eng.jobs[c].status == DONE
    eng.result(a)                    # delivered: now evictable, and the
    assert a not in eng.jobs and b in eng.jobs   # oldest finish goes first
    eng.result(c)
    assert set(eng.jobs) == {c}


def test_fault_at_fused_step_leaves_the_state_whole():
    eng = SolveEngine(lanes=2, faults="fused_step:nth=1", device=CPU)
    jid = eng.submit(JobSpec("sphere", 300, M7, seed=3))
    with pytest.raises(RuntimeError, match="fused_step"):
        eng.step()
    eng.run()
    _assert_solo(eng, [JobSpec("sphere", 300, M7, seed=3)], [jid])


def test_what_is_not_ported_raises():
    for kw, item in ((dict(devices=2), "item 10"),
                     (dict(span_pages=4), "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            SolveEngine(device=CPU, **kw)
    # checkpointing is ported: its misuse is a ValueError, as in the
    # reference
    for kw in (dict(journal_every=2), dict(journal_every=0,
                                           checkpoint_dir="ckpt")):
        with pytest.raises(ValueError, match="journal_every"):
            SolveEngine(device=CPU, **kw)
    eng = SolveEngine(device=CPU)
    with pytest.raises(ValueError, match="use_kernel"):
        eng.submit(JobSpec("griewank", 5000, ABOConfig(use_kernel=True)))
    with pytest.raises(KeyError):
        eng.submit(JobSpec("nosuch", 10))
    with pytest.raises(ValueError):
        SolveEngine(lanes=0, device=CPU)


def test_service_round_trip():
    svc = SolveService(lanes=2, device=CPU)
    sub = svc.submit({"objective": "sphere", "n": 300, "seed": 4,
                      "config": dataclasses.asdict(M7)})
    assert sub == {"job_id": "job-000000", "status": QUEUED}
    assert svc.result(sub["job_id"])["code"] == "not_done"
    svc.drain()
    out = svc.result(sub["job_id"])
    want = _solo(JobSpec("sphere", 300, M7, seed=4))
    assert out["fun"] == want.fun and out["x"] == want.x.double().tolist()
    assert svc.poll("job-999999")["code"] == "unknown_job"
    json.dumps(svc.stats())


# ---------------------------------------------------------------------------
# sanitizers
# ---------------------------------------------------------------------------
def test_sanitized_engine_matches_and_guards():
    specs = _mixed(M7, seed0=40)
    plain, sane = (SolveEngine(lanes=3, device=CPU),
                   SolveEngine(lanes=3, sanitize=True, device=CPU))
    a, b = plain.submit_many(specs), sane.submit_many(specs)
    plain.run()
    sane.run()
    for x, y in zip(a, b):
        assert plain.jobs[x].fun == sane.jobs[y].fun
        assert plain.jobs[x].status == sane.jobs[y].status
    t = torch.ones(3)
    for sync in (lambda: t.sum().item(), lambda: float(t[0]),
                 lambda: t.tolist(), lambda: np.asarray(t),
                 lambda: bool(t[0])):
        with pytest.raises(HostSyncError):
            with sync_guard():
                sync()
    assert t.sum().item() == 3.0                     # lifted afterwards


def test_steady_state_steps_do_not_sync():
    eng = SolveEngine(lanes=2, max_fuse=1, device=CPU)
    eng.submit_many(_mixed(M12)[:2])
    eng.step()
    with sync_guard():
        eng.step()                                   # pass 2: steady state
    eng.run()


def test_assert_donated_and_compile_guard():
    state = batched.zeros_pool_state(OBJECTIVES["sphere"],
                                     batched.family_key("sphere", 1000, M7),
                                     2, 4, CPU)
    before = storage_ptrs(state.tensors())
    state.pool.index_copy_(0, torch.tensor([1]), torch.ones(1, 64))
    assert assert_donated(before, state.tensors()) == 5
    grown = batched.resize_pool_state(state, 2, 8)
    with pytest.raises(DonationError):
        assert_donated(before, grown.tensors())
    key = ("budget", M7, "float32")
    fresh = batched.zeros_pool_state(OBJECTIVES["sphere"], key, 1, 2, CPU)
    ops = batched.get_pool_ops(OBJECTIVES["sphere"], key, CPU)
    with pytest.raises(CompileBudgetExceeded):
        with compile_guard(0):
            ops.place(fresh, [(0, [1], 0, 50)])


# ---------------------------------------------------------------------------
# solve_server batch mode
# ---------------------------------------------------------------------------
SUMMARY = re.compile(
    r"^\[solve_server\] (\d+) jobs in [\d.]+s over (\d+) steps \((\d+) "
    r"executable families, [\d.]+% swept-row waste\): [\d.]+ jobs/s, "
    r"\S+ probe-FE/s$", re.M)


def test_solve_server_batch_summary(tmp_path, capsys):
    stats, eng = solve_server.run(
        ["--jobs", "6", "--lanes", "2", "--n", "300,700", "--samples", "7",
         "--passes", "2", "--block", "64", "--device", "cpu", "--sanitize",
         "--compile-budget", "60", "--metrics-out", str(tmp_path / "m.prom"),
         "--trace", str(tmp_path / "t.json"),
         "--inject", "objective_eval:nth=2"])
    out = capsys.readouterr().out
    m = SUMMARY.search(out)
    assert m and m.groups() == ("6", str(stats["steps"]), "3"), out
    assert stats["done"] == 6 and stats["devices"] == 1
    assert sum(r.status == FAILED for r in eng.jobs.values()) == 1
    assert "engine_jobs_done_total 5" in (tmp_path / "m.prom").read_text()
    spans = {e["name"] for e in
             json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"step", "refill", "plan_build", "fused_sweep", "harvest",
            "resize"} <= spans
    for rec in eng.jobs.values():
        if rec.status == DONE:
            assert rec.fun == _solo(rec.spec).fun


# The flags that are not ported exit 2 with "not ported"; the checkpoint
# and serving flags, ported since, exit 2 with the reference's usage
# errors when misused (each keeps its case's place in the list).
FLAG_ERRORS = {"--ckpt-dir": "--journal-every must be >= 1",
               "--resume": "--resume requires --ckpt-dir",
               "--journal-every": "--journal-every requires --ckpt-dir",
               "--http": "--max-body must be >= 1",
               "--workers": "--workers requires --http"}


@pytest.mark.parametrize("flag", [["--http", "0", "--max-body", "0"],
                                  ["--workers", "2"],
                                  ["--ckpt-dir", "d", "--journal-every", "0"],
                                  ["--resume"], ["--journal-every", "2"],
                                  ["--devices", "2"], ["--span", "8"]])
def test_solve_server_flags_not_ported_exit_nonzero(flag, capsys):
    with pytest.raises(SystemExit) as e:
        solve_server.main(flag + ["--device", "cpu"])
    assert e.value.code == 2
    assert FLAG_ERRORS.get(flag[0], "not ported") in capsys.readouterr().err
