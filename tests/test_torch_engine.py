"""The port's solve engine (repro_torch.engine) against the JAX package's,
on the CPU.

Bit-exact where the reference is integer or bit logic: the count ladder,
page counts and family keys, the sweep plan's band and sync tables for the
same page tables, the job JSON, the fault schedules, the admission byte
projection, the stats() key set and the service's payload keys and error
codes. Within the pinned solve tolerances of tests/test_torch_abo.py where
transcendentals are involved: the two engines solving the same specs.

Shapes stay small (tests/test_engine.py's style): each JAX engine compiles
its own executables.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core.abo as JA
import repro.engine as JE
import repro.engine.batched as JB
import repro.engine.faults as JF
import repro.engine.scheduler as JS
import repro.objectives as J
import repro_torch.core.abo as TA
import repro_torch.engine as TE
import repro_torch.engine.batched as TB
import repro_torch.engine.faults as TF
import repro_torch.engine.scheduler as TS
import repro_torch.objectives as T

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# integer and plan logic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block", [1, 7, 64, 4096])
def test_pad_ladder_and_pages_match_reference(block):
    ns = sorted({1, 2, 3, 5, 63, 64, 65, 383, 384, 385, 4095, 4096, 4097,
                 10**5, 10**6, 2**20 + 1, 4 * 10**6, 10**9}
                | set(range(1, 300, 7)))
    for n in ns:
        for waste in (0.35, 0.2, 0.0):
            assert TB.pad_ladder(n, block, waste) == \
                JB.pad_ladder(n, block, waste), (n, block, waste)
        assert TB.pages_for(n, block) == JB.pages_for(n, block)


@pytest.mark.parametrize("kw", [dict(), dict(samples_per_pass=12, n_passes=3),
                                dict(block_size=64, span_coords=256),
                                dict(coupling_schedule="none")])
def test_family_key_matches_reference(kw):
    for n in (2, 100, 128, 129, 700, 10**6):
        for name in ("griewank", "sphere"):
            tk = TB.family_key(name, n, TA.ABOConfig(**kw))
            jk = JB.family_key(name, n, JA.ABOConfig(**kw))
            assert (tk[0], dataclasses.asdict(tk[1]), tk[2]) == \
                (jk[0], dataclasses.asdict(jk[1]), jk[2])


def _page_tables(case):
    """(slots, job ids, page tables) for a plan scenario."""
    rng = np.random.RandomState(case)
    if case == 0:            # four mixed depths (tests/test_engine_packing)
        depths = [5, 6, 7, 8]
    elif case == 1:          # five equal lanes: width 5 pads to rung 6
        depths = [5, None, 5, 5, 5, 5]
    elif case == 2:          # one lane, one page
        depths = [1]
    else:                    # idle slots and random depths
        depths = [None if rng.rand() < 0.25 else int(rng.randint(1, 40))
                  for _ in range(8)]
    free = list(rng.permutation(np.arange(1, 1 + sum(d or 0
                                                     for d in depths))))
    jobs, tables = [], []
    for i, d in enumerate(depths):
        jobs.append(None if d is None else f"job-{i:06d}")
        tables.append(None if d is None else [int(free.pop()) for _ in
                                              range(d)])
    return len(depths), jobs, tables


@pytest.mark.parametrize("case", range(6))
def test_plan_tables_match_reference(case):
    slots, jobs, tables = _page_tables(case)
    cfg = dict(samples_per_pass=12, n_passes=3, block_size=64)
    jk = JB.family_key("rastrigin", 700, JA.ABOConfig(**cfg))
    tk = TB.family_key("rastrigin", 700, TA.ABOConfig(**cfg))
    jp = JS.LanePool(key=jk, obj=J.RASTRIGIN, lanes=slots, slots=slots,
                     job_ids=list(jobs), page_table=list(tables)).build_plan()
    tp = TS.LanePool(key=tk, obj=T.RASTRIGIN, lanes=slots, device=CPU,
                     slots=slots, job_ids=list(jobs),
                     page_table=list(tables)).build_plan()
    assert len(tp.runs) == len(jp.runs)
    for t, j in zip(tp.runs, jp.runs):
        assert (t.w, t.r_cap, t.n_rows, t.live_slots, t.swept_slots) == \
            (j.w, j.r_cap, int(j.n_rows), j.live_slots, j.swept_slots)
        for name in ("lanes", "pages", "rows"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))
    assert (tp.sync.g, tp.sync.v) == (jp.sync.g, jp.sync.v)
    np.testing.assert_array_equal(tp.sync.lanes.numpy(),
                                  np.asarray(jp.sync.lanes))
    np.testing.assert_array_equal(tp.sync.pages.numpy(),
                                  np.asarray(jp.sync.pages))
    assert (tp.live_slots, tp.swept_slots, tp.pass_bytes) == \
        (jp.live_slots, jp.swept_slots, jp.pass_bytes)
    assert tp.signature() == jp.signature()[:2]


def test_pool_growth_and_shrink_match_reference():
    """The same admissions and releases move capacity, slots and the free
    list the same way in both packages."""
    jk = JB.family_key("sphere", 1000, JA.ABOConfig(block_size=64))
    tk = TB.family_key("sphere", 1000, TA.ABOConfig(block_size=64))
    jp = JS.LanePool(key=jk, obj=J.SPHERE, lanes=8)
    tp = TS.LanePool(key=tk, obj=T.SPHERE, lanes=8, device=CPU)
    for depth in (5, 9, 2, 17, 3):
        js, ts = jp.take_slot(), tp.take_slot()
        assert js == ts and jp.slots == tp.slots
        jp.job_ids[js] = tp.job_ids[ts] = "job"
        jp.page_table[js] = jp.alloc_pages(depth)
        tp.page_table[ts] = tp.alloc_pages(depth)
        assert tp.page_table[ts] == jp.page_table[js]
        assert tp.capacity == jp.capacity
    jp.materialize()
    tp.materialize()
    for slot in (3, 1, 4):
        jp.release_pages(jp.page_table[slot])
        tp.release_pages(tp.page_table[slot])
        jp.job_ids[slot] = tp.job_ids[slot] = None
        jp.page_table[slot] = tp.page_table[slot] = None
    assert jp.shrink_to_fit() == tp.shrink_to_fit()
    assert (tp.slots, tp.capacity, tp.free_pages) == \
        (jp.slots, jp.capacity, jp.free_pages[0])
    assert tuple(tp.state.pool.shape) == tuple(jp.state.pool.shape)
    assert tuple(tp.state.aggs.shape) == tuple(jp.state.aggs.shape)


# ---------------------------------------------------------------------------
# job JSON, fault schedules, admission bytes
# ---------------------------------------------------------------------------
SPEC_KWS = [
    dict(objective="griewank", n=1000),
    dict(objective="sphere", n=3, seed=7, x0=(0.5, -1.25, 3.0), tag="t"),
    dict(objective="rastrigin", n=4096, seed=2**40 + 3, ttl_s=2.5,
         config=dict(samples_per_pass=7, n_passes=2, block_size=64,
                     shrink=0.3, span_coords=128, guard_commits=False,
                     coupling_schedule="none")),
    dict(objective="schwefel_2_22", n=10**6, seed=-5,
         config=dict(safety=1.5)),
]


def _spec(mod, abo, kw):
    kw = dict(kw)
    if "config" in kw:
        kw["config"] = abo.ABOConfig(**kw["config"])
    return mod.JobSpec(**kw)


@pytest.mark.parametrize("kw", SPEC_KWS)
def test_job_spec_json_matches_reference(kw):
    tj = json.dumps(_spec(TE, TA, kw).to_dict())
    jj = json.dumps(_spec(JE, JA, kw).to_dict())
    assert tj == jj
    # either package reads the other's records
    assert json.dumps(TE.JobSpec.from_dict(json.loads(jj)).to_dict()) == jj
    assert json.dumps(JE.JobSpec.from_dict(json.loads(tj)).to_dict()) == tj


def test_job_constants_match_reference():
    import repro.engine.jobs as JJ
    import repro_torch.engine.jobs as TJ
    for name in ("QUEUED", "RUNNING", "DONE", "CANCELLED", "FAILED",
                 "STATUSES", "J_SUBMIT", "J_CANCEL", "J_FETCHED", "J_EXPIRE"):
        assert getattr(TJ, name) == getattr(JJ, name)
    assert [TJ.next_job_id(i) for i in (0, 7, 123456)] == \
        [JJ.next_job_id(i) for i in (0, 7, 123456)]


@pytest.mark.parametrize("spec", [
    "objective_eval:every=4:seed=7", "objective_eval:prob=0.3:seed=3",
    "fused_step:nth=3", "pool_resize:nth=1;objective_eval:every=2",
    "snapshot_write:nth=2:kind=kill", "slow_client:nth=1:delay_s=0.5", ""])
def test_fault_schedules_match_reference(spec):
    tr, jr = TF.parse_fault_spec(spec), JF.parse_fault_spec(spec)
    assert bool(tr) == bool(jr)
    for site in TF.SITES:
        tf, jf = tr._by_site.get(site), jr._by_site.get(site)
        assert (tf is None) == (jf is None)
        if tf is None:
            continue
        assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
        keys = [f"job-{i:06d}" for i in range(60)] + [None] * 5
        assert [tf.should_fire(k) for k in keys] == \
            [jf.should_fire(k) for k in keys]


@pytest.mark.parametrize("spec", ["nosuchsite:nth=1", "fused_step:nth=1:x=2",
                                  "fused_step:nth", "pool_resize:kind=poison",
                                  "fused_step:nth=1:every=2"])
def test_fault_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as et:
        TF.parse_fault_spec(spec)
    with pytest.raises(ValueError) as ej:
        JF.parse_fault_spec(spec)
    assert str(et.value) == str(ej.value)


def test_projected_job_bytes_match_reference():
    te, je = TE.SolveEngine(lanes=2, device=CPU), JE.SolveEngine(lanes=2)
    for kw in SPEC_KWS:
        kw = {k: v for k, v in kw.items() if k != "x0"}
        kw["n"] = max(kw["n"], 3)
        assert te._projected_job_bytes(_spec(TE, TA, kw)) == \
            je._projected_job_bytes(_spec(JE, JA, kw))


# ---------------------------------------------------------------------------
# both engines on the same specs
# ---------------------------------------------------------------------------
# The quality thresholds of tests/test_torch_abo.py (whole solves, default
# config): Griewank < 1e-6 from the golden start with x identical on >=
# 99.9% of coordinates, < 1e-5 from seeded starts; the suite's < 1e-6
# (shifted sphere 1e-4). Schwefel 2.22 is left out: the reference engine
# zeroes padding coordinates, and its aggregates are NaN there.
SOLVES = [("griewank", 1000, None, 1e-6), ("griewank", 10, None, 1e-6),
          ("griewank", 200, 0, 1e-5), ("griewank", 200, 1, 1e-5),
          ("sphere", 500, None, 1e-6), ("rastrigin", 500, None, 1e-6),
          ("shifted_sphere", 500, None, 1e-4)]


@pytest.fixture(scope="module")
def engines():
    """Both engines after draining SOLVES through 3 lanes."""
    te, je = TE.SolveEngine(lanes=3, device=CPU), JE.SolveEngine(lanes=3)
    tids = te.submit_many(TE.JobSpec(o, n, seed=s) for o, n, s, _ in SOLVES)
    jids = je.submit_many(JE.JobSpec(o, n, seed=s) for o, n, s, _ in SOLVES)
    assert te.run() == je.run() == len(SOLVES)
    return te, je, tids, jids


def test_engine_solves_within_pinned_tolerances_of_jax_engine(engines):
    te, je, tids, jids = engines
    for (name, n, seed, tol), ti, ji in zip(SOLVES, tids, jids):
        rt, rj = te.result(ti), je.result(ji)
        assert rt.fun < tol and rj.fun < tol, (name, n, rt.fun, rj.fun)
        assert rt.fe == rj.fe and rt.n == rj.n == n
        assert tuple(rt.x.shape) == (n,) and len(rt.history) == 5
        if name == "griewank" and seed is None:
            assert (rt.x.numpy() == np.asarray(rj.x)).mean() >= 0.999
    assert te.step_count == je.step_count
    assert te.pad_stats() == je.pad_stats()
    assert te.memory_stats() == je.memory_stats()


def test_stats_keys_match_reference(engines):
    te, je, _, _ = engines
    ts, js = te.stats(), je.stats()
    assert set(ts) == set(js)
    for key in ("engine_steps_total", "engine_passes_total",
                "engine_jobs_done_total", "engine_plan_builds_total",
                "engine_pages_allocated_total", "engine_est_bytes_moved_total",
                "engine_pool_device_bytes", "engine_families_created"):
        assert ts[key] == js[key], key
    assert te.render_prometheus().count("# TYPE") == \
        je.render_prometheus().count("# TYPE")


def test_service_payloads_match_reference():
    cfg = dict(samples_per_pass=8, n_passes=2)
    out = []
    for svc in (TE.SolveService(lanes=1, device=CPU),
                JE.SolveService(lanes=1)):
        calls = [svc.submit({"objective": "sphere", "n": 40, "seed": 1,
                             "config": cfg, "tag": "a"}),
                 svc.submit({"objective": "griewank", "n": 30,
                             "config": cfg})]
        ids = [c["job_id"] for c in calls]
        calls += [svc.poll(ids[0]), svc.result(ids[0]),
                  svc.poll("job-999999"), svc.result("job-999999"),
                  svc.cancel("job-999999"), svc.cancel(ids[1]),
                  svc.result(ids[1])]
        svc.drain()
        calls += [svc.poll(ids[0]), svc.result(ids[0], mark_fetched=False),
                  svc.cancel(ids[0])]
        svc.mark_fetched(ids[0])
        calls.append(svc.stats())
        out.append(calls)
    for t, j in zip(*out):
        assert set(t) == set(j), (t, j)
        for k in ("job_id", "status", "code", "cancelled", "passes_done",
                  "n_passes", "objective", "n", "tag"):
            assert t.get(k) == j.get(k), k
    assert np.asarray(out[0][-3]["x"]).shape == (40,)
