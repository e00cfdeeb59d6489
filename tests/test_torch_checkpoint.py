"""The port's checkpoint manager and fsck (repro_torch.checkpoint), on the
CPU.

The manager cases of tests/test_checkpoint.py on torch tensors (round trip,
rotation, corruption fallback, async save, shape validation, the journal's
roll, truncation, torn tail and corrupt old segment), one more for the
async save's host copy of a tensor updated in place right after it, and
the cross-package contract: the on-disk layout is the JAX package's, so
each package restores the other's snapshots, writes the same journal bytes
for the same records, and each package's fsck gives the same findings and
exit codes on the same damaged directories, before and after repair.
"""
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine.batched as JB
from repro.checkpoint import fsck as jfsck
from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import fsck as tfsck
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import ABOConfig
from repro_torch.engine import JobSpec, SolveEngine, batched
from repro_torch.objectives import OBJECTIVES


def _tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.randint(0, 10, (3,))),
                  "d": [torch.from_numpy(
                      rng.normal(size=(2,)).astype(np.float32))]}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"], tree["b"]["d"][0]]


def test_roundtrip(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(rng)
    mgr.save(7, tree)
    assert mgr.latest_step() == 7
    out = mgr.restore(7, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    meta = {k: v for k, v in json.loads(
        (tmp_path / f"step_{7:012d}" / "manifest.json").read_text()).items()
        if k != "treedef"}
    assert meta == {"step": 7, "n_leaves": 3,
                    "shapes": [[8, 4], [3], [2]],
                    "dtypes": ["float32", "int64", "float32"],
                    "committed": True}


def test_rotation(tmp_path, rng):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree(rng)
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 2 and kept[-1].endswith("4".zfill(12))


def test_corruption_fallback(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(rng)
    mgr.save(1, tree)
    mgr.save(2, tree)
    (tmp_path / f"step_{2:012d}" / "manifest.json").write_text("{")
    assert mgr.latest_step() == 1


def test_async_save(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(rng)
    mgr.save(5, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_async_save_keeps_the_values_at_the_call(tmp_path, rng):
    """On the CPU ``t.cpu()`` is the tensor itself: the host copy must be a
    fresh one, or an in-place update right after a non-blocking save (the
    engine's next step) lands in the leaf being written."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree(rng)
    want = [t.clone() for t in _leaves(tree)]
    mgr.save(3, tree, blocking=False)
    for t in _leaves(tree):
        t.add_(1)                        # in place, as the engine's pools
    mgr.wait()
    out = mgr.restore(3, tree)
    for a, b in zip(want, _leaves(out)):
        assert torch.equal(a, b)


def test_restore_validates_shapes(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(rng)
    mgr.save(1, tree)
    bad = dict(tree, a=torch.zeros((4, 4)))
    with pytest.raises(AssertionError):
        mgr.restore(1, bad)


def test_restore_host_takes_meta_shapes(tmp_path):
    """A ``like`` tree of meta tensors allocates nothing, and the dtypes
    are cast to its."""
    key = batched.family_key("sphere", 1000, ABOConfig(block_size=64))
    state = batched.zeros_pool_state(OBJECTIVES["sphere"], key, 2, 4, "cpu")
    state.pool.normal_()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"p000": state})
    like = {"p000": batched.zeros_pool_state(OBJECTIVES["sphere"], key, 2, 4,
                                             "meta")}
    out = mgr.restore_host(1, like)["p000"]
    assert isinstance(out, batched.PoolState)
    for got, want in zip((out.pool, out.aggs, out.hist, out.pass_idx,
                          out.n_valid), state.tensors()):
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, want.numpy()) and got.dtype == \
            want.numpy().dtype


# ---- append-only journal ---------------------------------------------------
def test_journal_append_roll_and_truncate(tmp_path):
    mgr = CheckpointManager(tmp_path, journal_segment_records=3)
    for i in range(8):
        assert mgr.journal_append([{"t": "submit", "job_id": f"j{i}"}]) \
            == i + 1
    assert mgr.journal_last_seq() == 8
    assert len(list((tmp_path / "journal").glob("seg_*.jsonl"))) == 3
    got = mgr.journal_entries()
    assert [r["seq"] for r in got] == list(range(1, 9))
    assert [r["job_id"] for r in got] == [f"j{i}" for i in range(8)]
    assert mgr.journal_entries(after_seq=6) == got[6:]

    mgr.journal_truncate(6)
    assert [r["seq"] for r in mgr.journal_entries()] == [7, 8]
    assert len(list((tmp_path / "journal").glob("seg_*.jsonl"))) == 1
    st = mgr.journal_stats()
    assert st["records"] == 2 and st["segments"] == 1 and st["last_seq"] == 8

    mgr.journal_truncate(8)
    assert mgr.journal_entries() == []
    fresh = CheckpointManager(tmp_path)
    assert fresh.journal_last_seq() == 8
    assert fresh.journal_append([{"t": "submit", "job_id": "j8"}]) == 9


def test_journal_tolerates_and_repairs_torn_tail(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.journal_append([{"a": 1}, {"a": 2}])
    (seg,) = (tmp_path / "journal").glob("seg_*.jsonl")
    with seg.open("a") as fh:
        fh.write('{"seq": 3, "a"')       # kill mid-append: torn last line
    fresh = CheckpointManager(tmp_path)
    assert [r["seq"] for r in fresh.journal_entries()] == [1, 2]
    assert fresh.journal_append([{"a": 3}]) == 3
    assert [r["seq"] for r in fresh.journal_entries()] == [1, 2, 3]


def test_journal_corruption_in_old_segment_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, journal_segment_records=2)
    mgr.journal_append([{"a": i} for i in range(4)])    # 2 segments
    first = sorted((tmp_path / "journal").glob("seg_*.jsonl"))[0]
    first.write_text('{"seq": 1, "a": 0}\nnot json\n')
    fresh = CheckpointManager(tmp_path)
    with pytest.raises(RuntimeError):
        fresh.journal_entries()


# ---- the JAX package's layout ------------------------------------------------
def _pool_pair(rng):
    """The same engine pool as a JAX PoolState and a port PoolState."""
    arrs = [rng.normal(size=(6, 64)).astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32),
            rng.normal(size=(3, 4)).astype(np.float32),
            rng.randint(0, 4, (3,)).astype(np.int32),
            rng.randint(0, 900, (3,)).astype(np.int32)]
    j = JB.PoolState(*[jnp.asarray(a) for a in arrs])
    t = batched.PoolState(*[torch.from_numpy(a.copy()) for a in arrs])
    return arrs, j, t


def test_port_reads_a_jax_snapshot(tmp_path, rng):
    arrs, jstate, tstate = _pool_pair(rng)
    extra = rng.normal(size=(5,)).astype(np.float32)
    JManager(tmp_path).save(4, {"p001": jstate, "p000": jstate,
                                "z": jnp.asarray(extra)},
                            aux={"version": 3})
    like = {"p000": tstate, "p001": tstate, "z": torch.zeros(5)}
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 4 and mgr.aux(4) == {"version": 3}
    out = mgr.restore_host(4, like)
    for p in ("p000", "p001"):
        for got, want in zip((out[p].pool, out[p].aggs, out[p].hist,
                              out[p].pass_idx, out[p].n_valid), arrs):
            assert np.array_equal(got, want) and got.dtype == want.dtype
    assert np.array_equal(out["z"], extra)


def test_jax_reads_a_port_snapshot(tmp_path, rng):
    arrs, jstate, tstate = _pool_pair(rng)
    CheckpointManager(tmp_path).save(9, {"p001": tstate, "p000": tstate},
                                      aux={"jobs": {}})
    like = jax.eval_shape(lambda: {"p000": jstate, "p001": jstate})
    jm = JManager(tmp_path)
    assert jm.latest_step() == 9 and jm.aux(9) == {"jobs": {}}
    out = jm.restore_host(9, like)
    for p in ("p000", "p001"):
        for got, want in zip(jax.tree_util.tree_leaves(out[p]), arrs):
            assert np.array_equal(np.asarray(got), want)
    # the manifests agree but for the treedef string
    JManager(tmp_path / "j").save(9, {"p001": jstate, "p000": jstate},
                                  aux={"jobs": {}})

    def manifest(d):
        m = json.loads((d / f"step_{9:012d}" / "manifest.json").read_text())
        m.pop("treedef")
        return m

    assert manifest(tmp_path) == manifest(tmp_path / "j")


def test_journal_segments_are_byte_identical(tmp_path):
    recs = [{"t": "submit", "job_id": f"job-{i:06d}",
             "spec": {"objective": "sphere", "n": 10 + i, "seed": i,
                      "config": {"samples_per_pass": 7}, "tag": ""}}
            for i in range(5)] + [{"t": "cancel", "job_id": "job-000001"},
                                  {"t": "fetched", "job_id": "job-000000"}]
    for cls, sub in ((CheckpointManager, "t"), (JManager, "j")):
        mgr = cls(tmp_path / sub, journal_segment_records=3)
        mgr.journal_append(recs[:4])
        mgr.journal_append(recs[4:])
        mgr.journal_truncate(3)
    for name in ("seg_000000000004.jsonl", "seg_000000000007.jsonl", "SEQ"):
        a = (tmp_path / "t" / "journal" / name).read_bytes()
        assert a == (tmp_path / "j" / "journal" / name).read_bytes(), name
    assert sorted(p.name for p in (tmp_path / "t" / "journal").iterdir()) \
        == sorted(p.name for p in (tmp_path / "j" / "journal").iterdir())


# ---- fsck: the same findings from both packages ---------------------------
CFG = ABOConfig(samples_per_pass=7, n_passes=5, block_size=64)


def _engine_dir(root):
    """A real checkpoint directory of the port's engine: three bases (steps
    1-3, two lanes mid-flight at the last) and a journal of 7 records in
    segments of 3 after them."""
    eng = SolveEngine(lanes=2, checkpoint_dir=root, journal_every=1,
                      max_fuse=1, device="cpu")
    eng.submit_many([JobSpec("sphere", 300, CFG, seed=0),
                     JobSpec("griewank", 200, CFG, seed=1),
                     JobSpec("sphere", 100, CFG, seed=2)])
    for _ in range(3):
        eng.step()
    mgr = CheckpointManager(root, journal_segment_records=3)
    mgr.journal_append([{"t": "submit", "job_id": f"job-{i:06d}",
                         "spec": {"objective": "sphere", "n": 50}}
                        for i in range(3, 10)])
    return root


def _damage(root, kind):
    steps = sorted(p for p in root.glob("step_*"))
    segs = sorted((root / "journal").glob("seg_*.jsonl"))
    if kind == "tmp_snapshot":
        tmp = root / "step_000000000009.tmp"
        tmp.mkdir()
        (tmp / "leaf_00000.npy").write_bytes(b"partial")
    elif kind == "torn_base":
        (steps[-1] / "manifest.json").write_text("{not json")
    elif kind == "bad_device_map":
        mf = steps[-1] / "manifest.json"
        m = json.loads(mf.read_text())
        pt = next(pt for pt in m["aux"]["pools"][0]["page_table"] if pt)
        pt[1] = pt[0]                    # one lane claims a page twice
        mf.write_text(json.dumps(m))
    elif kind == "torn_tail":
        with segs[-1].open("a") as fh:
            fh.write('{"seq": 99, "t"')
    elif kind == "corrupt_record":
        lines = segs[0].read_text().splitlines(keepends=True)
        segs[0].write_text(lines[0] + "not json\n" + "".join(lines[1:]))
    elif kind == "seq_gap":
        lines = segs[1].read_text().splitlines(keepends=True)
        rec = json.loads(lines[1])
        rec["seq"] += 5
        segs[1].write_text(lines[0] + json.dumps(rec) + "\n"
                           + "".join(lines[2:]))
    else:
        assert kind == "bad_seq_floor"
        (root / "journal" / "SEQ").write_text("not-a-number")


def _findings(report, root):
    return sorted((f["kind"], str(pathlib.Path(f["path"]).relative_to(root)),
                   f["detail"], f["repaired"]) for f in report["findings"])


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


FINDINGS = ["tmp_snapshot", "torn_base", "bad_device_map", "torn_tail",
            "corrupt_record", "seq_gap", "bad_seq_floor"]


@pytest.mark.parametrize("kind", FINDINGS)
def test_fsck_verdicts_match_jax(tmp_path, kind, capsys):
    base = _engine_dir(tmp_path / "base")
    _damage(base, kind)
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    shutil.copytree(base, t_dir)
    shutil.copytree(base, j_dir)
    for repair in (False, True, False):
        argv = ["--repair"] if repair else []
        rc_t = tfsck.main([str(t_dir)] + argv)
        rep_t = json.loads(capsys.readouterr().out)
        rc_j = jfsck.main([str(j_dir)] + argv)
        rep_j = json.loads(capsys.readouterr().out)
        assert rc_t == rc_j, (repair, rep_t, rep_j)
        assert _findings(rep_t, t_dir) == _findings(rep_j, j_dir)
        assert rep_t["dropped_records"] == rep_j["dropped_records"]
        if not repair and rep_t["findings"]:
            assert rc_t == 1
            assert kind in {f["kind"] for f in rep_t["findings"]}
    assert rc_t == 0 and not rep_t["findings"]     # clean after repair
    assert _tree_bytes(t_dir) == _tree_bytes(j_dir)
