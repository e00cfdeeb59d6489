"""Fault-tolerant checkpointing on torch tensors: manifest + per-leaf .npy,
atomic commit, and an append-only journal.

Port of :mod:`repro.checkpoint.manager`, on the reference's on-disk layout
byte for byte, so either package's ``fsck`` and ``restore_host`` read the
other's directories:

  * save: leaves -> ``<dir>/step_%012d.tmp/leaf_%05d.npy`` +
    ``manifest.json`` (``step``, ``treedef``, ``n_leaves``, ``shapes``,
    ``dtypes``, ``committed``, optional ``aux``), then an ATOMIC rename to
    ``step_%012d``: a preempted save never leaves a half-readable
    checkpoint. Leaves are in JAX's pytree order (dict keys sorted,
    sequences in order, a dataclass's fields in declaration order, None
    an empty subtree), so a port-written snapshot of an engine pool lists
    ``pool, aggs, hist, pass_idx, n_valid`` as the reference's does. The
    ``treedef`` string is the port's own description of the structure;
    the reference's restore ignores it, as this one does.
  * restore: ``np.load`` the leaves into the structure of a ``like`` tree
    whose leaves need only ``shape`` and ``dtype`` (meta tensors, tensors
    or numpy arrays): nothing is allocated on the card on its account.
  * rotation: keep the newest ``keep`` checkpoints.
  * async: ``save(blocking=False)`` copies every leaf to the host at the
    call and writes in a background thread; ``wait()`` joins it.
  * corruption: a checkpoint without the committed flag in its manifest is
    skipped by ``latest_step()``.
  * journal: ``<dir>/journal/seg_%012d.jsonl`` segments of
    ``{"seq": n, **record}`` lines with a monotone seq, rolled at a fixed
    record count, compacted by ``journal_truncate`` behind a ``SEQ`` floor
    file; a torn tail line (a kill mid-append) is tolerated on replay and
    repaired before the next append.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_LEAF = "*"


def _flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)`` in JAX's pytree order; ``treedef`` is a nested
    tuple :func:`_unflatten` rebuilds the tree from."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(v) for v in node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return ("dataclass", type(node),
                    tuple((f.name, walk(getattr(node, f.name)))
                          for f in dataclasses.fields(node)))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def _unflatten(treedef, leaves: list):
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == _LEAF:
            return next(it)
        kind = d[0]
        if kind == "dict":
            return {k: build(v) for k, v in d[1]}
        if kind == "dataclass":
            return d[1](**{k: build(v) for k, v in d[2]})
        seq = [build(v) for v in d[1]]
        return tuple(seq) if kind == "tuple" else seq

    return build(treedef)


def _describe(treedef) -> str:
    """The manifest's ``treedef`` string: the structure, leaves as ``*``."""
    if treedef is None or treedef == _LEAF:
        return str(treedef)
    if treedef[0] == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(v)}"
                               for k, v in treedef[1]) + "}"
    if treedef[0] == "dataclass":
        return (treedef[1].__name__ + "("
                + ", ".join(f"{k}={_describe(v)}" for k, v in treedef[2])
                + ")")
    inner = ", ".join(_describe(v) for v in treedef[1])
    return f"[{inner}]" if treedef[0] == "list" else f"({inner})"


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _host_copy(x) -> np.ndarray:
    """A fresh host copy of one leaf, never a view of it. On the CPU
    ``t.cpu()`` and ``t.numpy()`` return the tensor's own storage, and the
    engine updates its pools in place, so a view handed to an async save
    would be written torn while the next step runs."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3,
                 journal_segment_records: int = 1024, metrics=None,
                 faults=None):
        """``metrics`` (an optional ``repro_torch.obs.MetricsRegistry``)
        hooks snapshot/journal instrumentation in: write-duration
        histogram, snapshot and journal-record counters. Journal *gauges*
        (lag, segments, bytes) are sampled by the owner at scrape time.

        ``faults`` (an optional ``repro_torch.engine.faults.FaultRegistry``)
        arms the durable-state failpoints: ``snapshot_write`` fires after
        the leaves land but before the manifest commit, ``journal_append``
        mid-record (a kill there leaves a torn tail). None costs nothing."""
        self.dir = pathlib.Path(directory)
        self._faults = faults
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.journal_segment_records = max(journal_segment_records, 1)
        self._thread: threading.Thread | None = None
        # (last seq, open-segment path, open-segment record count) — lazily
        # initialized from a directory scan on first journal use
        self._journal: tuple[int, pathlib.Path | None, int] | None = None
        self._h_snapshot = (metrics.histogram(
            "ckpt_snapshot_seconds", "whole-state snapshot write+commit")
            if metrics is not None else None)
        self._c_snapshots = (metrics.counter(
            "ckpt_snapshots_total", "committed snapshots")
            if metrics is not None else None)
        self._c_journal_records = (metrics.counter(
            "ckpt_journal_records_total", "journal records appended")
            if metrics is not None else None)
        self._c_journal_truncations = (metrics.counter(
            "ckpt_journal_truncations_total",
            "journal compactions after a base snapshot")
            if metrics is not None else None)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             aux: Any = None):
        """``aux`` is an optional JSON-serializable sidecar stored inside the
        manifest — it commits atomically with the array leaves. Every leaf
        is copied to the host before this returns, also with
        ``blocking=False``, so the caller may go on updating its tensors."""
        self.wait()               # at most one writer — never race a .tmp dir
        leaves, treedef = _flatten(tree)
        host_leaves = [_host_copy(x) for x in leaves]
        if blocking:
            self._write(step, host_leaves, treedef, aux)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, treedef, aux),
                daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves: list, treedef, aux: Any = None):
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step:012d}.tmp"
        final = self.dir / f"step_{step:012d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, leaf in enumerate(leaves):
            np.save(tmp / f"leaf_{i:05d}.npy", leaf)
        if self._faults is not None:
            # failpoint: leaves are on disk, manifest is not — a kill
            # here is exactly the torn .tmp snapshot latest_step() skips
            self._faults.trip("snapshot_write")
        manifest = {
            "step": step,
            "treedef": _describe(treedef),
            "n_leaves": len(leaves),
            "shapes": [list(leaf.shape) for leaf in leaves],
            "dtypes": [str(leaf.dtype) for leaf in leaves],
            "committed": True,
        }
        if aux is not None:
            manifest["aux"] = aux
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                         # atomic commit
        self._rotate()
        if self._h_snapshot is not None:
            self._h_snapshot.observe(time.perf_counter() - t0)
            self._c_snapshots.inc()

    def _rotate(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        best = None
        for c in sorted(self.dir.glob("step_*")):
            if c.name.endswith(".tmp"):
                continue
            mf = c / "manifest.json"
            try:
                m = json.loads(mf.read_text())
                if m.get("committed"):
                    best = m["step"]
            except (OSError, json.JSONDecodeError):
                continue       # torn checkpoint -> ignore
        return best

    def aux(self, step: int) -> Any:
        """The JSON sidecar stored with ``save(..., aux=...)`` (or None)."""
        path = self.dir / f"step_{step:012d}"
        return json.loads((path / "manifest.json").read_text()).get("aux")

    def restore_host(self, step: int, like: Any) -> Any:
        """Load into the structure of ``like`` (shapes validated, dtypes
        cast to ``like``'s) as HOST numpy arrays — no device placement.
        ``like``'s leaves need only ``shape`` and ``dtype``: meta tensors
        (``torch.empty(shape, dtype=..., device="meta")``), tensors or
        numpy arrays."""
        path = self.dir / f"step_{step:012d}"
        manifest = json.loads((path / "manifest.json").read_text())
        like_leaves, treedef = _flatten(like)
        leaves = [np.load(path / f"leaf_{i:05d}.npy")
                  for i in range(manifest["n_leaves"])]
        assert len(leaves) == len(like_leaves), "tree structure changed"
        for got, want in zip(leaves, like_leaves):
            assert tuple(got.shape) == tuple(want.shape), \
                (got.shape, want.shape)
        leaves = [leaf.astype(_np_dtype(w.dtype))
                  for leaf, w in zip(leaves, like_leaves)]
        return _unflatten(treedef, leaves)

    def restore(self, step: int, like: Any, device=None) -> Any:
        """Load into the structure of ``like`` (shapes validated) as
        tensors on ``device`` (the CPU by default)."""
        host = self.restore_host(step, like)
        leaves, treedef = _flatten(host)
        dev = torch.device(device) if device is not None else None
        out = []
        for leaf in leaves:
            t = torch.from_numpy(leaf)
            out.append(t.to(dev) if dev is not None else t)
        return _unflatten(treedef, out)

    # --------------------------------------------------------------- journal
    @property
    def journal_dir(self) -> pathlib.Path:
        return self.dir / "journal"

    def _journal_segments(self) -> list[pathlib.Path]:
        if not self.journal_dir.is_dir():
            return []
        return sorted(self.journal_dir.glob("seg_*.jsonl"))

    def _read_segment(self, path: pathlib.Path, last: bool) -> list[dict]:
        """Parse one segment. A torn tail line — a kill mid-append — is
        dropped, but only in the newest segment; anywhere else it is real
        corruption and must not be silently skipped."""
        out = []
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if last and i == len(lines) - 1:
                    break                       # torn tail -> ignore
                raise RuntimeError(
                    f"corrupt journal record in {path} line {i + 1}")
        return out

    def _journal_state(self) -> tuple[int, pathlib.Path | None, int]:
        if self._journal is None:
            last_seq, open_seg, count = 0, None, 0
            floor = self.journal_dir / "SEQ"
            if floor.exists():                  # truncation high-water mark
                last_seq = int(floor.read_text())
            segs = self._journal_segments()
            if segs:
                # repair a torn tail BEFORE ever appending again — a new
                # record written after it would weld onto the fragment.
                # Truncate IN PLACE at the last newline: a rewrite would
                # zero the file first, and a crash inside that window
                # destroys the whole segment's durable records
                txt = segs[-1].read_bytes()
                if txt and not txt.endswith(b"\n"):
                    with segs[-1].open("rb+") as fh:
                        fh.truncate(txt.rfind(b"\n") + 1)
            for i, seg in enumerate(segs):
                recs = self._read_segment(seg, last=i == len(segs) - 1)
                if recs:
                    last_seq = max(last_seq, recs[-1]["seq"])
                if i == len(segs) - 1:
                    open_seg, count = seg, len(recs)
            self._journal = (last_seq, open_seg, count)
        return self._journal

    def journal_last_seq(self) -> int:
        return self._journal_state()[0]

    def journal_append(self, records: list[dict]) -> int:
        """Append records (assigning each a monotone ``seq``) to the open
        segment, rolling to a new segment file every
        ``journal_segment_records``. Returns the last assigned seq. Writes
        are flushed per call, so anything appended survives a process
        kill; a record cut mid-write is a torn tail, which replay
        tolerates."""
        seq, open_seg, count = self._journal_state()
        self.journal_dir.mkdir(parents=True, exist_ok=True)
        fh = None
        try:
            for rec in records:
                seq += 1
                if open_seg is None or count >= self.journal_segment_records:
                    if fh is not None:
                        fh.close()
                        fh = None
                    open_seg = self.journal_dir / f"seg_{seq:012d}.jsonl"
                    count = 0
                if fh is None:       # one open per segment, not per record
                    fh = open_seg.open("a")
                line = json.dumps({"seq": seq, **rec}) + "\n"
                if self._faults is not None:
                    f = self._faults.check("journal_append")
                    if f is not None:
                        if f.kind == "kill":
                            # land the front half of the record, then die:
                            # what a crash between write and flush leaves
                            fh.write(line[: max(len(line) // 2, 1)])
                            fh.flush()
                        f.execute()  # kill exits the process; raise
                        #              propagates with nothing written
                fh.write(line)
                count += 1
        finally:
            if fh is not None:
                fh.close()
        self._journal = (seq, open_seg, count)
        if self._c_journal_records is not None:
            self._c_journal_records.inc(len(records))
        return seq

    def journal_entries(self, after_seq: int = 0) -> list[dict]:
        """All journal records with seq > ``after_seq``, in seq order."""
        out = []
        segs = self._journal_segments()
        for i, seg in enumerate(segs):
            for rec in self._read_segment(seg, last=i == len(segs) - 1):
                if rec["seq"] > after_seq:
                    out.append(rec)
        return out

    def journal_truncate(self, upto_seq: int):
        """Compaction: drop segments whose every record is <= ``upto_seq``
        (already covered by a committed base snapshot), and persist the
        seq floor so a restart with an empty journal keeps seq monotone."""
        seq, open_seg, count = self._journal_state()
        if upto_seq <= 0:
            return
        self.journal_dir.mkdir(parents=True, exist_ok=True)
        floor = self.journal_dir / "SEQ"
        tmp = floor.with_suffix(".tmp")
        tmp.write_text(str(max(upto_seq, seq)))
        tmp.rename(floor)
        segs = self._journal_segments()
        for i, seg in enumerate(segs):
            recs = self._read_segment(seg, last=i == len(segs) - 1)
            if recs and recs[-1]["seq"] > upto_seq:
                break
            seg.unlink()
            if seg == open_seg:
                open_seg, count = None, 0
        self._journal = (max(seq, upto_seq), open_seg, count)
        if self._c_journal_truncations is not None:
            self._c_journal_truncations.inc()

    def journal_stats(self) -> dict:
        """Size/position of the live journal (post-compaction residue), in
        O(#segments): every non-open segment is full, and the open one's
        count is tracked incrementally."""
        last_seq, open_seg, count = self._journal_state()
        segs = self._journal_segments()
        full = len(segs) - 1 if segs else 0
        records = full * self.journal_segment_records + \
            (count if segs else 0)
        nbytes = sum(seg.stat().st_size for seg in segs)
        return {"segments": len(segs), "records": records, "bytes": nbytes,
                "last_seq": last_seq}
