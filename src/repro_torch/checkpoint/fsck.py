"""Validate and repair a checkpoint directory (base snapshots + journal).

    PYTHONPATH=src python -m repro_torch.checkpoint.fsck <ckpt-dir>
    PYTHONPATH=src python -m repro_torch.checkpoint.fsck <ckpt-dir> --repair

The port's own copy of :mod:`repro.checkpoint.fsck` (numpy only): the same
findings, the same repairs and the same exit codes, on the same on-disk
layout, so either package's fsck checks the other's directories.

What a crash can leave behind, and what repair does about it:

=====================  ==================================================
finding                 repair
=====================  ==================================================
``tmp_snapshot``        a ``step_*.tmp`` dir (kill mid-save, before the
                        atomic rename) — removed; the previous committed
                        base is intact by construction
``torn_base``           a ``step_*`` dir with a missing/corrupt manifest,
                        no committed flag, or missing/truncated leaf
                        files — removed (``latest_step()`` already skips
                        it; removing reclaims disk and un-confuses "ls")
``bad_device_map``      a committed base whose aux (v2/v3) lane→page
                        placement is inconsistent — an orphaned page
                        claim (page/device id out of range, device-map
                        length != page count) or a duplicate claim (two
                        lanes, or one lane twice, owning the same
                        (device, page)) — removed, truncating the chain
                        to the last consistent base; resuming from a
                        base whose page claims overlap would silently
                        alias two jobs' coordinates
``torn_tail``           a partial final line in the newest journal
                        segment (kill mid-append) — truncated in place
                        at the last newline, exactly what the engine's
                        own lazy repair does on next open
``corrupt_record``      an unparsable line anywhere else — the segment
                        is truncated at the bad record; every later
                        record is DROPPED (reported) so replay sees a
                        consistent prefix
``seq_gap``             records whose seq does not advance by exactly 1
                        — truncated at the gap; later records dropped
                        (reported) for the same prefix-consistency
``bad_seq_floor``       an unreadable journal ``SEQ`` floor file —
                        rewritten from the highest surviving record seq
=====================  ==================================================

Exit status: 0 when the directory is clean (or every finding was
repaired under ``--repair``); 1 when findings remain.

The engine's resume path tolerates the torn-tail case on its own; fsck
exists for the rest — and to give operators a pre-resume verdict instead
of a mid-replay RuntimeError.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

import numpy as np


def _check_base(ckpt: pathlib.Path) -> str | None:
    """None if the snapshot dir is sound, else a human-readable defect."""
    mf = ckpt / "manifest.json"
    try:
        m = json.loads(mf.read_text())
    except OSError:
        return "missing manifest.json"
    except json.JSONDecodeError:
        return "corrupt manifest.json"
    if not m.get("committed"):
        return "manifest lacks committed flag"
    n = m.get("n_leaves")
    if not isinstance(n, int) or n < 0:
        return f"bad n_leaves {n!r}"
    for i in range(n):
        leaf = ckpt / f"leaf_{i:05d}.npy"
        if not leaf.exists():
            return f"missing {leaf.name}"
        try:
            # header-only validation: mmap never faults the data pages in,
            # so this stays cheap even for multi-GB leaves
            arr = np.load(leaf, mmap_mode="r")
            want = m.get("shapes", [None] * n)[i]
            if want is not None and list(arr.shape) != list(want):
                return (f"{leaf.name} shape {list(arr.shape)} != manifest "
                        f"{want}")
        except (ValueError, OSError) as e:
            return f"truncated/corrupt {leaf.name}: {e}"
    return None


def _check_device_maps(ckpt: pathlib.Path) -> str | None:
    """None when the base's aux lane→(device, page) claims are
    consistent, else a defect string.

    Engine aux v3 allows a ``lane_dev`` entry to be a per-page device
    list (a striped spanning lane) instead of one int (whole lane);
    either way every live page claim must name an in-range device and an
    in-range non-scratch local page, the device map must cover exactly
    the lane's pages, and no (device, page) may be claimed twice — a
    resume over overlapping claims would alias two jobs' coordinates.
    Legacy/absent aux (pre-v2) has no placement metadata to check.
    """
    try:
        aux = json.loads((ckpt / "manifest.json").read_text()).get("aux")
    except (OSError, json.JSONDecodeError):
        return None                      # _check_base already vetted these
    if not isinstance(aux, dict) or aux.get("version") not in (2, 3):
        return None
    for pi, p in enumerate(aux.get("pools", [])):
        try:
            n_dev = int(p.get("n_dev", 1))
            capacity = int(p["capacity"])
            page_table = list(p["page_table"])
            lane_dev = list(p["lane_dev"])
        except (KeyError, TypeError, ValueError):
            return f"pool {pi}: malformed placement metadata"
        if n_dev < 1 or capacity % n_dev:
            return (f"pool {pi}: capacity {capacity} not divisible by "
                    f"n_dev {n_dev}")
        if len(lane_dev) != len(page_table):
            return (f"pool {pi}: lane_dev covers {len(lane_dev)} slots, "
                    f"page_table {len(page_table)}")
        cap_loc = capacity // n_dev      # local page 0 = per-device scratch
        claimed: set[tuple[int, int]] = set()
        for slot, (pt, dev) in enumerate(zip(page_table, lane_dev)):
            if pt is None:
                continue
            devs = dev if isinstance(dev, list) else [dev] * len(pt)
            if len(devs) != len(pt):
                return (f"pool {pi} slot {slot}: device map length "
                        f"{len(devs)} != page count {len(pt)}")
            for pg, d in zip(pt, devs):
                if not isinstance(d, int) or not 0 <= d < n_dev:
                    return (f"pool {pi} slot {slot}: orphaned claim — "
                            f"device {d!r} of {n_dev}")
                if not isinstance(pg, int) or not 1 <= pg < cap_loc:
                    return (f"pool {pi} slot {slot}: orphaned claim — "
                            f"page {pg!r} outside local range "
                            f"[1, {cap_loc})")
                if (d, pg) in claimed:
                    return (f"pool {pi} slot {slot}: duplicate claim of "
                            f"device {d} page {pg}")
                claimed.add((d, pg))
    return None


def _scan_segment(seg: pathlib.Path) -> tuple[list[tuple[int, int]], int]:
    """Parse one journal segment leniently.

    Returns ``(records, good_bytes)`` where records are ``(seq,
    end_offset)`` pairs for every well-formed line prefix and
    ``good_bytes`` is the byte offset up to which the file parses —
    everything past it is torn or corrupt.
    """
    raw = seg.read_bytes()
    records: list[tuple[int, int]] = []
    off = 0
    while off < len(raw):
        nl = raw.find(b"\n", off)
        if nl < 0:
            break                        # partial final line (torn tail)
        line = raw[off:nl]
        if line.strip():
            try:
                rec = json.loads(line)
                seq = rec["seq"]
            except (json.JSONDecodeError, KeyError, TypeError):
                return records, off      # corrupt record mid-segment
            records.append((int(seq), nl + 1))
        off = nl + 1
    return records, off


def fsck(directory: str | pathlib.Path, repair: bool = False) -> dict:
    """Check (and with ``repair=True``, fix) one checkpoint directory.

    Returns a report dict: ``findings`` (list of {kind, path, detail,
    repaired}), ``dropped_records`` (journal records lost to lossy
    repairs), ``ok`` (no findings, or all repaired).
    """
    root = pathlib.Path(directory)
    findings: list[dict] = []
    dropped = 0

    def note(kind: str, path: pathlib.Path, detail: str, repaired: bool):
        findings.append({"kind": kind, "path": str(path), "detail": detail,
                         "repaired": repaired})

    # ---- base snapshots --------------------------------------------------
    for ckpt in sorted(root.glob("step_*")):
        if ckpt.name.endswith(".tmp"):
            if repair:
                shutil.rmtree(ckpt)
            note("tmp_snapshot", ckpt, "in-flight save never committed",
                 repair)
            continue
        defect = _check_base(ckpt)
        if defect is not None:
            if repair:
                shutil.rmtree(ckpt)
            note("torn_base", ckpt, defect, repair)
            continue
        defect = _check_device_maps(ckpt)
        if defect is not None:
            # removal truncates the chain to the last consistent base —
            # latest_step() then resumes from it, same as torn_base
            if repair:
                shutil.rmtree(ckpt)
            note("bad_device_map", ckpt, defect, repair)

    # ---- journal ---------------------------------------------------------
    jdir = root / "journal"
    segs = sorted(jdir.glob("seg_*.jsonl")) if jdir.is_dir() else []
    last_seq = None
    max_seq = 0
    chain_broken = False
    for i, seg in enumerate(segs):
        if chain_broken:
            # a broken chain invalidates every later segment: replay
            # must be a strict prefix
            if repair:
                seg.unlink()
            note("seq_gap", seg, "segment follows a broken chain", repair)
            continue
        records, good_bytes = _scan_segment(seg)
        size = seg.stat().st_size
        # walk the seq chain; stop at the first gap
        keep = len(records)
        for j, (seq, _) in enumerate(records):
            if last_seq is not None and seq != last_seq + 1:
                keep = j
                break
            last_seq = seq
            max_seq = max(max_seq, seq)
        keep_bytes = records[keep - 1][1] if keep else 0
        if keep < len(records):
            n_drop = len(records) - keep
            dropped += n_drop
            if repair:
                with seg.open("rb+") as fh:
                    fh.truncate(keep_bytes)
            note("seq_gap", seg,
                 f"seq jumps at record {keep + 1}; {n_drop} record(s) "
                 "dropped", repair)
            chain_broken = True
        elif good_bytes < size:
            tail_is_last = i == len(segs) - 1
            kind = "torn_tail" if tail_is_last else "corrupt_record"
            if repair:
                with seg.open("rb+") as fh:
                    fh.truncate(good_bytes)
            note(kind, seg,
                 f"{size - good_bytes} unparsable byte(s) past offset "
                 f"{good_bytes}", repair)
            if not tail_is_last:
                chain_broken = True      # records were lost mid-chain
        if repair and seg.exists() and seg.stat().st_size == 0:
            seg.unlink()                 # nothing durable left in it

    floor = jdir / "SEQ"
    if floor.exists():
        try:
            int(floor.read_text())
        except ValueError:
            if repair:
                floor.write_text(str(max_seq))
            note("bad_seq_floor", floor,
                 f"unreadable; rewritten to {max_seq}" if repair
                 else "unreadable", repair)

    ok = all(f["repaired"] for f in findings)
    return {"dir": str(root), "findings": findings,
            "dropped_records": dropped, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.checkpoint.fsck",
        description="validate/repair a checkpoint base+journal chain")
    ap.add_argument("directory", help="checkpoint directory to check")
    ap.add_argument("--repair", action="store_true",
                    help="fix what can be fixed (remove torn snapshots, "
                         "truncate torn/corrupt journal suffixes)")
    args = ap.parse_args(argv)
    report = fsck(args.directory, repair=args.repair)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
