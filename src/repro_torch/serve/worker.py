"""One supervised engine worker: fsck, resume, serve, die cleanly.

    PYTHONPATH=src python -m repro_torch.serve.worker \\
        --ckpt-dir results/w0 --port 0 --port-file results/w0/port
    PYTHONPATH=src python -m repro_torch.serve.worker \\
        --ckpt-dir results/w0 --port-file results/w0/port --device cpu

Port of :mod:`repro.serve.worker`, the unit the router supervises, with
its engine on the card unless ``--device`` says otherwise. The contract
that makes worker death boring:

1. **fsck --repair on the way up.** A kill can leave a tmp snapshot,
   a torn base, or a ragged journal tail; repair truncates to the last
   consistent prefix before the engine reads anything.
2. **Journal-mode resume, always.** :meth:`SolveEngine.resume` with an
   empty directory is a fresh engine, with state it is base + journal
   replay — either way every acked submission is durable the moment
   ``/submit`` answered 200 (the journal append is synchronous inside
   ``submit``), so a crash between ack and result loses nothing: the
   replayed job re-runs deterministically, bit-identical.
3. **Port-file discovery.** ``--port 0`` binds an ephemeral port and
   writes it to ``--port-file`` (atomic rename), so the router never
   races a half-bound listener and parallel workers never fight over
   fixed ports.
4. **SIGTERM is a clean exit.** In-flight replies finish, the stepper
   stops at a step boundary, a final snapshot lands, exit 0. SIGKILL
   (or an injected ``worker_crash`` kill fault) is the torn case the
   journal exists for.

The worker serves unauthenticated localhost HTTP: auth, rate limits,
and quotas live at the router in a multi-worker deployment (or at this
worker's own front door via ``--auth`` when it IS the deployment).
``--devices`` above 1 (sharded pools) is not ported yet and exits 2.
"""
from __future__ import annotations

import argparse
import os
import pathlib


def _write_port_file(path: str, port: int):
    """Atomic port publication: the router reads whole files only."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(f"{port}\n")
    os.replace(tmp, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.worker")
    ap.add_argument("--ckpt-dir", required=True,
                    help="this worker's journaled checkpoint directory "
                         "(fsck'd and resumed on the way up)")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (published via --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--journal-every", type=int, default=8,
                    help="steps between base snapshots (journal mode is "
                         "not optional for a supervised worker — acked "
                         "submissions must survive a kill)")
    ap.add_argument("--retain-done", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--memory-budget", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "same engine on the CPU)")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="arm deterministic fault injection (sites incl. "
                         "worker_crash/http_reply/slow_client) — re-armed "
                         "per life, never persisted: a respawned worker "
                         "comes up clean unless the router re-injects")
    ap.add_argument("--auth", default=None, metavar="SPEC",
                    help="tenant table spec (token[:key=val]*[;...]); "
                         "normally left off — the router authenticates")
    ap.add_argument("--max-inflight", type=int, default=64)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--wait-max", type=float, default=60.0)
    ap.add_argument("--max-body", type=int, default=1 << 20)
    ap.add_argument("--max-n", type=int, default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.journal_every < 1:
        ap.error(f"--journal-every must be >= 1, got {args.journal_every}")
    if args.devices is not None and args.devices > 1:
        # the engine raises the same (scheduler._not_ported); a usage
        # error here names it before anything is built
        ap.error(f"--devices {args.devices}: sharded pools (devices > 1) "
                 "are not ported to repro_torch yet (ROADMAP.md, queue 1, "
                 "item 10, multi-device)")

    # 1. repair torn on-disk state BEFORE the engine opens it
    from repro_torch.checkpoint.fsck import fsck
    report = fsck(args.ckpt_dir, repair=True)
    findings = report.get("findings", [])
    if findings:
        print(f"[worker] fsck repaired {len(findings)} finding(s) in "
              f"{args.ckpt_dir}", flush=True)

    faults = None
    if args.inject:
        from repro_torch.engine.faults import parse_fault_spec
        try:
            faults = parse_fault_spec(args.inject)
        except ValueError as e:
            ap.error(f"--inject: {e}")

    # 2. resume (fresh dir -> fresh engine; both replay the journal)
    from repro_torch.engine.scheduler import SolveEngine
    from repro_torch.engine.service import SolveService
    engine = SolveEngine.resume(
        args.ckpt_dir, lanes=args.lanes,
        journal_every=args.journal_every,
        retain_done=args.retain_done, max_queue=args.max_queue,
        memory_budget_bytes=args.memory_budget, devices=args.devices,
        sanitize=args.sanitize, faults=faults, device=args.device)
    if engine.journal_every is None:
        # resume from a legacy (non-journal) snapshot chain: durability
        # for NEW submissions still requires the journal
        raise SystemExit(
            f"[worker] {args.ckpt_dir} resumed without journal mode; a "
            "supervised worker cannot guarantee acked submissions "
            "survive a kill — start from a journaled directory")
    service = SolveService(engine)

    # 3. front door + port publication
    from repro_torch.launch.solve_server import _install_signal_handlers
    from repro_torch.serve.frontend import Frontend, FrontendConfig
    from repro_torch.serve.limits import TenantTable
    tenants = None
    if args.auth:
        try:
            tenants = TenantTable.from_spec(args.auth)
        except ValueError as e:
            ap.error(f"--auth: {e}")
    cfg = FrontendConfig(verbose=args.verbose,
                         max_body_bytes=args.max_body,
                         deadline_s=args.deadline,
                         wait_max_s=args.wait_max,
                         max_inflight=args.max_inflight,
                         max_n=args.max_n, tenants=tenants)
    fe = Frontend(service, args.port, cfg)
    port = fe.httpd.server_address[1]
    if args.port_file:
        _write_port_file(args.port_file, port)

    # 4. serve until SIGTERM/SIGINT; finalize() cuts the exit snapshot
    _install_signal_handlers(
        lambda signum: fe.begin_shutdown(f"signal {signum}"))
    fe.serve()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
