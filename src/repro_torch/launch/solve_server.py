"""Solve-service launcher: queue many ABO jobs through the engine, or serve
them over HTTP.

Port of :mod:`repro.launch.solve_server`, on one device:

    PYTHONPATH=src python -m repro_torch.launch.solve_server --jobs 24 \\
        --lanes 8 --n 100000,1000000,4000000      # on the card
    PYTHONPATH=src python -m repro_torch.launch.solve_server --jobs 12 \\
        --lanes 4 --n 400 --samples 20 --passes 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.solve_server --http 0 \\
        --port-file pf --lanes 8                  # HTTP, on the card
    PYTHONPATH=src python -m repro_torch.launch.solve_server --http 0 \\
        --workers 2 --ckpt-dir cluster --port-file pf   # router + 2 workers

Batch mode submits the reference's synthetic mix — job i solves objective
``i mod len(--objectives)`` at size ``i mod len(--n)`` from seed i —
drains the queue with continuous lane refill, and prints the reference's
summary line (jobs/s and probe-FE/s). ``--retain-done``,
``--pool-high-water``, ``--trace``, ``--metrics-out``, ``--inject``,
``--max-queue`` and ``--memory-budget`` behave as in the reference.

``--http PORT`` serves submit/poll/result/cancel/stats/healthz/metrics as
JSON over HTTP on localhost instead (``repro_torch.serve.frontend``, the
reference's endpoints, codes and envelopes); ``--auth``, ``--max-body``,
``--max-inflight``, ``--deadline``, ``--wait-max``, ``--max-n``,
``--port-file`` and ``--verbose`` shape the front door as in the
reference. ``--workers N`` (with ``--http`` and ``--ckpt-dir``) makes this
process the supervising router (``repro_torch.serve.router``) over N
``repro_torch.serve.worker`` processes, each on ``--device``.

Checkpointing, as in the reference: ``--ckpt-dir DIR`` cuts a snapshot
at submit, every ``--ckpt-every`` steps and at the end;
``--journal-every K`` journals client inputs and cuts bases every K steps
instead; ``--resume`` (with ``--ckpt-dir``) resumes the directory's jobs
instead of submitting new ones. SIGTERM/SIGINT stop the drain (or the
server) at the next step boundary, cut a final snapshot and exit 0. A
kill at a durable-state failpoint
(``REPRO_INJECT_FAULTS="snapshot_write:kind=kill:nth=2"`` or ``--inject``)
exits 137 with the directory torn as a crash leaves it;
``python -m repro_torch.checkpoint.fsck DIR [--repair]`` reports and
repairs it, and ``--resume`` finishes the durable jobs.
``--sanitize`` runs every step under ``repro_torch.analysis``'s sync guard
(CUDA's sync debug mode on the card) and checks that each step updates the
pool in place; ``--compile-budget N`` fails the run if the drain builds
more than N pool shapes (eager PyTorch compiles nothing; shapes are what
the budget counts). ``--device`` picks the device (default: the card).

Not ported yet, each exiting non-zero with a message: ``--devices`` and
``--span`` (sharded and spanning pools). ROADMAP.md, queue 1, says which
PR brings them.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

from repro_torch.core.abo import ABOConfig
from repro_torch.engine.faults import parse_fault_spec
from repro_torch.engine.jobs import DONE, JobSpec
from repro_torch.engine.scheduler import SolveEngine
from repro_torch.engine.service import SolveService

# flags of the reference that the port does not take yet, and the ROADMAP
# item (queue 1) that brings them
NOT_PORTED = {"devices": "item 10, multi-device",
              "span": "item 10, multi-device"}


def _mixed_specs(n_jobs, objectives, ns, cfg, seed0=0):
    return [JobSpec(objectives[i % len(objectives)], ns[i % len(ns)], cfg,
                    seed=seed0 + i)
            for i in range(n_jobs)]


def _build_server(service: SolveService, port: int, poll_s: float = 0.01,
                  verbose: bool = False, config=None):
    """Build a :class:`repro_torch.serve.frontend.Frontend` and return
    ``(httpd, stepper_thread)``, as the reference's shim does (tests drive
    ``serve_forever`` from their own thread and ``shutdown()`` it). The
    Frontend rides along as ``httpd._frontend``; pass ``config`` (a
    FrontendConfig) to harden beyond the defaults."""
    from repro_torch.serve.frontend import Frontend, FrontendConfig
    if config is None:
        config = FrontendConfig(poll_s=poll_s, verbose=verbose)
    fe = Frontend(service, port, config)
    return fe.httpd, fe.stepper_thread


def _install_signal_handlers(on_signal):
    """SIGTERM/SIGINT -> ``on_signal(signum)``; returns the previous
    handlers (empty off the main thread, where signal.signal fails)."""
    if threading.current_thread() is not threading.main_thread():
        return {}
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(
            sig, lambda signum, frame: on_signal(signum))
    return prev


def _serve_http(service: SolveService, port: int, poll_s: float = 0.01,
                verbose: bool = False, config=None,
                port_file: str | None = None):
    """The hardened JSON-over-HTTP front door; blocks until SIGTERM or
    SIGINT, then lets in-flight replies finish, cuts a final snapshot
    (when checkpointing is on) and returns for a clean exit 0."""
    from repro_torch.serve.frontend import Frontend, FrontendConfig
    if config is None:
        config = FrontendConfig(poll_s=poll_s, verbose=verbose)
    fe = Frontend(service, port, config)
    if port_file:
        from repro_torch.serve.worker import _write_port_file
        _write_port_file(port_file, fe.httpd.server_address[1])
    _install_signal_handlers(
        lambda signum: fe.begin_shutdown(f"signal {signum}"))
    fe.serve()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.solve_server")
    ap.add_argument("--jobs", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--n", default="1000",
                    help="problem size, or a comma list for a "
                         "heterogeneous-n workload (e.g. 500,1300,6000)")
    ap.add_argument("--objectives", default="griewank,sphere,rastrigin")
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--retain-done", type=int, default=None, metavar="N",
                    help="evict whole job records of delivered/cancelled "
                         "jobs beyond the N most recent")
    ap.add_argument("--pool-high-water", type=float, default=2.0,
                    metavar="X",
                    help="shrink a drained pool once its capacity exceeds "
                         "X times the ladder rung actually occupied (X >= "
                         "1; 0 disables shrinking)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing and export Chrome-trace JSON "
                         "to PATH when the run (or server) ends")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a final Prometheus text snapshot to PATH "
                         "after a batch run")
    ap.add_argument("--sanitize", action="store_true",
                    help="run every step under the host-sync guard and "
                         "check that each step updates the pool in place")
    ap.add_argument("--compile-budget", type=int, default=None, metavar="N",
                    help="batch mode: fail the run if the drain builds "
                         "more than N pool shapes")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="arm deterministic fault injection: "
                         "site[:key=val]*[;site...] (e.g. "
                         "'objective_eval:every=4:seed=7')")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bounded admission: reject submissions (HTTP "
                         "429) once N jobs are queued")
    ap.add_argument("--memory-budget", type=int, default=None,
                    metavar="BYTES",
                    help="reject submissions (HTTP 503) whose projected "
                         "pool bytes would exceed BYTES")
    ap.add_argument("--journal-every", type=int, default=None,
                    metavar="STEPS",
                    help="incremental checkpointing: append client inputs "
                         "to a journal as they happen and cut a whole-"
                         "state base snapshot (compacting the journal) "
                         "only every STEPS steps; requires --ckpt-dir")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="resume in-flight jobs from --ckpt-dir")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve submit/poll/result over HTTP instead of "
                         "running a synthetic batch (0 = ephemeral "
                         "port; see --port-file)")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="with --http and --ckpt-dir: become a "
                         "supervisor/router over N engine worker "
                         "processes (repro_torch.serve.router) — per-"
                         "family routing, crash respawn with journal "
                         "resume")
    ap.add_argument("--auth", default=None, metavar="SPEC",
                    help="bearer-token tenants: token[:key=val]*[;...] "
                         "with keys name, rate (req/s token bucket), "
                         "burst, quota (lifetime job budget); missing/"
                         "unknown tokens answer 401, over-rate 429")
    ap.add_argument("--max-body", type=int, default=1 << 20,
                    metavar="BYTES",
                    help="reject request bodies larger than BYTES with "
                         "413 (Content-Length is required: 411 without "
                         "it, 400 when malformed)")
    ap.add_argument("--max-n", type=int, default=None, metavar="N",
                    help="reject submissions with n > N at the door "
                         "(schema'd 400)")
    ap.add_argument("--deadline", type=float, default=30.0, metavar="S",
                    help="per-request engine-access budget: a request "
                         "that cannot reach the engine within S seconds "
                         "answers 503 with Retry-After")
    ap.add_argument("--wait-max", type=float, default=60.0, metavar="S",
                    help="cap on ?wait= long-polls (/result, /poll)")
    ap.add_argument("--max-inflight", type=int, default=64, metavar="N",
                    help="bounded request queue: past N concurrent "
                         "requests the front door sheds 503 saturated")
    ap.add_argument("--port-file", default=None, metavar="PATH",
                    help="write the bound HTTP port to PATH (atomic) "
                         "once listening")
    ap.add_argument("--verbose", action="store_true",
                    help="HTTP access logging: one structured JSON line "
                         "per request (method, path, status, duration_ms)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "same engine on the CPU)")
    for flag in ("--devices", "--span"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    return ap


def _parse(argv) -> argparse.Namespace:
    """Parse and validate ``argv`` with the reference's usage errors (exit
    2); adds ``faults``, ``tenants``, ``high_water`` and ``ns``."""
    ap = _parser()
    args = ap.parse_args(argv)
    for name, item in NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"--{name.replace('_', '-')} is not ported to "
                     f"repro_torch yet (ROADMAP.md, queue 1, {item})")
    if args.retain_done is not None and args.retain_done < 0:
        ap.error(f"--retain-done must be >= 0, got {args.retain_done}")
    args.high_water = args.pool_high_water
    if args.high_water == 0:
        args.high_water = None           # 0 = never shrink
    elif args.high_water < 1:
        ap.error("--pool-high-water must be >= 1 (or 0 to disable), got "
                 f"{args.pool_high_water}")
    if args.journal_every is not None:
        if args.journal_every < 1:
            ap.error("--journal-every must be >= 1, got "
                     f"{args.journal_every}")
        if not args.ckpt_dir:
            ap.error("--journal-every requires --ckpt-dir (the journal is "
                     "an incremental layer over base snapshots)")
    if args.max_queue is not None and args.max_queue < 1:
        ap.error(f"--max-queue must be >= 1, got {args.max_queue}")
    if args.memory_budget is not None and args.memory_budget < 1:
        ap.error(f"--memory-budget must be >= 1, got {args.memory_budget}")
    args.faults = None
    if args.inject:
        try:
            args.faults = parse_fault_spec(args.inject)
        except ValueError as e:
            ap.error(f"--inject: {e}")
    if args.max_body < 1:
        ap.error(f"--max-body must be >= 1, got {args.max_body}")
    if args.deadline <= 0:
        ap.error(f"--deadline must be > 0, got {args.deadline}")
    if args.wait_max < 0:
        ap.error(f"--wait-max must be >= 0, got {args.wait_max}")
    if args.max_inflight < 1:
        ap.error(f"--max-inflight must be >= 1, got {args.max_inflight}")
    if args.max_n is not None and args.max_n < 1:
        ap.error(f"--max-n must be >= 1, got {args.max_n}")
    args.tenants = None
    if args.auth:
        from repro_torch.serve.limits import TenantTable
        try:
            args.tenants = TenantTable.from_spec(args.auth)
        except ValueError as e:
            ap.error(f"--auth: {e}")
    if args.workers is not None:
        if args.workers < 1:
            ap.error(f"--workers must be >= 1, got {args.workers}")
        if args.http is None:
            ap.error("--workers requires --http (the router IS an HTTP "
                     "front door)")
        if not args.ckpt_dir:
            ap.error("--workers requires --ckpt-dir (each worker owns a "
                     "journaled subdirectory; without one a worker "
                     "crash would lose acked jobs)")
        if args.inject:
            ap.error("--inject with --workers is ambiguous; use "
                     "python -m repro_torch.serve.router --inject-worker "
                     "IDX:SPEC to arm one worker")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir (without it there is no "
                 "checkpoint to resume from and nothing would be saved)")
    try:
        args.ns = [int(v) for v in str(args.n).split(",") if v.strip()]
    except ValueError:
        args.ns = []
    if not args.ns:
        ap.error(f"--n must be an int or comma list of ints, got {args.n!r}")
    return args


def _engine(args) -> SolveEngine:
    engine_kw = dict(retain_done=args.retain_done,
                     pool_high_water=args.high_water,
                     journal_every=args.journal_every,
                     max_queue=args.max_queue,
                     memory_budget_bytes=args.memory_budget,
                     sanitize=args.sanitize, faults=args.faults,
                     device=args.device)
    if args.resume:
        # the flags only shape a FRESH engine (an empty directory); a
        # checkpoint's recorded lanes and knobs win, so the resumed run
        # cannot diverge from the uninterrupted one
        engine = SolveEngine.resume(args.ckpt_dir,
                                    ckpt_every=args.ckpt_every,
                                    lanes=args.lanes, **engine_kw)
    else:
        engine = SolveEngine(lanes=args.lanes, checkpoint_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every, **engine_kw)
    if args.trace:
        engine.trace(args.trace)
    return engine


def _serve_router(args) -> None:
    """Router mode: this process supervises ``--workers`` worker
    processes and never builds an engine of its own."""
    from repro_torch.serve.router import serve_router
    worker_args = ["--lanes", str(args.lanes),
                   "--journal-every", str(args.journal_every or 8)]
    if args.retain_done is not None:
        worker_args += ["--retain-done", str(args.retain_done)]
    if args.max_queue is not None:
        worker_args += ["--max-queue", str(args.max_queue)]
    if args.memory_budget is not None:
        worker_args += ["--memory-budget", str(args.memory_budget)]
    if args.sanitize:
        worker_args += ["--sanitize"]
    if args.device is not None:
        worker_args += ["--device", args.device]
    if args.verbose:
        worker_args += ["--verbose"]
    serve_router(args.workers, args.http, args.ckpt_dir,
                 worker_args=worker_args, tenants=args.tenants,
                 max_body_bytes=args.max_body,
                 port_file=args.port_file, verbose=args.verbose)


def run(argv=None) -> tuple[dict, SolveEngine]:
    """Batch mode: parse ``argv``, run the batch and print the summary
    line; returns the stats dict (what :func:`main` returns) and the
    drained engine, whose job records hold every result. ``--http`` and
    ``--workers`` serve instead: :func:`main` runs them."""
    args = _parse(argv)
    if args.http is not None or args.workers is not None:
        raise ValueError("run() drives batch mode; main() serves --http "
                         "and --workers")
    return _batch(args, _engine(args))


def _batch(args, engine: SolveEngine) -> tuple[dict, SolveEngine]:
    cfg = ABOConfig(samples_per_pass=args.samples, n_passes=args.passes,
                    block_size=args.block)
    objectives = [o for o in args.objectives.split(",") if o]
    # SIGTERM/SIGINT stop the drain at the next step boundary; the final
    # snapshot below then lands a consistent image and the run exits 0.
    # Installed before the submissions, so a signal during them stops the
    # run the same way.
    stop_flag = threading.Event()

    def on_signal(signum):
        print(f"[solve_server] signal {signum}: stopping after this step",
              flush=True)
        stop_flag.set()

    prev = _install_signal_handlers(on_signal)
    try:
        if not args.resume:
            engine.submit_many(_mixed_specs(args.jobs, objectives, args.ns,
                                            cfg))
            if args.ckpt_dir:
                engine.snapshot()    # a kill in warm-up can't lose the queue
        done_before = {j for j, r in engine.jobs.items()
                       if r.status == DONE}
        t0 = time.time()
        if args.compile_budget is not None:
            from repro_torch.analysis import compile_guard
            with compile_guard(args.compile_budget,
                               "solve_server drain") as cg:
                done = engine.run(stop=stop_flag.is_set)
            print(f"[solve_server] compile_guard: {cg.count} pool shape(s) "
                  f"built (budget {args.compile_budget})", flush=True)
        else:
            done = engine.run(stop=stop_flag.is_set)
        # the last step's harvest read back its finishers, so the device
        # work of every finished job is inside dt
        dt = max(time.time() - t0, 1e-9)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    if args.ckpt_dir:
        # a final base: in journal mode the last results may postdate the
        # last in-run base, and a batch run never fetches them — without
        # it a --resume after a clean finish would re-derive the tail
        engine.snapshot()
        if stop_flag.is_set():
            print("[solve_server] final snapshot cut", flush=True)
    # FE of the jobs THIS run finished (on --resume their specs may differ
    # from this invocation's flags)
    fe = sum(r.spec.config.n_passes * r.spec.config.samples_per_pass
             * r.spec.n for j, r in engine.jobs.items()
             if r.status == DONE and j not in done_before)
    waste = engine.pad_stats()["swept_waste"]
    stats = {"done": done, "steps": engine.step_count, "dt_s": dt,
             "jobs_per_s": done / dt, "fe_per_s": fe / dt,
             "families": len(engine.pools),
             "families_created": len(engine.family_keys_seen),
             "devices": engine.n_dev, "sanitize": engine.sanitize,
             "swept_waste": waste, **engine.memory_stats()}
    if args.compile_budget is not None:
        stats["compiles"] = cg.count
        stats["compile_budget"] = args.compile_budget
    if stop_flag.is_set():
        stats["interrupted"] = True      # drained partially, snapshot cut
    if engine.ckpt is not None and engine.journal_every is not None:
        stats["journal"] = engine.ckpt.journal_stats()
    print(f"[solve_server] {done} jobs in {dt:.2f}s over "
          f"{engine.step_count} steps "
          f"({stats['families_created']} executable families, "
          f"{0.0 if waste is None else waste:.1%} swept-row waste): "
          f"{stats['jobs_per_s']:.1f} jobs/s, {stats['fe_per_s']:.3g} "
          "probe-FE/s", flush=True)
    if args.trace:
        print(f"[solve_server] trace -> {engine.trace_export()}",
              flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(engine.render_prometheus())
        print(f"[solve_server] metrics -> {args.metrics_out}", flush=True)
    return stats, engine


def main(argv=None):
    """Batch mode returns its stats dict; ``--http`` and ``--workers``
    serve until SIGTERM/SIGINT and return None."""
    args = _parse(argv)
    if args.workers is not None:
        _serve_router(args)
        return None
    engine = _engine(args)
    if args.http is None:
        return _batch(args, engine)[0]
    from repro_torch.serve.frontend import FrontendConfig
    cfg = FrontendConfig(verbose=args.verbose,
                         max_body_bytes=args.max_body,
                         deadline_s=args.deadline,
                         wait_max_s=args.wait_max,
                         max_inflight=args.max_inflight,
                         max_n=args.max_n, tenants=args.tenants)
    _serve_http(SolveService(engine), args.http, config=cfg,
                port_file=args.port_file)
    return None


if __name__ == "__main__":
    main()
