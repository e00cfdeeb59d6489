"""Hardened single-worker HTTP front door over :class:`SolveService`.

Port of :mod:`repro.serve.frontend`: the same endpoints, codes and
mechanics, over the port's engine on the card. The contract is
*graceful degradation*: overload, slow clients, and shutdown produce
deliberate, machine-readable answers (429/503 with ``Retry-After``, the
:mod:`repro_torch.serve.errors` envelope), never a stall and never an
unhandled 5xx.

Mechanics, and which failure each one absorbs:

- **Lock-free liveness.** ``/healthz`` serves a health snapshot the
  stepper refreshes at step boundaries and ``/metrics`` renders the
  registry without waiting on the engine (gauges refresh only when the
  engine lock is free at scrape time) — a long fused step can no longer
  fail a liveness probe.
- **Condition-variable stepper.** The engine thread sleeps on a
  condvar when idle (exponential backoff up to ``idle_max_s``) and
  wakes the moment a submit lands — no busy-poll at ``poll_s``, no
  submit-to-first-step latency cliff.
- **Bounded admission.** At most ``max_inflight`` requests may wait on
  the engine lock; past that the front door sheds (503 ``saturated``)
  instead of accumulating threads. Engine-level admission errors
  (queue full, memory budget) map to 429/503 with a ``Retry-After``
  derived from queue depth × recent step time and ``memory_stats()``.
- **Per-request deadlines.** A request that cannot reach the engine
  before its deadline answers 503 ``deadline`` — a stuck engine sheds
  cleanly rather than collecting zombie connections.
- **Long-poll delivery.** ``/result?wait=S`` (and ``/poll?wait=S``)
  parks on a completion condvar the stepper notifies, so clients stop
  hammering ``/poll``; a job that finishes mid-wait answers
  immediately, one that doesn't answers 202 ``not_done``.
- **Capped bodies.** ``Content-Length`` is required (411), must parse
  non-negative (400), and is capped (413 + connection close).
- **Chaos.** The engine's failpoint registry extends here:
  ``http_reply`` (torn reply), ``worker_crash`` (kill at a step
  boundary — how the router tests murder a worker), ``slow_client``
  (delayed body read) make the wire tier deterministically testable.

The engine's device work runs on more than one thread: the stepper's
(every ``step()``: refill places the seeded starts, the sweeps, the
harvest's read-back) and the handlers' (``cancel`` of a running job
frees its lane and may shrink the pool; the final snapshot reads every
pool back). Every engine call holds ``_engine_lock``, so no two of them
interleave, and none enters a ``torch.cuda.stream(...)`` context: all
of them enqueue on the device's one default stream, in lock order.
Under ``SolveEngine(sanitize=True)`` CUDA's sync debug mode is
process-wide while the sanitizer's patch flag is thread-local; the mode
is set only inside ``step()``, which runs under the lock, so its window
covers the stepper's step and nothing a handler does.

One deliberate difference from the reference: ``_engine_lock`` is a
:class:`FifoLock`, handed to waiters in arrival order. The reference's
``threading.Lock`` lets the stepper, which takes the lock again the
moment it lets it go, win nearly every handoff while work is pending, so
requests that arrive during a step wait for many steps, one request
getting through every few steps, until their deadline sheds them (503
``deadline``) although the engine is only busy. With the FIFO lock a
request waits for at most the step in progress and the requests queued
ahead of it, and the stepper waits its turn behind them.

Graceful shutdown: ``begin_shutdown()`` is signal-safe; in-flight
replies complete (long-polls answer 503 ``shutting_down``), the stepper
stops at a step boundary, a final snapshot lands, and ``serve()``
returns for a clean exit 0.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import threading
import time

from repro_torch.engine.faults import InjectedFault
from repro_torch.engine.jobs import QUEUED
from repro_torch.engine.scheduler import MemoryBudgetError, QueueFullError
from repro_torch.engine.service import SolveService
from repro_torch.serve.errors import ApiError, status_for
from repro_torch.serve.limits import TenantTable
from repro_torch.serve.validate import validate_cancel, validate_submit

# terminal statuses a long-poll stops waiting on (engine constants,
# restated here so the wire module never imports engine job internals)
_TERMINAL = ("done", "cancelled", "failed", "unknown")


class FifoLock:
    """A mutex handed to its waiters in the order they asked for it.

    The ``threading.Lock`` subset the front door uses: ``acquire(blocking,
    timeout)``, ``release()``, ``locked()`` and the context manager. A
    non-blocking acquire succeeds only when the lock is free and nobody
    waits; a timed-out waiter leaves the queue."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._held = False
        self._waiters: collections.deque = collections.deque()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        with self._cond:
            if not self._held and not self._waiters:
                self._held = True
                return True
            if not blocking:
                return False
            me = object()
            self._waiters.append(me)
            end = None if timeout < 0 else time.monotonic() + timeout
            while self._held or self._waiters[0] is not me:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    self._waiters.remove(me)
                    self._cond.notify_all()      # the head may have moved
                    return False
                self._cond.wait(left)
            self._waiters.popleft()
            self._held = True
            return True

    def release(self) -> None:
        with self._cond:
            if not self._held:
                raise RuntimeError("release of an unlocked FifoLock")
            self._held = False
            self._cond.notify_all()

    def locked(self) -> bool:
        return self._held

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


@dataclasses.dataclass
class FrontendConfig:
    """Knobs for the hardened front door (all have serving defaults)."""

    poll_s: float = 0.01            # stepper idle backoff floor
    idle_max_s: float = 0.5         # stepper idle backoff cap
    verbose: bool = False           # JSON access log on stdout
    max_body_bytes: int = 1 << 20   # request body cap (413 past it)
    deadline_s: float = 30.0        # per-request engine-access budget
    wait_max_s: float = 60.0        # cap on ?wait= long-polls
    max_inflight: int = 64          # bounded engine request queue
    max_n: int | None = None        # wire-level job size cap (400 past)
    tenants: TenantTable | None = None   # None = auth off
    shutdown_grace_s: float = 10.0  # wait for in-flight replies on stop


class Frontend:
    """One engine worker behind one hardened HTTP listener.

    Construction binds the socket but serves nothing: call
    :meth:`serve` (blocking, runs the stepper too), or drive
    ``httpd.serve_forever()`` / ``stepper_thread.start()`` yourself
    (what tests and the legacy ``_build_server`` shim do).
    """

    def __init__(self, service: SolveService, port: int = 0,
                 config: FrontendConfig | None = None,
                 host: str = "127.0.0.1"):
        from http.server import ThreadingHTTPServer

        self.service = service
        self.cfg = config or FrontendConfig()
        self.faults = service.engine.faults
        self._engine_lock = FifoLock()       # see the module docstring
        self._gate = threading.Lock()        # guards _inflight/_busy
        self._inflight = 0                   # waiting on the engine lock
        self._busy = 0                       # requests building a reply
        self._wake = threading.Condition()   # stepper wakeup (submit)
        self._work_posted = False
        self._done = threading.Condition()   # long-poll waiters
        self._stop_stepper = threading.Event()
        self._stopping = False
        self._step_ewma = 0.05               # recent step wall seconds
        self._health: dict = {"steps": 0, "active_lanes": 0, "queued": 0}
        m = service.engine.metrics
        self._c_requests = m.counter
        self._c_shed = m.counter
        self._h_request = m.histogram(
            "serve_request_seconds", "wall time per HTTP request")
        self._g_inflight = m.gauge(
            "serve_inflight_requests", "requests waiting on or holding "
            "the engine lock")
        self._g_queue_depth = m.gauge(
            "serve_health_queue_depth", "queued jobs at the last health "
            "sample (lock-free /healthz source)")
        self._c_longpoll = m.counter(
            "serve_longpoll_total", "long-poll waits parked on the "
            "completion condvar")
        self._c_wakeups = m.counter(
            "serve_stepper_wakeups_total", "stepper wakeups from the "
            "submit condvar (vs idle-backoff timeouts)")
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        # legacy attribute some callers used for shutdown snapshots,
        # plus a handle back to this Frontend for the _build_server shim
        self.httpd._engine_lock = self._engine_lock
        self.httpd._frontend = self
        self.stepper_thread = threading.Thread(
            target=self._stepper_loop, name="engine-stepper", daemon=True)
        self._sample_health(locked=False)

    # ------------------------------------------------------------- stepping
    def _sample_health(self, locked: bool = True):
        """Refresh the health snapshot ``/healthz`` serves lock-free.

        Called from the stepper (under the engine lock) and once at
        construction; the dict is replaced wholesale so readers see a
        consistent (if slightly stale) view without any lock."""
        eng = self.service.engine
        queued = sum(j in eng.jobs and eng.jobs[j].status == QUEUED
                     for j in eng.queue)
        self._health = {"steps": eng.step_count,
                        "active_lanes": eng.active_lanes,
                        "queued": queued}
        self._g_queue_depth.set(queued)

    def kick(self):
        """Wake the stepper (a submit just landed)."""
        with self._wake:
            self._work_posted = True
            self._wake.notify_all()

    def _stepper_loop(self):
        """Engine thread: step while work is pending, sleep on the
        condvar when idle (backoff doubling ``poll_s`` →
        ``idle_max_s``), wake instantly on submit."""
        cfg = self.cfg
        backoff = cfg.poll_s
        eng = self.service.engine
        while not self._stop_stepper.is_set():
            stepped = False
            with self._engine_lock:
                if not self._stop_stepper.is_set() and eng.pending():
                    # chaos: a worker_crash fault kills/raises HERE, at
                    # the step boundary — exactly where a real OOM-kill
                    # lands, after durable journal appends
                    eng.faults.trip("worker_crash")
                    t0 = time.perf_counter()
                    self.service.step()
                    dt = time.perf_counter() - t0
                    self._step_ewma = 0.7 * self._step_ewma + 0.3 * dt
                    self._sample_health()
                    stepped = True
            if stepped:
                backoff = cfg.poll_s
                with self._done:
                    self._done.notify_all()
                continue
            with self._wake:
                if self._work_posted:
                    self._work_posted = False
                    self._c_wakeups.inc()
                    backoff = cfg.poll_s
                    continue
                self._wake.wait(backoff)
                backoff = min(backoff * 2, cfg.idle_max_s)

    # ----------------------------------------------------------- admission
    def retry_after_s(self, memory: bool = False) -> int:
        """Honest Retry-After: drain-time estimate from queue depth ×
        recent step wall time (memory pressure clears when lanes finish
        a generation, so it floors higher)."""
        h = self._health
        depth = h.get("queued", 0) + (h.get("active_lanes", 0) > 0)
        est = (depth + 1) * max(self._step_ewma, 0.05)
        if memory:
            est = max(est, 2.0)
        return min(max(1, math.ceil(est)), 60)

    @contextlib.contextmanager
    def engine_slot(self, deadline: float):
        """Bounded, deadlined engine-lock acquisition.

        Sheds 503 ``saturated`` when ``max_inflight`` requests already
        wait (backpressure instead of unbounded thread pileup) and 503
        ``deadline`` when the lock doesn't free up in time."""
        with self._gate:
            if self._inflight >= self.cfg.max_inflight:
                self._c_shed("serve_shed_total", "requests shed by the "
                             "front door", code="saturated").inc()
                raise ApiError(
                    503, "saturated",
                    f"{self._inflight} requests already in flight "
                    f"(max_inflight={self.cfg.max_inflight})",
                    retry_after=self.retry_after_s())
            self._inflight += 1
            self._g_inflight.set(self._inflight)
        try:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._engine_lock.acquire(
                    timeout=max(remaining, 1e-3)):
                self._c_shed("serve_shed_total", "requests shed by the "
                             "front door", code="deadline").inc()
                raise ApiError(
                    503, "deadline",
                    "request deadline passed waiting for the engine",
                    retry_after=self.retry_after_s())
            try:
                yield
            finally:
                self._engine_lock.release()
        finally:
            with self._gate:
                self._inflight -= 1
                self._g_inflight.set(self._inflight)

    # ----------------------------------------------------------- long poll
    def wait_for(self, job_id: str, fetch, wait_s: float,
                 deadline: float) -> dict:
        """Park on the completion condvar until ``fetch(job_id)``
        returns a terminal payload or ``wait_s`` runs out."""
        self._c_longpoll.inc()
        end = time.monotonic() + min(wait_s, self.cfg.wait_max_s)
        while True:
            with self.engine_slot(deadline):
                out = fetch(job_id)
            if out.get("status") in _TERMINAL \
                    or out.get("code") not in ("not_done", None):
                return out
            now = time.monotonic()
            if self._stopping:
                raise ApiError(
                    503, "shutting_down",
                    "server shutting down before the job finished",
                    job_id=job_id, status=out.get("status"),
                    retry_after=self.retry_after_s())
            if now >= end:
                return out               # 202 not_done envelope
            with self._done:
                # bounded wait so shutdown and missed notifies are
                # observed promptly even with no steps finishing
                self._done.wait(min(end - now, 0.25))

    # ------------------------------------------------------------ lifecycle
    def begin_shutdown(self, reason: str = "signal"):
        """Signal-safe shutdown trigger: stop accepting, wake every
        parked long-poll, let in-flight replies finish."""
        if self._stopping:
            return
        self._stopping = True
        print(f"[serve] shutting down ({reason})", flush=True)
        with self._done:
            self._done.notify_all()
        # shutdown() blocks until serve_forever exits; never call it
        # from a handler/signal frame
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    def finalize(self):
        """After serve_forever returns: stop the stepper at a step
        boundary, drain in-flight replies, cut the final snapshot."""
        self._stop_stepper.set()
        with self._wake:
            self._wake.notify_all()
        if self.stepper_thread.is_alive():
            self.stepper_thread.join(timeout=60)
        deadline = time.monotonic() + self.cfg.shutdown_grace_s
        while time.monotonic() < deadline:
            with self._gate:
                if self._busy == 0:
                    break
            time.sleep(0.01)
        engine = self.service.engine
        if engine.ckpt is not None:
            # stepper stopped + in-flight drained: the lock is a
            # formality, the snapshot a step-boundary-consistent image
            with self._engine_lock:
                engine.snapshot()
            print("[serve] final snapshot cut", flush=True)
        tracer = engine.tracer
        if tracer.enabled and tracer.default_path:
            print(f"[serve] trace -> {engine.trace_export()}", flush=True)
        self.httpd.server_close()

    def serve(self):
        """Blocking: stepper + listener until shutdown, then finalize."""
        self.stepper_thread.start()
        host, port = self.httpd.server_address[:2]
        print(f"[serve] listening on http://{host}:{port}", flush=True)
        try:
            self.httpd.serve_forever()
        finally:
            self.finalize()


def _make_handler(fe: Frontend):
    """Build the request-handler class closed over one Frontend."""
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    cfg = fe.cfg

    class Handler(BaseHTTPRequestHandler):
        # hard floor against clients that stall mid-request: socket ops
        # (header/body reads, reply writes) error out past this
        timeout = max(cfg.deadline_s, cfg.wait_max_s) + 30.0
        protocol_version = "HTTP/1.1"

        # ------------------------------------------------- reply plumbing
        def _finish_request(self, code: int):
            endpoint = self.path.split("?", 1)[0]
            fe._c_requests("http_requests_total", "HTTP requests served",
                           endpoint=endpoint, status=code).inc()
            dt = time.perf_counter() - self._t0
            fe._h_request.observe(dt)
            if cfg.verbose:
                print(json.dumps(
                    {"method": self.command, "path": self.path,
                     "status": code,
                     "duration_ms": round(dt * 1000, 3)}), flush=True)

        def _reply(self, payload, code=200, retry_after=None):
            # chaos: a torn reply — the fault raises AFTER the handler
            # committed to this payload but BEFORE any byte went out,
            # which is when a flaky network drops a response. Delivery
            # marks (mark_fetched) only happen after a clean write, so
            # the client retries and nothing is lost.
            fe.faults.trip("http_reply", key=self.path.split("?", 1)[0])
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(retry_after))))
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            self._finish_request(code)

        def _reply_text(self, text: str, code=200,
                        ctype="text/plain; version=0.0.4"):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._finish_request(code)

        def log_request(self, *a):       # replaced by the JSON access log
            pass

        def log_message(self, fmt, *a):
            if cfg.verbose:
                import sys
                print(f"[serve] {fmt % a}", file=sys.stderr, flush=True)

        # ------------------------------------------------- error envelope
        def _guarded(self, fn):
            """Run a handler body; every failure becomes exactly one
            enveloped JSON reply (or, for an injected http_reply fault,
            a torn connection — the chaos the failpoint exists for).

            Maps the exception to (payload, status, retry_after) first
            and sends in one guarded place, so the error reply itself
            tearing (injected fault, client gone) can't leak a
            traceback out of the handler."""
            retry = None
            try:
                fn()
                return
            except ApiError as e:
                payload, code, retry = e.payload(), e.http_status, \
                    e.retry_after
            except InjectedFault:
                # simulate the reply never arriving: abort the
                # connection without a response
                self.close_connection = True
                return
            except QueueFullError as e:
                fe._c_shed("serve_shed_total", "requests shed by the "
                           "front door", code="queue_full").inc()
                payload, code = {"error": str(e),
                                 "code": "queue_full"}, 429
                retry = fe.retry_after_s()
            except MemoryBudgetError as e:
                fe._c_shed("serve_shed_total", "requests shed by the "
                           "front door", code="memory_budget").inc()
                payload, code = {"error": str(e),
                                 "code": "memory_budget"}, 503
                retry = fe.retry_after_s(memory=True)
            except (KeyError, TypeError, ValueError) as e:
                # semantic rejections out of the engine (unknown
                # objective, bad seed range, ...) — client error
                payload, code = {"error": str(e),
                                 "code": "bad_request"}, 400
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True     # client went away
                return
            except Exception as e:   # noqa: BLE001 — wire boundary
                payload, code = {"error": f"internal error: {e}",
                                 "code": "internal"}, 500
            try:
                self._reply(payload, code, retry_after=retry)
            except (InjectedFault, BrokenPipeError,
                    ConnectionResetError):
                self.close_connection = True

        # -------------------------------------------------- auth + limits
        def _tenant(self):
            """Authenticate + rate-limit (None when auth is off)."""
            if cfg.tenants is None:
                return None
            tenant = cfg.tenants.authenticate(
                self.headers.get("Authorization"))
            fe._c_requests("serve_tenant_requests_total",
                           "authenticated requests per tenant",
                           tenant=tenant.name).inc()
            try:
                cfg.tenants.check_rate(tenant)
            except ApiError:
                fe._c_requests("serve_tenant_rate_limited_total",
                               "rate-limited requests per tenant",
                               tenant=tenant.name).inc()
                raise
            return tenant

        # ------------------------------------------------------- requests
        def _deadline(self, extra: float = 0.0) -> float:
            return self._t0_mono + cfg.deadline_s + extra

        def _wait_s(self, q) -> float:
            raw = q.get("wait", ["0"])[0]
            try:
                wait = float(raw)
            except ValueError:
                raise ApiError(400, "bad_request",
                               f"field 'wait': expected seconds, got "
                               f"{raw!r}") from None
            if wait < 0:
                raise ApiError(400, "bad_request",
                               f"field 'wait': must be >= 0, got {wait}")
            return min(wait, cfg.wait_max_s)

        def _refuse_if_stopping(self):
            if fe._stopping:
                raise ApiError(503, "shutting_down",
                               "server is shutting down",
                               retry_after=fe.retry_after_s())

        def do_GET(self):
            self._t0 = time.perf_counter()
            self._t0_mono = time.monotonic()
            with fe._gate:
                fe._busy += 1
            try:
                self._guarded(self._get)
            finally:
                with fe._gate:
                    fe._busy -= 1

        def _get(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            job_id = q.get("job_id", [""])[0]

            # liveness endpoints FIRST and lock-free: a probe must
            # answer even while the engine grinds a long fused step
            if url.path == "/healthz":
                status = "shutting_down" if fe._stopping else "ok"
                return self._reply({"status": status, **fe._health})
            if url.path == "/metrics":
                return self._reply_text(self._render_metrics())

            self._refuse_if_stopping()
            self._tenant()
            svc = fe.service
            if url.path == "/poll":
                wait = self._wait_s(q)
                if wait > 0:
                    out = fe.wait_for(job_id, svc.poll, wait,
                                      self._deadline(wait))
                else:
                    with fe.engine_slot(self._deadline()):
                        out = svc.poll(job_id)
                self._reply(out, status_for(out))
            elif url.path == "/result":
                wait = self._wait_s(q)

                def fetch(jid):
                    return svc.result(jid, mark_fetched=False)

                if wait > 0:
                    out = fe.wait_for(job_id, fetch, wait,
                                      self._deadline(wait))
                else:
                    with fe.engine_slot(self._deadline()):
                        out = fetch(job_id)
                self._reply(out, status_for(out))
                if out.get("status") == "done":
                    # only a reply that actually went out is delivery —
                    # an http_reply fault or broken pipe above skipped
                    # us, so the snapshot GC can't evict an undelivered
                    # solution
                    self._mark_fetched(job_id)
            elif url.path == "/stats":
                with fe.engine_slot(self._deadline()):
                    out = svc.stats()
                self._reply(out)
            else:
                self._reply({"error": "unknown endpoint",
                             "code": "unknown_endpoint"}, 404)

        def _mark_fetched(self, job_id: str):
            # best-effort bookkeeping: a contended lock just delays
            # solution-vector GC, it must not fail a delivered reply
            if fe._engine_lock.acquire(timeout=5.0):
                try:
                    fe.service.mark_fetched(job_id)
                finally:
                    fe._engine_lock.release()

        def _render_metrics(self) -> str:
            """Registry text, engine gauges refreshed only if the
            engine lock is free RIGHT NOW — scrape liveness beats gauge
            freshness (counters/histograms are always current)."""
            eng = fe.service.engine
            if fe._engine_lock.acquire(blocking=False):
                try:
                    eng._refresh_gauges()
                finally:
                    fe._engine_lock.release()
            return eng.metrics.render_prometheus()

        def _read_body(self) -> dict:
            h = self.headers.get("Content-Length")
            if h is None:
                # any body bytes in flight will never be drained, so
                # the reply must also end the connection (same for the
                # bad-length and too-large rejections below)
                self.close_connection = True
                raise ApiError(411, "length_required",
                               "POST requires Content-Length")
            try:
                length = int(h)
            except ValueError:
                self.close_connection = True
                raise ApiError(400, "bad_length",
                               f"bad Content-Length {h!r}") from None
            if length < 0:
                self.close_connection = True
                raise ApiError(400, "bad_length",
                               f"negative Content-Length {length}")
            if length > cfg.max_body_bytes:
                # don't read it; the client may still be sending, so
                # the connection closes with the reply
                self.close_connection = True
                raise ApiError(413, "body_too_large",
                               f"request body {length} bytes exceeds the "
                               f"{cfg.max_body_bytes}-byte cap")
            # chaos: a slow client trickling its upload sleeps HERE, in
            # its own connection thread — everyone else keeps moving
            fe.faults.trip("slow_client", key=self.path)
            raw = self.rfile.read(length) if length else b"{}"
            try:
                return json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                raise ApiError(400, "bad_json",
                               f"bad json: {e}") from None

        def do_POST(self):
            self._t0 = time.perf_counter()
            self._t0_mono = time.monotonic()
            with fe._gate:
                fe._busy += 1
            try:
                self._guarded(self._post)
            finally:
                with fe._gate:
                    fe._busy -= 1

        def _post(self):
            self._refuse_if_stopping()
            req = self._read_body()
            tenant = self._tenant()
            svc = fe.service
            if self.path == "/submit":
                validate_submit(req, max_n=cfg.max_n)
                with fe.engine_slot(self._deadline()):
                    if tenant is not None:
                        cfg.tenants.check_quota(tenant)
                    out = svc.submit(req)
                    if tenant is not None:
                        cfg.tenants.charge_job(tenant)
                        fe._c_requests("serve_tenant_jobs_total",
                                       "jobs accepted per tenant",
                                       tenant=tenant.name).inc()
                fe.kick()                # wake the stepper: work landed
                self._reply(out)
            elif self.path == "/cancel":
                job_id = validate_cancel(req)
                with fe.engine_slot(self._deadline()):
                    out = svc.cancel(job_id)
                self._reply(out, status_for(out))
            else:
                self._reply({"error": "unknown endpoint",
                             "code": "unknown_endpoint"}, 404)

    return Handler
