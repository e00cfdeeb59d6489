"""Supervisor + router: N journaled engine workers, one front door.

    PYTHONPATH=src python -m repro_torch.serve.router \
        --workers 2 --http 8080 --ckpt-dir results/cluster
    PYTHONPATH=src python -m repro_torch.serve.router \
        --workers 2 --ckpt-dir results/cluster --device cpu

Port of :mod:`repro.serve.router`. Each worker is a
``repro_torch.serve.worker`` process with its engine on the card (or on
the router's ``--device``, passed on to every worker). It scales the
serving tier past one process and makes worker death a non-event:

- **Per-family routing.** ``/submit`` routes on
  ``crc32(objective) % N`` — every job of a family lands on the same
  worker, so compiled executable families stay hot instead of being
  re-built N times. Job ids come back prefixed (``w0:job-000123``);
  the prefix IS the routing table for /poll, /result and /cancel — the
  router holds no job state at all, which is why it cannot lose any.
- **Supervision.** Each worker owns a journaled checkpoint directory
  (``<ckpt-dir>/w<i>``). A supervisor thread watches process liveness
  and ``/healthz``; a dead worker is respawned (exponential backoff on
  crash loops) and comes back through fsck ``--repair`` + journal
  resume — every submission it ever acked re-runs deterministically,
  bit-identical. Nothing is lost, nothing is duplicated (replay is
  keyed by the journal's job ids, not by re-submission).
- **Client-visible retry semantics.** While a worker is down its
  requests answer 503 ``worker_unavailable`` with a ``Retry-After``
  sized to observed restart time — clients poll-retry the same
  prefixed id until the resumed worker answers. Submits for a downed
  family shed the same way (routing is sticky; queueing them in the
  router would silently unbound its memory).
- **Aggregated observability.** ``/metrics`` scrapes every live
  worker, stamps each sample with a ``worker="wN"`` label, merges, and
  appends the router's own metrics (restarts, proxy errors, shed
  counts). ``/healthz`` is lock-free and reports per-worker liveness.

Auth/rate/quota (``--auth``) run at the router; workers listen
unauthenticated on localhost ephemeral ports published via port files.
Chaos: ``--inject-worker I:SPEC`` arms one worker's fault registry for
its FIRST life only (e.g. ``0:worker_crash:nth=3:kind=kill`` — the CI
smoke kills worker 0 at its 3rd step and asserts zero lost jobs);
respawns come up clean, which is what makes the experiment converge.

Transport failures are one answer. The reference's ``proxy`` and
``probe`` catch only ``OSError``; a worker killed while it writes a reply
makes ``resp.read()`` raise ``http.client.IncompleteRead``, an
``HTTPException``. In ``proxy`` that fell through to a 500; in ``probe``
it ended the supervisor thread, so the killed worker was never respawned
and its acked jobs never delivered. Here ``proxy`` answers the deliberate
503, ``probe`` reads the worker as unhealthy, and the supervisor logs any
other error and carries on.

Stdlib + repro_torch.obs/repro_torch.serve only — importing this module
never pays for torch; the workers do that in their own processes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import zlib

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.errors import ApiError
from repro_torch.serve.limits import TenantTable

# a first bind pays a cold torch import, the CUDA context and a resume on
# the card: 5.9-12.9 s for the port's solve_server children on an H100
# (PERF.md), so this leaves a wide margin
_WORKER_TIMEOUT = 120.0


class WorkerHandle:
    """One supervised worker process: spawn, port discovery, respawn."""

    def __init__(self, index: int, ckpt_dir: str | pathlib.Path,
                 spawn_args: list[str]):
        self.index = index
        self.name = f"w{index}"
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.spawn_args = list(spawn_args)
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.restarts = 0
        self.healthy = False
        self.last_spawn = 0.0
        self.not_before = 0.0        # crash-loop backoff gate
        self._lock = threading.Lock()

    @property
    def port_file(self) -> pathlib.Path:
        return self.ckpt_dir / "port"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def command(self, extra_args: tuple[str, ...] = ()) -> list[str]:
        """The worker's command line."""
        return [sys.executable, "-m", "repro_torch.serve.worker",
                "--ckpt-dir", str(self.ckpt_dir),
                "--port", "0", "--port-file", str(self.port_file),
                *self.spawn_args, *extra_args]

    def spawn(self, extra_args: tuple[str, ...] = ()):
        """Start the worker and wait for its port publication."""
        with self._lock:
            self.port = None
            self.healthy = False
            self.port_file.unlink(missing_ok=True)
            cmd = self.command(extra_args)
            self.last_spawn = time.monotonic()
            self.proc = subprocess.Popen(cmd, env=os.environ.copy())
        deadline = time.monotonic() + _WORKER_TIMEOUT
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return                   # died during startup; the
                #                          supervisor owns the retry
            try:
                port = int(self.port_file.read_text().strip())
            except (FileNotFoundError, ValueError):
                time.sleep(0.05)
                continue
            with self._lock:
                self.port = port
                self.healthy = True
            return

    def probe(self, timeout: float = 2.0) -> bool:
        """GET /healthz; False on any failure (the supervisor decides
        what unhealthy means — probing never throws)."""
        if self.port is None:
            return False
        import http.client
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=timeout)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                ok = resp.status == 200
                resp.read()
                return ok
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            return False

    def terminate(self, grace_s: float = 15.0):
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()        # SIGTERM -> final snapshot
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class Router:
    """HTTP front door over a set of :class:`WorkerHandle` s."""

    def __init__(self, workers: list[WorkerHandle], port: int = 0,
                 tenants: TenantTable | None = None,
                 max_body_bytes: int = 1 << 20,
                 proxy_timeout_s: float = 35.0,
                 probe_s: float = 0.5, verbose: bool = False):
        from http.server import ThreadingHTTPServer

        self.workers = workers
        self.tenants = tenants
        self.max_body_bytes = max_body_bytes
        self.proxy_timeout_s = proxy_timeout_s
        self.probe_s = probe_s
        self.verbose = verbose
        self._by_name = {w.name: w for w in workers}
        self._stopping = False
        self._stop = threading.Event()
        self.metrics = MetricsRegistry()
        self._c_requests = self.metrics.counter
        self._c_restarts = self.metrics.counter
        self._c_proxy_err = self.metrics.counter
        self.metrics.gauge("router_workers",
                           "supervised worker count").set(len(workers))
        # restart-time EWMA feeds worker_unavailable Retry-After
        self._restart_ewma = 5.0
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                         _make_router_handler(self))
        self.supervisor_thread = threading.Thread(
            target=self._supervise, name="router-supervisor", daemon=True)

    # ---------------------------------------------------------- lifecycle
    def spawn_all(self, inject: dict[int, str] | None = None):
        """Start every worker in parallel (cold torch imports overlap);
        ``inject`` arms worker index -> fault spec for the FIRST life."""
        inject = inject or {}
        threads = []
        for w in self.workers:
            extra = ()
            if w.index in inject:
                extra = ("--inject", inject[w.index])
            t = threading.Thread(target=w.spawn, args=(extra,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    def _supervise(self):
        """Liveness loop: respawn dead workers (backoff on crash
        loops), demote unhealthy ones so routing sheds fast."""
        while not self._stop.is_set():
            now = time.monotonic()
            for w in self.workers:
                if self._stop.is_set():
                    return
                # one worker's failure must not end the loop: a dead
                # supervisor would make every later worker death final
                try:
                    self._supervise_one(w, now)
                except Exception as e:   # noqa: BLE001 — logged, retried
                    print(f"[router] supervising {w.name} failed: {e!r}",
                          file=sys.stderr, flush=True)
            self._stop.wait(self.probe_s)

    def _supervise_one(self, w: WorkerHandle, now: float):
        """One supervisor tick for ``w``: respawn it if it died (past its
        backoff), else refresh its health."""
        if w.proc is not None and not w.alive():
            if now < w.not_before:
                return                  # still in backoff
            code = w.proc.returncode
            uptime = now - w.last_spawn
            w.restarts += 1
            self._c_restarts(
                "router_worker_restarts_total",
                "supervised worker respawns",
                worker=w.name).inc()
            # fast deaths back off exponentially; a worker that ran a
            # while restarts immediately
            strikes = w.restarts if uptime < 5.0 else 0
            w.not_before = now + min(0.2 * (2 ** strikes), 5.0)
            print(f"[router] {w.name} died (exit {code}, up "
                  f"{uptime:.1f}s) — respawn #{w.restarts}", flush=True)
            t0 = time.monotonic()
            w.spawn()                   # clean life: no inject args
            if w.port is not None:
                dt = time.monotonic() - t0
                self._restart_ewma = 0.5 * self._restart_ewma + 0.5 * dt
        elif w.alive():
            w.healthy = w.probe()

    def begin_shutdown(self, reason: str = "signal"):
        if self._stopping:
            return
        self._stopping = True
        print(f"[router] shutting down ({reason})", flush=True)
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    def serve(self):
        self.supervisor_thread.start()
        host, port = self.httpd.server_address[:2]
        print(f"[router] listening on http://{host}:{port} with "
              f"{len(self.workers)} worker(s)", flush=True)
        try:
            self.httpd.serve_forever()
        finally:
            self._stop.set()
            self.supervisor_thread.join(timeout=10)
            for w in self.workers:
                w.terminate()
            self.httpd.server_close()

    # ------------------------------------------------------------ routing
    def worker_for_family(self, objective: str) -> WorkerHandle:
        """Sticky per-family placement: compiled executables stay hot."""
        idx = zlib.crc32(objective.encode()) % len(self.workers)
        return self.workers[idx]

    def worker_for_job(self, job_id: str) -> tuple[WorkerHandle, str]:
        """``w0:job-000123`` -> (handle, ``job-000123``) or 404."""
        name, sep, raw = job_id.partition(":")
        w = self._by_name.get(name) if sep else None
        if w is None or not raw:
            raise ApiError(404, "unknown_job",
                           f"unknown job {job_id!r} (expected a "
                           "router-issued id like 'w0:job-000123')",
                           job_id=job_id, status="unknown")
        return w, raw

    def retry_after_s(self) -> int:
        return min(max(1, math.ceil(self._restart_ewma)), 60)

    def proxy(self, w: WorkerHandle, method: str, path: str,
              body: bytes | None = None, headers: dict | None = None,
              timeout: float | None = None):
        """Forward one request; (status, payload_bytes, retry_after).

        Any transport failure — refused, reset, timed out, a reply cut
        short (``IncompleteRead``) or garbled (``BadStatusLine``), worker
        mid-restart — is one deliberate answer: 503 ``worker_unavailable``
        with a Retry-After from observed restart times."""
        import http.client
        port = w.port
        if port is None or not w.alive():
            raise ApiError(503, "worker_unavailable",
                           f"worker {w.name} is restarting",
                           retry_after=self.retry_after_s())
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", port,
                timeout=timeout or self.proxy_timeout_s)
            try:
                conn.request(method, path, body=body,
                             headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, data, resp.getheader("Retry-After")
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            self._c_proxy_err("router_proxy_errors_total",
                              "proxied requests that failed in "
                              "transport", worker=w.name).inc()
            raise ApiError(503, "worker_unavailable",
                           f"worker {w.name} did not answer",
                           retry_after=self.retry_after_s()) from None

    def prefix_job_id(self, w: WorkerHandle, payload: dict) -> dict:
        if isinstance(payload, dict) and isinstance(
                payload.get("job_id"), str):
            payload["job_id"] = f"{w.name}:{payload['job_id']}"
        return payload

    # ------------------------------------------------------- aggregation
    def aggregate_metrics(self) -> str:
        """Merge worker /metrics (each sample stamped ``worker="wN"``)
        with the router's own registry."""
        help_type: dict[str, list[str]] = {}
        samples: list[str] = []
        for w in self.workers:
            if not w.alive() or w.port is None:
                continue
            try:
                status, data, _ = self.proxy(w, "GET", "/metrics",
                                             timeout=5.0)
            except ApiError:
                continue
            if status != 200:
                continue
            for line in data.decode().splitlines():
                if not line:
                    continue
                if line.startswith("#"):
                    # one HELP/TYPE block per family, first wins
                    parts = line.split(None, 3)
                    if len(parts) >= 3:
                        block = help_type.setdefault(parts[2], [])
                        if line not in block:
                            block.append(line)
                    continue
                samples.append(_stamp_worker(line, w.name))
        lines = []
        for fam in help_type:
            lines.extend(help_type[fam])
        lines.extend(samples)
        lines.append(self.metrics.render_prometheus().rstrip("\n"))
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        """Lock-free: reads only handle attributes."""
        workers = {}
        degraded = False
        for w in self.workers:
            alive = w.alive()
            workers[w.name] = {"alive": alive, "healthy": w.healthy,
                               "restarts": w.restarts, "port": w.port}
            degraded = degraded or not (alive and w.healthy)
        status = ("shutting_down" if self._stopping else
                  "degraded" if degraded else "ok")
        return {"status": status, "workers": workers}


def _stamp_worker(sample: str, worker: str) -> str:
    """``name{a="b"} v`` -> ``name{a="b",worker="w0"} v``."""
    metric, _, value = sample.rpartition(" ")
    if not metric:
        return sample
    if metric.endswith("}"):
        return f'{metric[:-1]},worker="{worker}"}} {value}'
    return f'{metric}{{worker="{worker}"}} {value}'


def _make_router_handler(rt: Router):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlencode, urlparse

    class Handler(BaseHTTPRequestHandler):
        timeout = rt.proxy_timeout_s + 90.0
        protocol_version = "HTTP/1.1"

        def log_request(self, *a):
            pass

        def log_message(self, fmt, *a):
            if rt.verbose:
                print(f"[router] {fmt % a}", file=sys.stderr, flush=True)

        def _reply(self, payload, code=200, retry_after=None):
            body = json.dumps(payload).encode()
            self._reply_bytes(body, code, "application/json",
                              retry_after)

        def _reply_bytes(self, body: bytes, code: int, ctype: str,
                         retry_after=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(float(retry_after)))))
            self.end_headers()
            self.wfile.write(body)
            endpoint = self.path.split("?", 1)[0]
            rt._c_requests("router_requests_total",
                           "requests through the router",
                           endpoint=endpoint, status=code).inc()
            if rt.verbose:
                print(json.dumps({"router": True, "method": self.command,
                                  "path": self.path, "status": code}),
                      flush=True)

        def _guarded(self, fn):
            try:
                fn()
                return
            except ApiError as e:
                payload, code, retry = e.payload(), e.http_status, \
                    e.retry_after
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
                return
            except Exception as e:   # noqa: BLE001 — wire boundary
                payload, code, retry = {"error": f"internal error: {e}",
                                        "code": "internal"}, 500, None
            try:
                self._reply(payload, code, retry_after=retry)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _forward(self, w, method, path, body=None):
            """Proxy + envelope passthrough + job-id re-prefixing."""
            headers = {"Content-Type": "application/json"}
            status, data, retry = rt.proxy(w, method, path, body=body,
                                           headers=headers)
            try:
                payload = rt.prefix_job_id(w, json.loads(data))
            except (json.JSONDecodeError, UnicodeDecodeError):
                payload = {"error": "worker returned a non-JSON reply",
                           "code": "internal"}
                status = 500
            self._reply(payload, status, retry_after=retry)

        def _tenant(self):
            if rt.tenants is None:
                return None
            tenant = rt.tenants.authenticate(
                self.headers.get("Authorization"))
            rt.tenants.check_rate(tenant)
            return tenant

        def _refuse_if_stopping(self):
            if rt._stopping:
                raise ApiError(503, "shutting_down",
                               "router is shutting down",
                               retry_after=rt.retry_after_s())

        def _read_body(self) -> bytes:
            h = self.headers.get("Content-Length")
            if h is None:
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
            if length > rt.max_body_bytes:
                self.close_connection = True
                raise ApiError(413, "body_too_large",
                               f"request body {length} bytes exceeds "
                               f"the {rt.max_body_bytes}-byte cap")
            return self.rfile.read(length) if length else b"{}"

        def do_GET(self):
            self._guarded(self._get)

        def _get(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/healthz":
                return self._reply(rt.health())
            if url.path == "/metrics":
                return self._reply_bytes(
                    rt.aggregate_metrics().encode(), 200,
                    "text/plain; version=0.0.4")
            self._refuse_if_stopping()
            self._tenant()
            if url.path in ("/poll", "/result"):
                w, raw = rt.worker_for_job(q.get("job_id", [""])[0])
                fq = {"job_id": raw}
                timeout = rt.proxy_timeout_s
                if "wait" in q:
                    fq["wait"] = q["wait"][0]
                    try:
                        timeout += max(float(fq["wait"]), 0.0)
                    except ValueError:
                        pass             # the worker 400s it
                self._forward(w, "GET",
                              f"{url.path}?{urlencode(fq)}")
            elif url.path == "/stats":
                out = {}
                for w in rt.workers:
                    try:
                        status, data, _ = rt.proxy(w, "GET", "/stats")
                        out[w.name] = (json.loads(data) if status == 200
                                       else {"error": f"status {status}"})
                    except ApiError as e:
                        out[w.name] = e.payload()
                self._reply({"workers": out})
            else:
                self._reply({"error": "unknown endpoint",
                             "code": "unknown_endpoint"}, 404)

        def do_POST(self):
            self._guarded(self._post)

        def _post(self):
            self._refuse_if_stopping()
            raw = self._read_body()
            tenant = self._tenant()
            try:
                req = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                raise ApiError(400, "bad_json",
                               f"bad json: {e}") from None
            if self.path == "/submit":
                obj = req.get("objective") if isinstance(req, dict) \
                    else None
                if not isinstance(obj, str) or not obj:
                    # shape-only gate; the worker owns full validation
                    raise ApiError(400, "bad_request",
                                   "field 'objective': required (a "
                                   "string) — routing is per-family")
                if tenant is not None:
                    rt.tenants.check_quota(tenant)
                w = rt.worker_for_family(obj)
                headers = {"Content-Type": "application/json"}
                status, data, retry = rt.proxy(w, "POST", "/submit",
                                               body=raw,
                                               headers=headers)
                payload = rt.prefix_job_id(w, json.loads(data))
                if status == 200 and tenant is not None:
                    rt.tenants.charge_job(tenant)
                self._reply(payload, status, retry_after=retry)
            elif self.path == "/cancel":
                job_id = req.get("job_id") if isinstance(req, dict) \
                    else None
                if not isinstance(job_id, str) or not job_id:
                    raise ApiError(400, "bad_request",
                                   "field 'job_id': required (a job id "
                                   "string)")
                w, raw_id = rt.worker_for_job(job_id)
                self._forward(w, "POST", "/cancel",
                              body=json.dumps(
                                  {"job_id": raw_id}).encode())
            else:
                self._reply({"error": "unknown endpoint",
                             "code": "unknown_endpoint"}, 404)

    return Handler


def serve_router(workers: int, port: int, ckpt_dir: str,
                 worker_args: list[str] | None = None,
                 tenants: TenantTable | None = None,
                 max_body_bytes: int = 1 << 20,
                 inject: dict[int, str] | None = None,
                 port_file: str | None = None,
                 verbose: bool = False) -> Router:
    """Spawn the fleet, serve until SIGTERM/SIGINT, terminate cleanly."""
    base = pathlib.Path(ckpt_dir)
    handles = [WorkerHandle(i, base / f"w{i}", worker_args or [])
               for i in range(workers)]
    rt = Router(handles, port=port, tenants=tenants,
                max_body_bytes=max_body_bytes, verbose=verbose)
    if port_file:
        from repro_torch.serve.worker import _write_port_file
        _write_port_file(port_file, rt.httpd.server_address[1])
    # handlers first: a SIGTERM during the (slow, torch-importing) fleet
    # spawn must still shut down cleanly
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda signum, frame:
                          rt.begin_shutdown(f"signal {signum}"))
    rt.spawn_all(inject=inject)
    rt.serve()
    return rt


def _parse_inject_worker(specs: list[str]) -> dict[int, str]:
    out: dict[int, str] = {}
    for item in specs:
        idx, sep, spec = item.partition(":")
        if not sep or not spec:
            raise ValueError(
                f"--inject-worker wants IDX:SPEC, got {item!r}")
        try:
            i = int(idx)
        except ValueError:
            raise ValueError(
                f"--inject-worker index must be an int, got "
                f"{idx!r}") from None
        out[i] = spec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.router")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="router listen port (0 = ephemeral; see "
                         "--port-file)")
    ap.add_argument("--ckpt-dir", required=True,
                    help="parent directory; each worker owns "
                         "<ckpt-dir>/w<i>")
    ap.add_argument("--port-file", default=None,
                    help="publish the router's bound port here")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--journal-every", type=int, default=8)
    ap.add_argument("--retain-done", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--memory-budget", type=int, default=None)
    ap.add_argument("--auth", default=None, metavar="SPEC",
                    help="tenant spec (token[:key=val]*[;...]) enforced "
                         "at the router; workers stay unauthenticated "
                         "on localhost")
    ap.add_argument("--max-body", type=int, default=1 << 20)
    ap.add_argument("--inject-worker", action="append", default=[],
                    metavar="IDX:SPEC",
                    help="arm worker IDX's fault registry for its first "
                         "life (respawns come up clean), e.g. "
                         "0:worker_crash:nth=3:kind=kill")
    ap.add_argument("--device", default=None,
                    help="each worker's torch device (default: the card; "
                         "'cpu' runs the workers' engines on the CPU)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.workers < 1:
        ap.error(f"--workers must be >= 1, got {args.workers}")
    tenants = None
    if args.auth:
        try:
            tenants = TenantTable.from_spec(args.auth)
        except ValueError as e:
            ap.error(f"--auth: {e}")
    try:
        inject = _parse_inject_worker(args.inject_worker)
    except ValueError as e:
        ap.error(str(e))
    bad = [i for i in inject if not 0 <= i < args.workers]
    if bad:
        ap.error(f"--inject-worker index(es) {bad} out of range for "
                 f"--workers {args.workers}")

    worker_args = ["--lanes", str(args.lanes),
                   "--journal-every", str(args.journal_every)]
    if args.retain_done is not None:
        worker_args += ["--retain-done", str(args.retain_done)]
    if args.max_queue is not None:
        worker_args += ["--max-queue", str(args.max_queue)]
    if args.memory_budget is not None:
        worker_args += ["--memory-budget", str(args.memory_budget)]
    if args.device is not None:
        worker_args += ["--device", args.device]
    if args.verbose:
        worker_args += ["--verbose"]

    serve_router(args.workers, args.http, args.ckpt_dir,
                 worker_args=worker_args, tenants=tenants,
                 max_body_bytes=args.max_body, inject=inject,
                 port_file=args.port_file, verbose=args.verbose)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
