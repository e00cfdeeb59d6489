"""The port's router and supervisor (``repro_torch.serve.router``).

Units as in the reference's router tests (id prefixing, metric stamping,
inject-spec parsing, routing, health, CLI validation, a torch-free
import), the worker command line (``repro_torch.serve.worker`` with the
router's ``--device``), a fake worker that cuts its reply short (the
router answers 503 ``worker_unavailable``, not 500, and its supervisor
reads the worker as unhealthy and goes on supervising), and the reference's
two-worker chaos test run against the port's workers on the CPU: one
worker killed mid-traffic by an injected ``worker_crash``, supervised
restart, journal resume, zero lost acked jobs, only deliberate sheds, and
every delivered fun, x and history bit for bit the port's
``abo_minimize``.

Every HTTP call and thread join has its own timeout.
"""
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.abo import ABOConfig, abo_minimize
from repro_torch.objectives import OBJECTIVES
from repro_torch.serve import router as router_mod
from repro_torch.serve.errors import ApiError
from repro_torch.serve.router import (Router, WorkerHandle,
                                      _parse_inject_worker, _stamp_worker,
                                      main as router_main)

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = {"samples_per_pass": 12, "n_passes": 3}
HTTP_TIMEOUT = 60


# ------------------------------------------------------------------ units
def test_stamp_worker():
    assert _stamp_worker("engine_steps_total 5.0", "w0") == \
        'engine_steps_total{worker="w0"} 5.0'
    assert _stamp_worker('c{site="x"} 1.0', "w1") == \
        'c{site="x",worker="w1"} 1.0'
    assert _stamp_worker("", "w0") == ""


def test_parse_inject_worker():
    assert _parse_inject_worker([]) == {}
    assert _parse_inject_worker(["0:worker_crash:nth=3:kind=kill"]) == \
        {0: "worker_crash:nth=3:kind=kill"}
    assert _parse_inject_worker(["1:a:b", "0:c"]) == {1: "a:b", 0: "c"}
    for bad in (["worker_crash"], ["0:"], ["x:spec"]):
        with pytest.raises(ValueError):
            _parse_inject_worker(bad)


def _dummy_router(n=2, spawn_args=()):
    handles = [WorkerHandle(i, f"/nonexistent/w{i}", list(spawn_args))
               for i in range(n)]
    return Router(handles, port=0)


def test_worker_for_job_and_family_routing():
    rt = _dummy_router()
    try:
        w, raw = rt.worker_for_job("w1:job-000007")
        assert w.name == "w1" and raw == "job-000007"
        for bad in ("job-000007", "w9:job-1", "w0:", "", "w0"):
            with pytest.raises(ApiError) as ei:
                rt.worker_for_job(bad)
            assert ei.value.http_status == 404
            assert ei.value.code == "unknown_job"
            assert ei.value.status == "unknown"
        placement = {name: rt.worker_for_family(name).index
                     for name in OBJECTIVES}
        assert placement == {name: rt.worker_for_family(name).index
                             for name in OBJECTIVES}
        assert set(placement.values()) == {0, 1}
        # the placement the chip smoke's router phase relies on
        assert placement["shifted_sphere"] == 0
        assert {placement[k] for k in ("griewank", "sphere",
                                       "rastrigin")} == {1}
    finally:
        rt.httpd.server_close()


def test_router_health_reports_dead_workers():
    rt = _dummy_router()
    try:
        h = rt.health()
        assert h["status"] == "degraded"
        assert set(h["workers"]) == {"w0", "w1"}
        assert h["workers"]["w0"]["alive"] is False
    finally:
        rt.httpd.server_close()


def test_router_cli_validation():
    with pytest.raises(SystemExit):
        router_main(["--workers", "0", "--ckpt-dir", "/tmp/x"])
    with pytest.raises(SystemExit):          # inject index out of range
        router_main(["--workers", "2", "--ckpt-dir", "/tmp/x",
                     "--inject-worker", "5:worker_crash:nth=1"])
    with pytest.raises(SystemExit):          # malformed inject spec
        router_main(["--workers", "2", "--ckpt-dir", "/tmp/x",
                     "--inject-worker", "nope"])
    with pytest.raises(SystemExit):          # bad auth spec
        router_main(["--workers", "1", "--ckpt-dir", "/tmp/x",
                     "--auth", "tok:zzz=1"])


def test_router_import_is_torch_free():
    """The router supervises torch processes; it is not one."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; import repro_torch.serve.router; "
         "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]; "
         "assert not bad, bad"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_worker_command_line_names_the_port_and_its_device(monkeypatch):
    got = {}

    def fake_serve_router(workers, port, ckpt_dir, worker_args=None,
                          **kw):
        got.update(workers=workers, port=port, ckpt_dir=ckpt_dir,
                   worker_args=worker_args, **kw)

    monkeypatch.setattr(router_mod, "serve_router", fake_serve_router)
    assert router_main(["--workers", "2", "--ckpt-dir", "/tmp/x",
                        "--lanes", "3", "--journal-every", "2",
                        "--device", "cpu", "--inject-worker",
                        "0:worker_crash:nth=2:kind=kill"]) == 0
    assert got["worker_args"] == ["--lanes", "3", "--journal-every", "2",
                                  "--device", "cpu"]
    assert got["inject"] == {0: "worker_crash:nth=2:kind=kill"}
    cmd = WorkerHandle(0, "/tmp/x/w0", got["worker_args"]).command(
        ("--inject", "worker_crash:nth=2:kind=kill"))
    assert cmd[:3] == [sys.executable, "-m", "repro_torch.serve.worker"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--ckpt-dir") + 1] == "/tmp/x/w0"
    assert cmd[-2:] == ["--inject", "worker_crash:nth=2:kind=kill"]
    # the solve_server --workers path builds the same worker arguments
    from repro_torch.launch import solve_server
    got.clear()
    assert solve_server.main(["--http", "0", "--workers", "2",
                              "--ckpt-dir", "/tmp/x", "--lanes", "3",
                              "--journal-every", "2", "--device",
                              "cpu"]) is None
    assert got["workers"] == 2 and got["ckpt_dir"] == "/tmp/x"
    assert got["worker_args"] == ["--lanes", "3", "--journal-every", "2",
                                  "--device", "cpu"]


def test_worker_refuses_more_than_one_device(tmp_path, capsys):
    from repro_torch.serve import worker
    with pytest.raises(SystemExit) as e:
        worker.main(["--ckpt-dir", str(tmp_path), "--devices", "2",
                     "--device", "cpu"])
    assert e.value.code == 2
    assert "item 10" in capsys.readouterr().err


def _fake_worker(reply: bytes):
    """A one-request-at-a-time HTTP peer that answers every request with
    ``reply`` and closes: its port and its stop function."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.2)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except (socket.timeout, OSError):
                continue
            with conn:
                conn.settimeout(5)
                try:
                    conn.recv(65536)
                    conn.sendall(reply)
                except OSError:
                    pass

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join(timeout=10)
        srv.close()

    return srv.getsockname()[1], close


CUT_SHORT = pytest.mark.parametrize("reply", [
    # Content-Length longer than the body, then the connection closes: a
    # worker killed while it writes a reply (http.client.IncompleteRead)
    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
    b"Content-Length: 4096\r\n\r\n{\"job_id\": \"job-0",
    # a garbled status line (http.client.BadStatusLine)
    b"HTTZ/9 what\r\n\r\n",
    # nothing at all (RemoteDisconnected, an OSError as well)
    b"",
], ids=["incomplete_read", "bad_status_line", "remote_disconnected"])


@CUT_SHORT
def test_reply_cut_short_is_503_worker_unavailable(reply):
    port, close = _fake_worker(reply)
    w = WorkerHandle(0, "/nonexistent/w0", [])
    w.port = port
    w.alive = lambda: True
    rt = Router([w], port=0)
    threading.Thread(target=rt.httpd.serve_forever, daemon=True).start()
    rport = rt.httpd.server_address[1]
    try:
        for method, path, body in (
                ("GET", "/result?job_id=w0:job-000000", None),
                ("POST", "/submit", json.dumps({"objective": "sphere",
                                                "n": 4}))):
            st, out, hdrs = _rq(rport, method, path, body)
            assert st == 503, (reply, path, st, out)
            assert out["code"] == "worker_unavailable"
            assert "Retry-After" in hdrs
        snap = rt.metrics.snapshot()
        assert snap['router_proxy_errors_total{worker="w0"}'] == 2
    finally:
        rt.httpd.shutdown()
        rt.httpd.server_close()
        close()


@CUT_SHORT
def test_health_reply_cut_short_is_unhealthy(reply):
    """The supervisor's /healthz probe reads any transport failure as
    unhealthy and never raises."""
    port, close = _fake_worker(reply)
    w = WorkerHandle(0, "/nonexistent/w0", [])
    w.port = port
    try:
        assert w.probe() is False
    finally:
        close()


class _FakeProc:
    """A worker process whose liveness the test sets."""
    returncode = None

    def poll(self):
        return self.returncode


def test_supervisor_survives_health_replies_cut_short():
    """A worker killed while it answers the supervisor's /healthz cuts the
    reply short. Supervision must go on: the death right after is seen
    and the worker respawned (else its acked jobs are never delivered)."""
    port, close = _fake_worker(
        b"HTTP/1.1 200 OK\r\nContent-Length: 64\r\n\r\n{\"st")
    w = WorkerHandle(0, "/nonexistent/w0", [])
    w.proc, w.port, w.last_spawn = _FakeProc(), port, time.monotonic()
    spawned = threading.Event()

    def spawn(extra_args=()):
        w.proc = None                # no second life to supervise
        spawned.set()

    w.spawn = spawn
    rt = Router([w], port=0, probe_s=0.05)
    rt.supervisor_thread.start()
    try:
        time.sleep(0.5)              # several probes, each cut short
        assert rt.supervisor_thread.is_alive()
        assert not w.healthy and not spawned.is_set()
        w.proc.returncode = 137
        assert spawned.wait(timeout=10)
        assert w.restarts == 1
        assert rt.supervisor_thread.is_alive()
    finally:
        rt._stop.set()
        rt.supervisor_thread.join(timeout=10)
        rt.httpd.server_close()
        close()


def test_supervisor_survives_a_failed_respawn():
    """A respawn that raises (say, a fork refused) is logged and retried
    at the next tick; the supervisor goes on."""
    w = WorkerHandle(0, "/nonexistent/w0", [])
    w.proc, w.last_spawn = _FakeProc(), time.monotonic() - 100.0
    w.proc.returncode = 137
    calls, spawned = [], threading.Event()

    def spawn(extra_args=()):
        calls.append(time.monotonic())
        if len(calls) == 1:
            raise OSError("fork refused")
        w.proc = None
        spawned.set()

    w.spawn = spawn
    rt = Router([w], port=0, probe_s=0.05)
    rt.supervisor_thread.start()
    try:
        assert spawned.wait(timeout=10)
        assert len(calls) == 2 and w.restarts == 2
        assert rt.supervisor_thread.is_alive()
    finally:
        rt._stop.set()
        rt.supervisor_thread.join(timeout=10)
        rt.httpd.server_close()


# ------------------------------------------------------------- chaos e2e
def _rq(port, method, path, body=None, timeout=HTTP_TIMEOUT):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw), dict(resp.getheaders())
    finally:
        conn.close()


def _ref(objective, n, seed):
    res = abo_minimize(OBJECTIVES[objective], n, config=ABOConfig(**CFG),
                       seed=seed, device="cpu")
    return (res.fun, res.history.tolist(),
            res.x.double().numpy().tobytes())


def test_two_worker_chaos_kill_one_zero_lost_jobs(tmp_path, monkeypatch):
    """Kill one of two port workers mid-traffic (``worker_crash:nth=3``
    on its stepper) and require the full contract: supervised restart,
    journal resume, zero lost acked jobs, deliberate sheds only, and
    bit-identity to the port's abo_minimize for every delivered
    result."""
    # the workers inherit this environment: the port's sources, a small
    # thread pool each (two torch processes share the CPU with the tests)
    monkeypatch.setenv("PYTHONPATH", str(REPO / "src"))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    worker_args = ["--lanes", "2", "--journal-every", "2", "--device", "cpu"]
    handles = [WorkerHandle(i, tmp_path / f"w{i}", worker_args)
               for i in range(2)]
    rt = Router(handles, port=0, probe_s=0.2)
    port = rt.httpd.server_address[1]

    # finite-result families, one per worker, on the router's own hash
    obj0, obj1 = "shifted_sphere", "sphere"
    assert rt.worker_for_family(obj0).index == 0
    assert rt.worker_for_family(obj1).index == 1

    rt.spawn_all(inject={0: "worker_crash:nth=3:kind=kill"})
    assert all(w.port is not None for w in handles), "spawn failed"
    serve_thread = threading.Thread(target=rt.serve, daemon=True)
    serve_thread.start()
    try:
        plan = [(obj0, 48, s) for s in range(4)] \
            + [(obj1, 32, s) for s in range(2)]
        acked = {}                        # prefixed job id -> (obj, n, s)
        statuses = []                     # every HTTP status seen

        def submit(obj, n, seed):
            body = json.dumps({"objective": obj, "n": n, "seed": seed,
                               "config": CFG})
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                st, out, hdrs = _rq(port, "POST", "/submit", body)
                statuses.append((st, out.get("code")))
                if st == 200:
                    return out["job_id"]
                assert st == 503 and out["code"] in (
                    "worker_unavailable", "shutting_down"), out
                assert "Retry-After" in hdrs
                time.sleep(min(float(hdrs["Retry-After"]), 1.0))
            raise AssertionError("submit never accepted")

        for obj, n, seed in plan:
            jid = submit(obj, n, seed)
            assert jid not in acked, "duplicated job id"
            acked[jid] = (obj, n, seed)
        assert sum(j.startswith("w0:") for j in acked) == 4

        results = {}
        deadline = time.monotonic() + 300
        pending = set(acked)
        while pending and time.monotonic() < deadline:
            for jid in sorted(pending):
                st, out, hdrs = _rq(port, "GET",
                                    f"/result?job_id={jid}&wait=5")
                statuses.append((st, out.get("code")))
                if st == 200 and out.get("status") == "done":
                    results[jid] = out
                    pending.discard(jid)
                elif st == 503:
                    assert out["code"] in ("worker_unavailable",
                                           "shutting_down"), out
                    assert "Retry-After" in hdrs
                    time.sleep(min(float(hdrs["Retry-After"]), 1.0))
                else:
                    assert st == 202, (st, out)
        assert not pending, f"lost jobs after restart: {sorted(pending)}"

        assert handles[0].restarts >= 1
        assert handles[1].restarts == 0

        assert {st for st, _ in statuses} <= {200, 202, 503}
        assert all(code in ("worker_unavailable", "shutting_down")
                   for st, code in statuses if st == 503)

        for jid, (obj, n, seed) in acked.items():
            fun, history, xb = _ref(obj, n, seed)
            out = results[jid]
            assert out["fun"] == fun, (jid, obj)
            assert out["history"] == history, (jid, obj)
            assert np.asarray(out["x"], np.float64).tobytes() == xb, \
                (jid, obj)

        st, _, _ = _rq(port, "GET", "/healthz")
        assert st == 200
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=HTTP_TIMEOUT)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        assert resp.status == 200
        assert 'router_worker_restarts_total{worker="w0"} 1' in text
        assert 'worker="w1"' in text
        assert "router_requests_total" in text

        st, out, _ = _rq(port, "GET", "/poll?job_id=zz:job-1")
        assert st == 404 and out["code"] == "unknown_job"
        assert out["status"] == "unknown"
    finally:
        rt.begin_shutdown("test done")
        serve_thread.join(timeout=60)     # serve() terminates workers
        for w in handles:
            w.terminate(grace_s=5)
