"""The port's serving tier (``repro_torch.serve``) against the JAX package's.

The stdlib-only modules (``errors``, ``limits``, ``validate``) give the
reference's outputs and raise the reference's ``ApiError`` on the same
inputs: a table of requests, a hypothesis strategy over submit bodies, and
token buckets on one injected clock. Then one scripted request sequence
goes to an in-process JAX ``Frontend`` and to the port's, each over a
``lanes=1`` engine on the CPU with no stepper running (so every answer is
decided at the door or by admission): the status codes, the envelopes
(job ids left out) and where ``Retry-After`` is sent are equal. Last, the
port's copies of the reference's front-door tests (long-poll, condvar
wake-up, lock-free ``/healthz``, saturation, the ``http_reply`` and
``slow_client`` faults, SIGTERM then a bit-exact resume), with every
delivered fun, x and history held bit for bit to the port's
``abo_minimize`` on the CPU.

Every HTTP call and thread join has its own timeout.
"""
import dataclasses
import http.client
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:        # hypothesis is a [test] extra — property tests skip without it
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.engine import SolveService as JaxService
from repro.serve import errors as j_errors
from repro.serve import frontend as j_frontend
from repro.serve import limits as j_limits
from repro.serve import validate as j_validate
from repro_torch.core.abo import ABOConfig, abo_minimize
from repro_torch.engine import SolveEngine, SolveService
from repro_torch.launch.solve_server import _build_server
from repro_torch.objectives import OBJECTIVES
from repro_torch.serve import errors as t_errors
from repro_torch.serve import frontend as t_frontend
from repro_torch.serve import limits as t_limits
from repro_torch.serve import validate as t_validate

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
CFG = {"samples_per_pass": 12, "n_passes": 3}
HTTP_TIMEOUT = 30


def _outcome(fn, *args, **kw):
    """("ok", value) or ("raise", class name, status, code, message,
    retry_after) — the parts of an ApiError a client sees."""
    try:
        return ("ok", fn(*args, **kw))
    except (j_errors.ApiError, t_errors.ApiError) as e:
        return ("raise", "ApiError", e.http_status, e.code, e.message,
                e.retry_after, e.job_id, e.status)
    except ValueError as e:
        return ("raise", "ValueError", str(e))


# ---------------------------------------------------------------- errors
def test_errors_match_the_reference():
    assert t_errors.CODE_STATUS == j_errors.CODE_STATUS
    for payload in ({"code": "unknown_job"}, {"code": "not_done"},
                    {"code": "conflict"}, {"code": "zzz"}, {"job_id": "x"},
                    "not-a-dict", None, [1]):
        for default in (200, 500):
            assert t_errors.status_for(payload, default) == \
                j_errors.status_for(payload, default)
    for kw in ({}, {"job_id": "j"}, {"status": "done"},
               {"job_id": "j", "status": "queued"}):
        assert t_errors.envelope("m", "c", **kw) == \
            j_errors.envelope("m", "c", **kw)
        a = t_errors.ApiError(429, "rate_limited", "slow down",
                              retry_after=1.5, **kw)
        b = j_errors.ApiError(429, "rate_limited", "slow down",
                              retry_after=1.5, **kw)
        assert (a.http_status, a.code, a.retry_after, a.payload()) == \
            (b.http_status, b.code, b.retry_after, b.payload())
    for field in (None, "n", "config"):
        a = t_errors.bad_request("bad", field=field)
        b = j_errors.bad_request("bad", field=field)
        assert (a.http_status, a.code, a.message) == \
            (b.http_status, b.code, b.message)


# ---------------------------------------------------------------- limits
def test_token_buckets_match_the_reference_on_one_clock():
    rng = np.random.RandomState(0)
    for rate, burst in ((2.0, 3), (0.5, None), (5.0, 10), (0, None),
                        (None, None), (1.0, 1)):
        clock = [0.0]
        a = t_limits.TokenBucket(rate, burst, clock=lambda: clock[0])
        b = j_limits.TokenBucket(rate, burst, clock=lambda: clock[0])
        for _ in range(200):
            clock[0] += float(rng.choice([0.0, 0.01, 0.3, 1.7]))
            assert a.take() == b.take()
            assert a.tokens == b.tokens
        assert a.take(now=clock[0] + 5.0) == b.take(now=clock[0] + 5.0)
    for rate, burst in ((-1, None), (1, 0), (1, 0.5)):
        assert _outcome(t_limits.TokenBucket, rate, burst) == \
            _outcome(j_limits.TokenBucket, rate, burst)


TENANT_SPECS = [
    "s3cret:name=alice:rate=5:burst=10:quota=100;guest:rate=0.5",
    "tok:name=t:rate=1:burst=1:quota=2",
    "a;b;c",
    "", ";;", "tok:rate", "tok:zzz=1", "tok:name=a;tok:name=b",
    "a:name=x;b:name=x", ":name=x", "tok:quota=zz",
]
AUTH_HEADERS = [None, "", "Bearer s3cret", "Bearer guest", "Bearer nope",
                "Basic s3cret", "s3cret", "bearer tok", "Bearer  tok ",
                "Bearer a", "Bearer c"]


@pytest.mark.parametrize("spec", TENANT_SPECS)
def test_tenant_tables_match_the_reference(spec):
    clock = [0.0]
    tables = []
    for mod in (t_limits, j_limits):
        out = _outcome(mod.TenantTable.from_spec, spec,
                       clock=lambda: clock[0])
        tables.append(out[1] if out[0] == "ok" else out)
    a, b = tables
    if isinstance(a, tuple):
        assert a == b                     # the same ValueError
        return
    assert len(a) == len(b)
    assert [(t.name, t.token, t.quota_jobs) for t in a.tenants] == \
        [(t.name, t.token, t.quota_jobs) for t in b.tenants]
    for header in AUTH_HEADERS:
        ra = _outcome(a.authenticate, header)
        rb = _outcome(b.authenticate, header)
        assert ra[0] == rb[0], header
        if ra[0] == "raise":
            assert ra == rb
            continue
        ta, tb = ra[1], rb[1]
        assert ta.name == tb.name
        for step in range(6):
            clock[0] += 0.4 * step
            assert _outcome(a.check_rate, ta) == _outcome(b.check_rate, tb)
            qa, qb = _outcome(a.check_quota, ta), _outcome(b.check_quota, tb)
            assert qa == qb
            if qa[0] == "ok":
                a.charge_job(ta)
                b.charge_job(tb)
        assert (ta.jobs_used, ta.requests, ta.rejected) == \
            (tb.jobs_used, tb.requests, tb.rejected)


# -------------------------------------------------------------- validate
SUBMIT_TABLE = [
    {"objective": "sphere", "n": 64, "seed": 3,
     "config": {"samples_per_pass": 5}, "x0": [0.0] * 64, "tag": "t",
     "ttl_s": 9.5},
    [1, 2], "body", None, {}, {"n": 4}, {"objective": 7, "n": 4},
    {"objective": "sphere"}, {"objective": "sphere", "n": True},
    {"objective": "sphere", "n": 0}, {"objective": "sphere", "n": 4.0},
    {"objective": "sphere", "n": 4, "zzz": 1},
    {"objective": "sphere", "n": 4, "seed": 1.5},
    {"objective": "sphere", "n": 4, "seed": None},
    {"objective": "sphere", "n": 4, "tag": 9},
    {"objective": "sphere", "n": 4, "ttl_s": 0},
    {"objective": "sphere", "n": 4, "ttl_s": True},
    {"objective": "sphere", "n": 4, "ttl_s": "1"},
    {"objective": "sphere", "n": 4, "x0": "abc"},
    {"objective": "sphere", "n": 4, "x0": [0.0] * 3},
    {"objective": "sphere", "n": 4, "x0": [0.0] * 3 + [None]},
    {"objective": "sphere", "n": 4, "x0": [0.0] * 3 + [True]},
    {"objective": "sphere", "n": 4, "config": 5},
    {"objective": "sphere", "n": 4, "config": {"zz": 1}},
    {"objective": "sphere", "n": 4, "config": {"samples_per_pass": [5]}},
    {"objective": "sphere", "n": 4, "config": {"span_coords": {"a": 1}}},
    {"objective": "sphere", "n": 10_000},
]


@pytest.mark.parametrize("max_n", [None, 500])
def test_validate_submit_table_matches_the_reference(max_n):
    for req in SUBMIT_TABLE:
        assert _outcome(t_validate.validate_submit, req, max_n=max_n) == \
            _outcome(j_validate.validate_submit, req, max_n=max_n), req


def test_validate_cancel_matches_the_reference():
    for req in ({"job_id": "job-7"}, "nope", {}, {"job_id": ""},
                {"job_id": 7}, [], {"job_id": "w0:job-1", "x": 1}):
        assert _outcome(t_validate.validate_cancel, req) == \
            _outcome(j_validate.validate_cancel, req), req


if HAVE_HYPOTHESIS:
    _scalars = st.one_of(st.none(), st.booleans(), st.integers(-3, 10**7),
                         st.floats(allow_nan=False, width=32),
                         st.text(max_size=6))
    _values = st.one_of(
        _scalars, st.lists(_scalars, max_size=5),
        st.dictionaries(
            st.sampled_from(["samples_per_pass", "n_passes", "zz",
                             "shrink"]),
            st.one_of(_scalars, st.lists(_scalars, max_size=2)),
            max_size=3))
    _keys = st.sampled_from(["objective", "n", "config", "seed", "x0",
                             "tag", "ttl_s", "job_id", "extra"])

    @settings(max_examples=300, deadline=None)
    @given(st.dictionaries(_keys, _values, max_size=6),
           st.sampled_from([None, 1, 4, 10**6]))
    def test_validate_submit_property_matches_the_reference(req, max_n):
        assert _outcome(t_validate.validate_submit, req, max_n=max_n) == \
            _outcome(j_validate.validate_submit, req, max_n=max_n)
else:
    @pytest.mark.skip(reason="hypothesis not installed (pip install .[test])")
    def test_validate_submit_property_matches_the_reference():
        pass


# ------------------------------------------------ in-process front doors
def _start(fe_mod, svc, cfg=None):
    fe = fe_mod.Frontend(svc, 0, cfg or fe_mod.FrontendConfig(poll_s=0.005))
    threading.Thread(target=fe.httpd.serve_forever, daemon=True).start()
    return fe


def _stop(fe):
    fe.httpd.shutdown()
    fe._stop_stepper.set()
    with fe._wake:
        fe._wake.notify_all()
    if fe.stepper_thread.is_alive():
        fe.stepper_thread.join(timeout=HTTP_TIMEOUT)
    fe.httpd.server_close()


def _req(port, method, path, body=None, headers=None, timeout=HTTP_TIMEOUT):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = dict(resp.getheaders())
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            payload = raw.decode()
        return resp.status, payload, hdrs
    finally:
        conn.close()


def _raw(port, head: str):
    """A POST /submit with hand-written headers (http.client always sets
    Content-Length): the status and the body."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=HTTP_TIMEOUT) as s:
        s.sendall(f"POST /submit HTTP/1.1\r\nHost: x\r\n{head}\r\n".encode())
        chunks = []
        while chunk := s.recv(65536):     # the server closes -> EOF
            chunks.append(chunk)
    data = b"".join(chunks).decode()
    return (int(data.split(" ", 2)[1]),
            json.loads(data.rsplit("\r\n\r\n", 1)[1]),
            "Connection: close" in data)


def _submit_body(seed=0, n=64, objective="sphere", **extra):
    return json.dumps({"objective": objective, "n": n, "seed": seed,
                       "config": CFG, **extra})


def _scripted(fe_mod, limits_mod, service):
    """The scripted sequence against one package's Frontend; returns one
    (step, status, envelope without job ids, Retry-After sent) per
    request. ``service(**kw)`` builds a lanes=1 SolveService."""
    seen = []
    clock = [0.0]

    def note(step, status, payload, hdrs):
        if isinstance(payload, dict):
            payload = {k: v for k, v in payload.items() if k != "job_id"}
        seen.append((step, status, payload, "Retry-After" in hdrs))

    auth = {"Authorization": "Bearer tok"}
    # one front door: auth on, a 512-byte body cap, a queue of 2
    fe = _start(fe_mod, service(max_queue=2), fe_mod.FrontendConfig(
        max_body_bytes=512,
        tenants=limits_mod.TenantTable.from_spec("tok:name=t")))
    port = fe.httpd.server_address[1]
    try:
        def do(step, method, path, body=None, headers=auth):
            st_, payload, hdrs = _req(port, method, path, body, headers)
            note(step, st_, payload, hdrs)
            return payload

        do("malformed json", "POST", "/submit", "{not json")
        do("missing n", "POST", "/submit", json.dumps({"objective": "s"}))
        do("unknown field", "POST", "/submit", _submit_body(zzz=1))
        do("unknown config key", "POST", "/submit",
           json.dumps({"objective": "sphere", "n": 4, "config": {"z": 1}}))
        do("unknown objective", "POST", "/submit",
           _submit_body(objective="nope"))
        do("seed out of range", "POST", "/submit", _submit_body(2**70))
        do("no token", "POST", "/submit", _submit_body(), headers={})
        do("wrong token", "POST", "/submit", _submit_body(),
           headers={"Authorization": "Bearer nope"})
        for step, head in (("no length", ""),
                           ("negative length", "Content-Length: -5\r\n"),
                           ("bad length", "Content-Length: zz\r\n")):
            st_, payload, closed = _raw(port, head)
            note(step, st_, payload, {})
            seen.append((step + " closes", closed))
        do("body too large", "POST", "/submit",
           json.dumps({"objective": "x" * 600, "n": 4}))
        do("unknown job poll", "GET", "/poll?job_id=nope")
        do("unknown job result", "GET", "/result?job_id=nope")
        do("unknown job cancel", "POST", "/cancel",
           json.dumps({"job_id": "nope"}))
        do("unknown endpoint", "GET", "/nosuch")
        do("unknown post endpoint", "POST", "/nosuch", "{}")
        jid = do("submit", "POST", "/submit", _submit_body(0))["job_id"]
        do("poll queued", "GET", f"/poll?job_id={jid}")
        do("not done", "GET", f"/result?job_id={jid}")
        do("bad wait", "GET", f"/result?job_id={jid}&wait=zz")
        do("negative wait", "GET", f"/poll?job_id={jid}&wait=-1")
        do("submit 2", "POST", "/submit", _submit_body(1))
        do("queue full", "POST", "/submit", _submit_body(2))
        do("cancel", "POST", "/cancel", json.dumps({"job_id": jid}))
        do("cancel again", "POST", "/cancel", json.dumps({"job_id": jid}))
        do("result of cancelled", "GET", f"/result?job_id={jid}")
        do("cancel without id", "POST", "/cancel", "{}")
        do("submit after cancel", "POST", "/submit", _submit_body(3))
        fe._stopping = True
        do("shutting down submit", "POST", "/submit", _submit_body(4))
        do("shutting down poll", "GET", f"/poll?job_id={jid}")
        st_, payload, _ = _req(port, "GET", "/healthz")
        note("healthz while stopping", st_, payload, {})
        fe._stopping = False
    finally:
        _stop(fe)

    # rate limit and quota, on one frozen clock
    fe = _start(fe_mod, service(), fe_mod.FrontendConfig(
        tenants=limits_mod.TenantTable.from_spec(
            "tok:name=t:rate=1:burst=3:quota=1", clock=lambda: clock[0])))
    port = fe.httpd.server_address[1]
    try:
        for step in ("rate 1", "quota"):
            st_, payload, hdrs = _req(port, "POST", "/submit",
                                      _submit_body(), auth)
            note(step, st_, payload, hdrs)
        for step in ("rate 3", "rate limited"):
            st_, payload, hdrs = _req(port, "GET", "/poll?job_id=nope", None,
                                      auth)
            note(step, st_, payload, hdrs)
    finally:
        _stop(fe)

    # the memory budget sheds every submission
    fe = _start(fe_mod, service(memory_budget_bytes=1))
    port = fe.httpd.server_address[1]
    try:
        st_, payload, hdrs = _req(port, "POST", "/submit", _submit_body())
        note("memory budget", st_, payload, hdrs)
    finally:
        _stop(fe)
    return seen


def test_scripted_sequence_matches_the_reference_frontend():
    port_seen = _scripted(t_frontend, t_limits,
                          lambda **kw: SolveService(lanes=1, device=CPU, **kw))
    jax_seen = _scripted(j_frontend, j_limits,
                         lambda **kw: JaxService(lanes=1, **kw))
    assert [s[0] for s in port_seen] == [s[0] for s in jax_seen]
    for got, want in zip(port_seen, jax_seen):
        assert got == want
    statuses = {s[1] for s in port_seen if len(s) == 4}
    assert statuses == {200, 202, 400, 401, 404, 409, 411, 413, 429, 503}
    codes = {s[2].get("code") for s in port_seen
             if len(s) == 4 and isinstance(s[2], dict)}
    assert {"bad_json", "bad_request", "bad_length", "unauthorized",
            "length_required", "body_too_large", "unknown_job",
            "unknown_endpoint", "not_done", "conflict", "queue_full",
            "rate_limited", "quota_exceeded", "memory_budget",
            "shutting_down"} <= codes
    # Retry-After rides every backpressure answer and nothing else
    for step, status, payload, retry in (s for s in port_seen if len(s) == 4):
        assert retry == (status == 503 or payload.get("code") in (
            "queue_full", "rate_limited")), step


# ------------------------------------- the reference's front-door tests
def _solo(objective, n, seed):
    return abo_minimize(OBJECTIVES[objective], n, config=ABOConfig(**CFG),
                        seed=seed, device=CPU)


def _assert_solo(out, objective, n, seed):
    ref = _solo(objective, n, seed)
    assert out["status"] == "done"
    assert out["fun"] == ref.fun
    assert out["history"] == ref.history.tolist()
    assert np.asarray(out["x"], np.float64).tobytes() == \
        ref.x.double().numpy().tobytes()


def test_healthz_and_metrics_lock_free_while_engine_busy():
    fe = _start(t_frontend, SolveService(lanes=1, device=CPU))
    port = fe.httpd.server_address[1]
    try:
        assert fe._engine_lock.acquire(timeout=5)
        try:
            t0 = time.perf_counter()
            st_, payload, _ = _req(port, "GET", "/healthz", timeout=5)
            assert st_ == 200 and payload["status"] == "ok"
            st_, text, _ = _req(port, "GET", "/metrics", timeout=5)
            assert st_ == 200 and "engine_steps_total" in text
            assert "serve_request_seconds" in text
            assert time.perf_counter() - t0 < 3.0
            fe.cfg.deadline_s, saved = 0.2, fe.cfg.deadline_s
            st_, payload, hdrs = _req(port, "GET", "/stats", timeout=10)
            assert st_ == 503 and payload["code"] == "deadline"
            assert "Retry-After" in hdrs
            fe.cfg.deadline_s = saved
        finally:
            fe._engine_lock.release()
        st_, payload, _ = _req(port, "GET", "/stats")
        assert st_ == 200 and payload["lanes"] == 1
    finally:
        _stop(fe)


def test_fifo_lock_order_and_timeouts():
    lock = t_frontend.FifoLock()
    assert lock.acquire() and lock.locked()
    assert not lock.acquire(blocking=False)
    t0 = time.monotonic()
    assert not lock.acquire(timeout=0.2)          # gives up, leaves the queue
    assert time.monotonic() - t0 >= 0.2
    order, started = [], []

    def waiter(i):
        started.append(i)
        with lock:
            order.append(i)

    threads = []
    for i in range(6):                            # queue up one at a time
        threads.append(threading.Thread(target=waiter, args=(i,)))
        threads[-1].start()
        deadline = time.monotonic() + 5
        while len(lock._waiters) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
    lock.release()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert order == list(range(6)) and not lock.locked()
    with pytest.raises(RuntimeError):
        lock.release()


def test_busy_stepper_does_not_starve_a_burst_of_requests():
    """While work is always pending, requests that arrive during a step
    are served when it ends, ahead of the stepper's next step (the
    reference's threading.Lock lets the stepper take it again first:
    benchmarks_torch/serve_lock_burst.py)."""
    step_s, n = 0.25, 16
    svc = SolveService(lanes=1, device=CPU)
    svc.engine.pending = lambda: True
    svc.step = lambda: time.sleep(step_s)
    fe = _start(t_frontend, svc, t_frontend.FrontendConfig(deadline_s=60.0))
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    waits = [None] * n

    def one(i):
        t0 = time.perf_counter()
        st_, _, _ = _req(port, "GET", "/stats")
        waits[i] = (st_, time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
            assert not t.is_alive()
    finally:
        _stop(fe)
    assert all(st_ == 200 for st_, _ in waits)
    # at most the step in progress, the next one, and the burst's own work
    assert max(w for _, w in waits) < 8 * step_s, sorted(waits)


def test_saturation_sheds_503():
    fe = _start(t_frontend, SolveService(lanes=1, device=CPU),
                t_frontend.FrontendConfig(max_inflight=1, deadline_s=5.0))
    port = fe.httpd.server_address[1]
    try:
        assert fe._engine_lock.acquire(timeout=5)
        try:
            blocked = threading.Thread(
                target=_req, args=(port, "GET", "/stats"), daemon=True)
            blocked.start()
            deadline = time.monotonic() + 5
            while fe._inflight < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            st_, payload, hdrs = _req(port, "GET", "/stats", timeout=10)
            assert st_ == 503 and payload["code"] == "saturated"
            assert "Retry-After" in hdrs
        finally:
            fe._engine_lock.release()
        blocked.join(timeout=10)
        assert not blocked.is_alive()
    finally:
        _stop(fe)


def test_condvar_stepper_wakes_on_submit():
    """With poll_s=5 a busy-wait stepper would add ~5 s of latency; the
    condvar stepper must finish a submitted job far faster."""
    svc = SolveService(lanes=1, device=CPU)
    fe = _start(t_frontend, svc,
                t_frontend.FrontendConfig(poll_s=5.0, idle_max_s=5.0))
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    try:
        st_, sub, _ = _req(port, "POST", "/submit", _submit_body(7))
        st_, out, _ = _req(port, "GET",
                           f"/result?job_id={sub['job_id']}&wait=30")
        assert st_ == 200
        _assert_solo(out, "sphere", 64, 7)
        time.sleep(0.3)                   # the stepper parks on the condvar
        t0 = time.perf_counter()
        st_, sub, _ = _req(port, "POST", "/submit", _submit_body())
        assert st_ == 200
        st_, out, _ = _req(port, "GET",
                           f"/result?job_id={sub['job_id']}&wait=10")
        dt = time.perf_counter() - t0
        assert st_ == 200 and out["status"] == "done"
        assert dt < 3.0, f"stepper slept through the submit ({dt:.1f}s)"
        snap = svc.engine.metrics.snapshot()
        assert snap.get("serve_stepper_wakeups_total", 0) >= 1
    finally:
        _stop(fe)


def test_long_poll_result_delivers_and_times_out():
    svc = SolveService(lanes=1, device=CPU)
    fe = _start(t_frontend, svc)
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    try:
        st_, sub, _ = _req(port, "POST", "/submit", _submit_body())
        st_, out, _ = _req(port, "GET",
                           f"/result?job_id={sub['job_id']}&wait=30")
        assert st_ == 200 and len(out["x"]) == 64
        _assert_solo(out, "sphere", 64, 0)
        assert svc.engine.jobs[sub["job_id"]].fetched   # delivered
        fe._stop_stepper.set()
        with fe._wake:
            fe._wake.notify_all()
        fe.stepper_thread.join(timeout=10)
        assert not fe.stepper_thread.is_alive()
        st_, sub2, _ = _req(port, "POST", "/submit", _submit_body(9))
        t0 = time.perf_counter()
        st_, out, _ = _req(port, "GET",
                           f"/result?job_id={sub2['job_id']}&wait=0.4")
        assert st_ == 202 and out["code"] == "not_done"
        assert 0.3 < time.perf_counter() - t0 < 5.0
        st_, out, _ = _req(port, "GET",
                           f"/result?job_id={sub2['job_id']}&wait=zz")
        assert st_ == 400 and out["code"] == "bad_request"
    finally:
        _stop(fe)


def test_mixed_jobs_over_http_equal_abo_minimize():
    """Jobs of three families and several n through the legacy
    ``_build_server`` shim, two lanes: every fun, x and history is the
    port's abo_minimize, bit for bit."""
    svc = SolveService(lanes=2, device=CPU)
    httpd, stepper = _build_server(svc, 0, poll_s=0.005)
    fe = httpd._frontend
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    stepper.start()
    port = httpd.server_address[1]
    plan = [("griewank", 300, 0), ("sphere", 64, 1), ("rastrigin", 700, 2),
            ("griewank", 129, 3), ("shifted_sphere", 500, 4)]
    try:
        ids = []
        for obj, n, seed in plan:
            st_, sub, _ = _req(port, "POST", "/submit",
                               _submit_body(seed, n, obj))
            assert st_ == 200, sub
            ids.append(sub["job_id"])
        for jid, (obj, n, seed) in zip(ids, plan):
            st_, out, _ = _req(port, "GET", f"/result?job_id={jid}&wait=30")
            assert st_ == 200, out
            _assert_solo(out, obj, n, seed)
    finally:
        _stop(fe)


def test_sanitized_engine_behind_the_front_door():
    """--sanitize composes with --http: every step runs under the sync
    guard on the stepper's thread, and the handlers' reads of results on
    theirs trip nothing; the jobs keep abo_minimize's bits."""
    svc = SolveService(lanes=2, sanitize=True, device=CPU)
    fe = _start(t_frontend, svc)
    fe.stepper_thread.start()
    port = fe.httpd.server_address[1]
    try:
        ids = [_req(port, "POST", "/submit", _submit_body(s, 96 + s))[1]
               ["job_id"] for s in range(3)]
        for seed, jid in enumerate(ids):
            st_, out, _ = _req(port, "GET", f"/result?job_id={jid}&wait=30")
            assert st_ == 200, out
            _assert_solo(out, "sphere", 96 + seed, seed)
        assert svc.engine.sanitize and svc.engine.step_count >= 1
    finally:
        _stop(fe)


def test_http_reply_fault_tears_reply_without_losing_result():
    svc = SolveService(lanes=1, faults="http_reply:nth=2", device=CPU)
    fe = _start(t_frontend, svc)
    port = fe.httpd.server_address[1]
    try:
        st_, sub, _ = _req(port, "POST", "/submit", _submit_body())  # hit 1
        assert st_ == 200
        svc.drain()
        jid = sub["job_id"]
        with pytest.raises((http.client.BadStatusLine,
                            http.client.RemoteDisconnected,
                            ConnectionResetError)):
            _req(port, "GET", f"/result?job_id={jid}")   # hit 2: torn
        assert not svc.engine.jobs[jid].fetched
        st_, out, _ = _req(port, "GET", f"/result?job_id={jid}")
        assert st_ == 200 and len(out["x"]) == 64
        _assert_solo(out, "sphere", 64, 0)
        snap = svc.engine.metrics.snapshot()
        assert snap['engine_faults_injected_total{site="http_reply"}'] == 1
    finally:
        _stop(fe)


def test_slow_client_fault_does_not_stall_others():
    svc = SolveService(lanes=1, faults="slow_client:nth=1:delay_s=1.0",
                       device=CPU)
    fe = _start(t_frontend, svc)
    port = fe.httpd.server_address[1]
    try:
        t0 = time.perf_counter()
        slow = threading.Thread(
            target=_req, args=(port, "POST", "/submit", _submit_body()),
            daemon=True)
        slow.start()
        time.sleep(0.1)
        st_, payload, _ = _req(port, "GET", "/healthz", timeout=5)
        dt = time.perf_counter() - t0
        assert st_ == 200 and dt < 0.9, \
            f"healthz waited on the slow client ({dt:.2f}s)"
        slow.join(timeout=10)
        assert not slow.is_alive()
        assert time.perf_counter() - t0 >= 1.0
    finally:
        _stop(fe)


def test_sigterm_with_inflight_request_then_bitexact_resume(tmp_path):
    """SIGTERM while a long-poll is parked: the reply completes (the
    status or a clean 503 shutting_down), the final snapshot lands, the
    process exits 0, and a resume re-derives the job bit for bit."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.solve_server",
         "--http", "0", "--port-file", str(port_file), "--ckpt-dir", ck,
         "--journal-every", "4", "--lanes", "2", "--device", CPU],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate(timeout=30)[1][-3000:]
            time.sleep(0.1)
        port = int(port_file.read_text())
        st_, sub, _ = _req(port, "POST", "/submit", _submit_body())
        assert st_ == 200
        jid = sub["job_id"]
        inflight: dict = {}

        def long_poll():
            # /poll, not /result: the reply must not mark the job fetched,
            # or the final snapshot drops x and there is nothing to compare
            try:
                inflight["reply"] = _req(
                    port, "GET", f"/poll?job_id={jid}&wait=30", timeout=60)
            except Exception as e:        # noqa: BLE001 — recorded
                inflight["error"] = e

        t = threading.Thread(target=long_poll, daemon=True)
        t.start()
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=90)
        assert not t.is_alive()
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-3000:]
        assert "final snapshot cut" in out
        assert "reply" in inflight, inflight.get("error")
        st_, payload, _ = inflight["reply"]
        assert st_ in (200, 503), payload
        if st_ == 503:
            assert payload["code"] == "shutting_down"

        from repro_torch.checkpoint.fsck import fsck
        assert fsck(ck)["ok"]
        eng = SolveEngine.resume(ck, device=CPU)
        eng.run()
        rec = eng.jobs[jid]
        ref = _solo("sphere", 64, 0)
        assert rec.fun == ref.fun and rec.history == ref.history.tolist()
        assert torch.equal(torch.as_tensor(rec.x), ref.x)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_solve_server_http_flag_errors(capsys):
    from repro_torch.launch import solve_server
    cases = [(["--http", "0", "--max-body", "0"], "--max-body must be >= 1"),
             (["--http", "0", "--deadline", "0"], "--deadline must be > 0"),
             (["--http", "0", "--wait-max", "-1"], "--wait-max must be >= 0"),
             (["--http", "0", "--max-inflight", "0"],
              "--max-inflight must be >= 1"),
             (["--http", "0", "--max-n", "0"], "--max-n must be >= 1"),
             (["--http", "0", "--auth", "tok:zzz=1"], "--auth: unknown"),
             (["--workers", "0", "--http", "0"], "--workers must be >= 1"),
             (["--workers", "2"], "--workers requires --http"),
             (["--workers", "2", "--http", "0"],
              "--workers requires --ckpt-dir"),
             (["--workers", "2", "--http", "0", "--ckpt-dir", "d",
               "--inject", "worker_crash:nth=1"], "--inject with --workers"),
             (["--devices", "2", "--http", "0"], "item 10"),
             (["--span", "4", "--http", "0"], "item 10")]
    for argv, needle in cases:
        with pytest.raises(SystemExit) as e:
            solve_server.main(argv + ["--device", CPU])
        assert e.value.code == 2, argv
        assert needle in capsys.readouterr().err, argv
    with pytest.raises(ValueError, match="batch mode"):
        solve_server.run(["--http", "0", "--device", CPU])


def test_solve_server_http_config_reaches_the_front_door(monkeypatch):
    """--http builds the Frontend the reference builds from the same
    flags (captured before it serves)."""
    from repro_torch.launch import solve_server
    got = {}

    def fake_serve_http(service, port, config=None, port_file=None, **kw):
        got.update(service=service, port=port, config=config,
                   port_file=port_file)

    monkeypatch.setattr(solve_server, "_serve_http", fake_serve_http)
    assert solve_server.main(
        ["--http", "0", "--lanes", "3", "--max-body", "777", "--deadline",
         "4.5", "--wait-max", "9", "--max-inflight", "5", "--max-n", "1000",
         "--auth", "tok:name=t", "--verbose", "--port-file", "pf",
         "--max-queue", "7", "--device", CPU]) is None
    cfg = got["config"]
    assert (cfg.max_body_bytes, cfg.deadline_s, cfg.wait_max_s,
            cfg.max_inflight, cfg.max_n, cfg.verbose) == \
        (777, 4.5, 9.0, 5, 1000, True)
    assert [t.name for t in cfg.tenants.tenants] == ["t"]
    eng = got["service"].engine
    assert (eng.lanes, eng.max_queue, eng.device.type) == (3, 7, CPU)
    assert got["port"] == 0 and got["port_file"] == "pf"
    assert dataclasses.is_dataclass(cfg)
