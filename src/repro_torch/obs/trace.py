"""Low-overhead span tracer with Chrome-trace-event JSON export.

The port's own copy of :mod:`repro.obs.trace`: the same spans and the same
Chrome-trace JSON.

Disabled is the default and costs one attribute check per ``span()``
call: the tracer hands back a module-level null span whose enter/exit
are no-ops — no allocation, no clock read, no list append. Enabled, a
span is two ``perf_counter_ns`` reads and one dict append; events are
buffered in memory (capped at ``max_events``) and exported on demand as
the Chrome trace event format::

    {"traceEvents": [{"name", "ph": "X", "ts", "dur", "pid", "tid",
                      "args"}, ...]}

which chrome://tracing and https://ui.perfetto.dev load directly —
``ts``/``dur`` are microseconds relative to ``enable()``.

Span nesting is positional, not structural: a complete ("X") event whose
``[ts, ts+dur]`` interval contains another's is its parent in the
viewer. The engine emits ``step`` as the parent span with the phase
spans (``refill``, ``plan_build``, ``fused_sweep``, ``harvest``, ...)
inside it, all on the stepping thread's ``tid``.
"""
# repro: gauge-path — stdlib-only by invariant: observing must never sync the device
from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """The disabled path: a reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0

    def set(self, **args):
        """Attach/update args mid-span (shown in the viewer's detail
        pane) — e.g. the number of jobs a harvest finished."""
        self.args.update(args)

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        if tr.enabled and len(tr.events) < tr.max_events:
            tr.events.append({
                "name": self.name, "ph": "X",
                "ts": (self.t0 - tr.t0_ns) / 1000.0,
                "dur": (t1 - self.t0) / 1000.0,
                "pid": tr.pid, "tid": threading.get_ident() & 0xFFFF,
                "args": self.args,
            })
        return False


class Tracer:
    """Span buffer; ``enabled=False`` until :meth:`enable` is called."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.max_events = max_events
        self.events: list[dict] = []
        self.t0_ns = 0
        self.pid = os.getpid()
        self.default_path: str | None = None

    def enable(self, path: str | None = None):
        """Start recording; ``path`` (optional) becomes the default
        export target for :meth:`export`."""
        self.enabled = True
        self.default_path = path or self.default_path
        if not self.t0_ns:
            self.t0_ns = time.perf_counter_ns()

    def disable(self):
        self.enabled = False

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def counts(self) -> dict[str, int]:
        """Events recorded so far, by span name."""
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev["name"]] = out.get(ev["name"], 0) + 1
        return out

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def export(self, path: str | None = None) -> str:
        """Write the Chrome trace JSON; returns the path written."""
        path = path or self.default_path
        if path is None:
            raise ValueError("no trace path: pass one or enable(path=...)")
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)
        return path
