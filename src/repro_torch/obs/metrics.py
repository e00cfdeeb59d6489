"""Process-local metrics registry: counters, gauges, histograms.

The port's own copy of :mod:`repro.obs.metrics` (the port imports nothing
of the JAX package): the same instruments, the same ``snapshot()`` keys
and the same Prometheus text.

Stdlib-only and deliberately tiny — the engine's hot path touches
instruments thousands of times per second, so an instrument is a plain
Python object whose update is one attribute add (GIL-atomic for our
single-writer engine loop; the HTTP scrape path reads under the server's
engine lock). Callers cache instrument references once
(``self._c_steps = registry.counter(...)``) instead of re-resolving the
name per event — resolution cost is paid at construction, not per step.

Naming follows the Prometheus conventions the ``/metrics`` endpoint
exposes: ``*_total`` for counters, base units in the name
(``*_seconds``, ``*_bytes``), labels as a frozen kv set. ``snapshot()``
flattens everything into one JSON-friendly dict — the canonical form
``SolveEngine.stats()`` / ``SolveService.stats()`` build on — and
``render_prometheus()`` emits the text exposition format.
"""
# repro: gauge-path — stdlib-only by invariant: observing must never sync the device
from __future__ import annotations

import threading

# Default histogram bucket upper bounds (seconds-flavored: the engine's
# latency histograms span sub-ms dispatch to multi-minute solves).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 300.0, 1800.0)


def _label_suffix(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone accumulator. ``inc`` is the only mutator."""

    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels=(), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self.value = 0.0

    def inc(self, v: float = 1.0):
        self.value += v


class Gauge:
    """Point-in-time value; ``set`` or ``inc`` (negative allowed)."""

    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels=(), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, v: float = 1.0):
        self.value += v


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: bucket i counts
    observations <= bounds[i]; +Inf is implicit via ``count``)."""

    __slots__ = ("name", "labels", "help", "bounds", "bucket_counts",
                 "count", "sum")

    def __init__(self, name: str, labels=(), help: str = "",
                 buckets=DEFAULT_BUCKETS):
        self.name, self.labels, self.help = name, labels, help
        self.bounds = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float):
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1


class MetricsRegistry:
    """Create-or-get instruments by (name, labels); snapshot/render all.

    Creation takes a lock (registration can race the scrape thread);
    updates on the returned instruments are lock-free.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels=lab, help=help, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def snapshot(self) -> dict:
        """Flat JSON-friendly dict of every instrument's current value.

        Counters/gauges map ``name{k="v"}`` -> number; histograms expand
        to ``name_count``, ``name_sum``, and ``name_avg`` (buckets are a
        wire-format detail — ``render_prometheus`` carries them)."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            base = m.name + _label_suffix(m.labels)
            if isinstance(m, Histogram):
                out[base + "_count"] = m.count
                out[base + "_sum"] = m.sum
                out[base + "_avg"] = m.sum / m.count if m.count else None
            else:
                out[base] = m.value
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (one # HELP / # TYPE pair per family)."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, list] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            fam = by_name[name]
            kind = ("counter" if isinstance(fam[0], Counter) else
                    "histogram" if isinstance(fam[0], Histogram) else
                    "gauge")
            help_text = next((m.help for m in fam if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for m in fam:
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.bounds, m.bucket_counts):
                        lab = dict(m.labels)
                        lab["le"] = repr(b) if b != int(b) else str(int(b))
                        suffix = _label_suffix(
                            tuple(sorted(lab.items())))
                        cum = c  # bucket_counts are already cumulative
                        lines.append(f"{name}_bucket{suffix} {cum}")
                    inf_lab = _label_suffix(tuple(sorted(
                        dict(m.labels, le="+Inf").items())))
                    lines.append(f"{name}_bucket{inf_lab} {m.count}")
                    suffix = _label_suffix(m.labels)
                    lines.append(f"{name}_sum{suffix} {m.sum}")
                    lines.append(f"{name}_count{suffix} {m.count}")
                else:
                    suffix = _label_suffix(m.labels)
                    lines.append(f"{name}{suffix} {m.value}")
        return "\n".join(lines) + "\n"
