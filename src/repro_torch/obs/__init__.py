"""Engine telemetry: metrics registry, span tracer, roofline accounting.

Port of :mod:`repro.obs`. :mod:`.metrics` and :mod:`.trace` are the port's
own copies of the reference's stdlib-only modules; :mod:`.roofline` holds
the analytic bytes-per-pass model. Nothing here touches a device: gauges
are sampled only at stats/scrape boundaries, never per step.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.roofline import plan_pass_bytes  # noqa: F401
from repro_torch.obs.trace import NULL_SPAN, Tracer  # noqa: F401
