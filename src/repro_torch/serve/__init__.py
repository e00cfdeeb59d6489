"""The serving tier in front of the port's solve engine.

Port of :mod:`repro.serve`: the same wire contract (envelopes, sheds with
``Retry-After``, long-polls, zero lost acknowledged jobs across a worker
kill), in front of :mod:`repro_torch.engine` on the card.

``errors``
    The standard wire error envelope (``{error, code, job_id?,
    status?}``) and :class:`ApiError`, the exception every layer maps
    failures into.
``validate``
    Request schema validation — malformed submissions answer schema'd
    400s naming the offending field, never an engine traceback.
``limits``
    Bearer-token auth, per-tenant token-bucket rate limits, and quota
    accounting.
``frontend``
    The hardened single-worker HTTP front door: bounded request
    admission with backpressure (429/503 + ``Retry-After``), capped
    bodies, per-request deadlines, long-poll ``/result?wait=``,
    lock-free ``/healthz`` and ``/metrics``, and a condition-variable
    stepper that runs the engine's device work on its own thread.
``worker`` / ``router``
    Scale-out: N engine worker processes, each owning a journaled
    checkpoint dir, behind a supervising router that health-probes
    them, restarts crashed workers (fsck ``--repair`` + journal
    resume — zero completed work lost), and routes jobs per objective
    family.

Only ``errors``/``validate``/``limits`` import eagerly here — the HTTP
modules pull in the engine (and therefore torch), which stdlib-only
consumers of the envelope and the router must not pay for.
"""
from repro_torch.serve.errors import ApiError, envelope  # noqa: F401
from repro_torch.serve.limits import TenantTable, TokenBucket  # noqa: F401
from repro_torch.serve.validate import (  # noqa: F401
    validate_cancel, validate_submit)
