"""Standard wire error envelope for the serving tier.

Port of :mod:`repro.serve.errors`, unchanged: the same codes, statuses
and envelope.

Every non-200 response body is one shape::

    {"error": <human message>, "code": <machine code>,
     "job_id": <when known>, "status": <job status, when known>}

``code`` is the stable machine-readable contract — clients branch on it
(and the HTTP status class); ``error`` is for humans and may change
wording freely. Backpressure codes additionally carry a ``Retry-After``
header (seconds, integral) — in the header, never the body, so generic
HTTP clients honor it without parsing JSON.

The code catalog (HTTP status -> codes):

=====  ===============================================================
400    ``bad_json``, ``bad_request`` (schema violation, names the
       field), ``bad_length`` (negative / non-integer Content-Length)
401    ``unauthorized`` (missing/unknown bearer token)
404    ``unknown_job``, ``unknown_endpoint``
409    ``conflict`` (terminal CANCELLED/FAILED job has no result)
411    ``length_required`` (POST without Content-Length)
413    ``body_too_large``
429    ``queue_full`` (engine admission), ``rate_limited`` (tenant
       token bucket), ``quota_exceeded`` (tenant job quota)
503    ``memory_budget`` (engine shed), ``saturated`` (request queue
       full), ``deadline`` (request deadline passed while waiting),
       ``shutting_down``, ``worker_unavailable`` (router: worker down,
       restart in progress)
500    ``internal`` (anything unmapped — a bug, never policy)
=====  ===============================================================

202 (``not_done``) is the one non-error envelope citizen: a /result
for a job that exists but has not finished carries the same fields so
clients need exactly one decoder.

This module is stdlib-only by design: the router imports it without
paying for torch.
"""
from __future__ import annotations


class ApiError(Exception):
    """A wire-mappable failure: HTTP status + machine code + envelope.

    Raised anywhere in the serving tier and converted to exactly one
    JSON reply at the handler boundary. ``retry_after`` (seconds) turns
    into the ``Retry-After`` header on the way out.
    """

    def __init__(self, http_status: int, code: str, message: str, *,
                 job_id: str | None = None, status: str | None = None,
                 retry_after: float | None = None):
        super().__init__(message)
        self.http_status = int(http_status)
        self.code = code
        self.message = message
        self.job_id = job_id
        self.status = status
        self.retry_after = retry_after

    def payload(self) -> dict:
        return envelope(self.message, self.code,
                        job_id=self.job_id, status=self.status)


def envelope(message: str, code: str, *, job_id: str | None = None,
             status: str | None = None) -> dict:
    """Build the standard error-envelope body."""
    out = {"error": message, "code": code}
    if job_id is not None:
        out["job_id"] = job_id
    if status is not None:
        out["status"] = status
    return out


def bad_request(message: str, *, field: str | None = None) -> ApiError:
    """Schema'd 400: the message names the offending field so a client
    can fix the request without reading server code."""
    if field is not None:
        message = f"field {field!r}: {message}"
    return ApiError(400, "bad_request", message)


# dict-level codes (repro_torch.engine.service emits them) -> HTTP status.
# The service stays a clean dict-in/dict-out API; the front-end maps
# its machine codes onto the wire without string-matching error text.
CODE_STATUS = {
    "unknown_job": 404,
    "not_done": 202,
    "conflict": 409,
}


def status_for(payload: dict, default: int = 200) -> int:
    """HTTP status for a service-layer payload (200 when no code)."""
    return CODE_STATUS.get(payload.get("code"), default) \
        if isinstance(payload, dict) else default
