"""Request schema validation for the serving tier.

Port of :mod:`repro.serve.validate`, unchanged: the port's ``ABOConfig``
has the reference's fields, so the accepted schema is the same.

Wire payloads are validated HERE, at the front door, before anything
touches the engine: a malformed submission answers a schema'd 400
(:func:`repro_torch.serve.errors.bad_request`, message naming the field),
never a traceback out of ``JobSpec.from_dict`` or — worse — an
AttributeError deep inside the step loop. The engine keeps its own
semantic validation (seed ranges, x0/n agreement, config coherence);
this layer rejects the *shape* errors an untrusted client can send:
wrong types, unknown fields, absurd sizes.

``ABOConfig`` is imported lazily (it pulls in torch) so the module stays
importable in dependency-free contexts alongside ``errors``.
"""
from __future__ import annotations

import dataclasses
import numbers

from repro_torch.serve.errors import bad_request

# top-level /submit fields -> allowed types (None entries are checked
# specially below). Anything not in this table is rejected: unknown
# fields are typos or probes, and silently ignoring either is how a
# client ships a request that "works" but doesn't do what it says.
_SUBMIT_FIELDS = ("objective", "n", "config", "seed", "x0", "tag", "ttl_s")

_config_field_types: dict[str, type] | None = None


def _config_fields() -> dict:
    global _config_field_types
    if _config_field_types is None:
        from repro_torch.core.abo import ABOConfig
        _config_field_types = {f.name: f for f in
                               dataclasses.fields(ABOConfig)}
    return _config_field_types


def _want_int(v, field: str, lo: int | None = None) -> int:
    # bool is an int subclass — reject it, a client sending true for n
    # meant something else
    if isinstance(v, bool) or not isinstance(v, numbers.Integral):
        raise bad_request(f"expected an integer, got {type(v).__name__}",
                          field=field)
    v = int(v)
    if lo is not None and v < lo:
        raise bad_request(f"must be >= {lo}, got {v}", field=field)
    return v


def validate_submit(req, *, max_n: int | None = None) -> dict:
    """Validate a /submit body; returns it unchanged, raises ApiError.

    ``max_n`` is the front door's size cap: a public endpoint must not
    let one request commission a terabyte lane (admission control then
    prices the *accepted* work; this bounds the unpriceable)."""
    if not isinstance(req, dict):
        raise bad_request(
            f"body must be a JSON object, got {type(req).__name__}")
    unknown = [k for k in req if k not in _SUBMIT_FIELDS]
    if unknown:
        raise bad_request(
            f"unknown field(s) {sorted(unknown)}; accepted: "
            f"{list(_SUBMIT_FIELDS)}")
    if "objective" not in req:
        raise bad_request("required", field="objective")
    if not isinstance(req["objective"], str):
        raise bad_request(
            f"expected a string, got {type(req['objective']).__name__}",
            field="objective")
    if "n" not in req:
        raise bad_request("required", field="n")
    n = _want_int(req["n"], "n", lo=1)
    if max_n is not None and n > max_n:
        raise bad_request(
            f"n={n} exceeds this server's limit of {max_n}", field="n")
    if "seed" in req and req["seed"] is not None:
        _want_int(req["seed"], "seed")
    if "tag" in req and not isinstance(req["tag"], str):
        raise bad_request(
            f"expected a string, got {type(req['tag']).__name__}",
            field="tag")
    if "ttl_s" in req and req["ttl_s"] is not None:
        v = req["ttl_s"]
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise bad_request(
                f"expected a number, got {type(v).__name__}", field="ttl_s")
        if not float(v) > 0:
            raise bad_request(f"must be > 0, got {v}", field="ttl_s")
    if "x0" in req and req["x0"] is not None:
        x0 = req["x0"]
        if not isinstance(x0, (list, tuple)):
            raise bad_request(
                f"expected a list of numbers, got {type(x0).__name__}",
                field="x0")
        if len(x0) != n:
            raise bad_request(
                f"has {len(x0)} entries for an n={n} job", field="x0")
        for i, v in enumerate(x0):
            if isinstance(v, bool) or not isinstance(v, numbers.Real):
                raise bad_request(
                    f"entry {i} is {type(v).__name__}, expected a number",
                    field="x0")
    if "config" in req and req["config"] is not None:
        cfg = req["config"]
        if not isinstance(cfg, dict):
            raise bad_request(
                f"expected an object of ABOConfig fields, got "
                f"{type(cfg).__name__}", field="config")
        known = _config_fields()
        bad = [k for k in cfg if k not in known]
        if bad:
            raise bad_request(
                f"unknown key(s) {sorted(bad)}; accepted: "
                f"{sorted(known)}", field="config")
        for k, v in cfg.items():
            if isinstance(v, (dict, list)):
                raise bad_request(
                    f"key {k!r} must be a scalar, got "
                    f"{type(v).__name__}", field="config")
    return req


def validate_cancel(req) -> str:
    """Validate a /cancel body; returns the job id."""
    if not isinstance(req, dict):
        raise bad_request(
            f"body must be a JSON object, got {type(req).__name__}")
    job_id = req.get("job_id")
    if not isinstance(job_id, str) or not job_id:
        raise bad_request("required (a job id string)", field="job_id")
    return job_id
