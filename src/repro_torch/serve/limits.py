"""Bearer-token auth, per-tenant token-bucket rate limits, quotas.

Port of :mod:`repro.serve.limits`, unchanged.

A *tenant* is one paying identity: a bearer token, an optional
steady-state request rate (token bucket — bursts up to ``burst`` are
free, sustained traffic is capped at ``rate`` req/s with an honest
``Retry-After``), and an optional job quota (total submissions this
server lifetime — accounting, not throttling: when it's spent, submits
answer 429 ``quota_exceeded`` until an operator raises it).

Configured from a compact spec (mirrors the fault-injection grammar)::

    token[:key=val]*[;token...]

    s3cret:name=alice:rate=5:burst=10:quota=100
    guest-token:name=guest:rate=0.5

Auth is OFF when no table is configured (``tenants=None``) — the
localhost demo and in-process tests keep working unauthenticated; a
deployment that sets ``--auth`` gets 401s for everyone else. The
check itself is constant-time per request: one dict lookup via
``hmac.compare_digest`` over the candidate token.

Stdlib-only; clock injectable for deterministic tests.
"""
from __future__ import annotations

import hmac
import time
from dataclasses import dataclass, field

from repro_torch.serve.errors import ApiError


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``take()`` is the only mutator: it refills from the elapsed clock,
    then either spends one token (returns 0.0) or returns the seconds
    until the next token lands (the honest ``Retry-After``). A rate of
    0 (or None) disables limiting — take always grants.
    """

    def __init__(self, rate: float | None, burst: float | None = None,
                 clock=time.monotonic):
        if rate is not None and rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        if burst is not None and burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate) if rate else 0.0
        self.burst = float(burst if burst is not None
                           else max(self.rate, 1.0))
        self.tokens = self.burst
        self._clock = clock
        self._last = clock()

    def take(self, now: float | None = None) -> float:
        if self.rate <= 0:
            return 0.0
        if now is None:
            now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


@dataclass
class Tenant:
    """One authenticated identity plus its live accounting."""

    name: str
    token: str
    bucket: TokenBucket | None = None
    quota_jobs: int | None = None    # lifetime submit budget (None = ∞)
    jobs_used: int = 0
    requests: int = 0
    rejected: int = field(default=0, repr=False)


class TenantTable:
    """token -> Tenant map; the front door's auth + limits gate."""

    def __init__(self, tenants: list[Tenant]):
        self._by_token: dict[str, Tenant] = {}
        names = set()
        for t in tenants:
            if t.token in self._by_token:
                raise ValueError(f"duplicate token for tenant {t.name!r}")
            if t.name in names:
                raise ValueError(f"duplicate tenant name {t.name!r}")
            names.add(t.name)
            self._by_token[t.token] = t

    @classmethod
    def from_spec(cls, spec: str, clock=time.monotonic) -> "TenantTable":
        """Parse ``token[:key=val]*[;token...]`` (see module docstring)."""
        tenants = []
        for i, part in enumerate(p for p in spec.split(";") if p.strip()):
            fields = part.strip().split(":")
            token, kvs = fields[0].strip(), fields[1:]
            if not token:
                raise ValueError(f"empty token in tenant spec {part!r}")
            kw: dict = {}
            for kv in kvs:
                if "=" not in kv:
                    raise ValueError(
                        f"bad tenant field {kv!r} in {part!r}")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k == "name":
                    kw["name"] = v.strip()
                elif k in ("rate", "burst"):
                    kw[k] = float(v)
                elif k == "quota":
                    kw["quota_jobs"] = int(v)
                else:
                    raise ValueError(
                        f"unknown tenant key {k!r} in {part!r}")
            rate = kw.pop("rate", None)
            burst = kw.pop("burst", None)
            bucket = (TokenBucket(rate, burst, clock=clock)
                      if rate is not None else None)
            tenants.append(Tenant(name=kw.pop("name", f"tenant-{i}"),
                                  token=token, bucket=bucket, **kw))
        if not tenants:
            raise ValueError(f"no tenants in auth spec {spec!r}")
        return cls(tenants)

    def __len__(self) -> int:
        return len(self._by_token)

    @property
    def tenants(self) -> list[Tenant]:
        return list(self._by_token.values())

    def authenticate(self, auth_header: str | None) -> Tenant:
        """``Authorization: Bearer <token>`` -> Tenant, or 401.

        The 401 message never distinguishes missing vs unknown tokens —
        that distinction is an oracle for token guessing."""
        candidate = ""
        if auth_header:
            scheme, _, rest = auth_header.partition(" ")
            if scheme.lower() == "bearer":
                candidate = rest.strip()
        # compare against every token with a constant-time digest so a
        # lookup can't leak prefix-match timing; the table is small
        # (tenants, not users) so the scan is noise
        found = None
        for token, tenant in self._by_token.items():
            if hmac.compare_digest(candidate, token):
                found = tenant
        if found is None:
            raise ApiError(401, "unauthorized",
                           "missing or unknown bearer token")
        found.requests += 1
        return found

    def check_rate(self, tenant: Tenant, now: float | None = None) -> None:
        """Spend one rate token or raise 429 with Retry-After."""
        if tenant.bucket is None:
            return
        wait = tenant.bucket.take(now)
        if wait > 0:
            tenant.rejected += 1
            raise ApiError(
                429, "rate_limited",
                f"tenant {tenant.name!r} over its rate limit "
                f"({tenant.bucket.rate:g} req/s)", retry_after=wait)

    def check_quota(self, tenant: Tenant) -> None:
        """Raise 429 ``quota_exceeded`` if the tenant's job quota is
        spent. Checked BEFORE the engine sees the submission (no engine
        work for an out-of-quota tenant)."""
        if tenant.quota_jobs is not None \
                and tenant.jobs_used >= tenant.quota_jobs:
            tenant.rejected += 1
            raise ApiError(
                429, "quota_exceeded",
                f"tenant {tenant.name!r} exhausted its job quota "
                f"({tenant.quota_jobs})")

    def charge_job(self, tenant: Tenant) -> None:
        """Account one accepted job. Called only after the engine
        ACCEPTED the submission — a shed or invalid request must not
        burn quota."""
        tenant.jobs_used += 1
