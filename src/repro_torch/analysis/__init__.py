"""Guardrails for the engine's invariants (port of :mod:`repro.analysis`):
the runtime sanitizers here (``sanitize``), and the port's own static lint,
``python -m repro_torch.analysis.lint src/repro_torch`` (``lint``,
``rules``), whose rules read torch's host transfers and imports where the
JAX package's read JAX's."""
from repro_torch.analysis.sanitize import (  # noqa: F401
    CompileBudgetExceeded,
    DonationError,
    HostSyncError,
    SanitizerError,
    allowed_sync,
    assert_donated,
    compile_guard,
    compiles_so_far,
    storage_ptrs,
    sync_guard,
)
