"""Runtime guardrails for the engine's invariants (port of
:mod:`repro.analysis`'s runtime half). The static lint of the JAX package
(``python -m repro.analysis.lint src``) already covers ``src/repro_torch``:
its rules are syntactic and read the port's files as they are."""
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
