"""Runtime sanitizers for the engine's load-bearing disciplines, in PyTorch.

Port of :mod:`repro.analysis.sanitize`:

- ``compile_guard(budget)`` — eager PyTorch compiles nothing, so the
  compile budget of the reference becomes a budget of distinct pool
  *shapes*: ``compiles_so_far()`` counts the distinct shapes the
  ``PoolOps`` were called at in this process (pool size and plan or
  gather signature, ``engine.batched.compiled_executable_count``),
  and a region that builds more than its budget raises
  ``CompileBudgetExceeded``. A steady-state drain builds none, which is
  what the reference's one-executable-per-plan-signature rule asserts.

- ``sync_guard()`` / ``allowed_sync(reason)`` — a host-sync sanitizer. On
  the card, ``torch.cuda.set_sync_debug_mode("error")`` makes every
  synchronising CUDA call raise (``.item()``, ``.cpu()``, ``nonzero``,
  boolean-mask indexing, a blocking host-to-device copy). That mode sees
  nothing on the CPU, so the guard also intercepts the ``Tensor`` entry
  points that hand a value to the host (``item``, ``tolist``, ``numpy``,
  ``__array__``, ``__float__``, ``__int__``, ``__bool__``, ``__index__``),
  as the reference patches ``jax.Array``'s. Designed sync points declare
  themselves with ``allowed_sync``, which lifts both for its block.

- ``assert_donated(before, after)`` — in-place update is the PyTorch
  analogue of donation: a step that updates the pool in place leaves
  every state tensor on the storage it had before. The checker compares
  ``untyped_storage().data_ptr()`` across the step; a moved storage means
  the step copied the pool.

All three cost nothing when unused: the patches are installed on the first
``sync_guard()`` and check a thread-local flag before doing any work.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


class SanitizerError(AssertionError):
    """Base class: an engine invariant was violated at runtime."""


class CompileBudgetExceeded(SanitizerError):
    pass


class HostSyncError(SanitizerError):
    pass


class DonationError(SanitizerError):
    pass


# --------------------------------------------------------------------------
# compile_guard
# --------------------------------------------------------------------------
def compiles_so_far() -> int:
    """Process-wide count of distinct pool-operation shapes so far."""
    from repro_torch.engine.batched import compiled_executable_count
    return compiled_executable_count()


class compile_guard:
    """Context manager asserting a region builds at most ``budget`` pool
    shapes.

    >>> with compile_guard(budget=2, name="warmup") as g:
    ...     engine.step(); engine.step()
    >>> g.count   # shapes actually built inside the region
    """

    def __init__(self, budget: int, name: str = "region"):
        if budget < 0:
            raise ValueError("budget must be >= 0")
        self.budget = budget
        self.name = name
        self.count = 0
        self._start = 0

    def __enter__(self) -> "compile_guard":
        self._start = compiles_so_far()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.count = compiles_so_far() - self._start
        if exc_type is None and self.count > self.budget:
            raise CompileBudgetExceeded(
                f"compile_guard({self.name!r}): {self.count} pool shape(s) "
                f"built, budget {self.budget} — a plan signature or gather "
                "rung is perturbing the shape cache")


# --------------------------------------------------------------------------
# sync_guard / allowed_sync
# --------------------------------------------------------------------------
_state = threading.local()
_patch_lock = threading.Lock()
_patched = False

# Tensor entry points that hand a value (or a view of one) to the host.
_SYNC_METHODS = ("__array__", "__float__", "__int__", "__bool__",
                 "__index__", "item", "tolist", "numpy")


def _guard_depth() -> int:
    return getattr(_state, "depth", 0)


def _allowed_reason() -> str | None:
    return getattr(_state, "allowed", None)


def _install_patches() -> None:
    global _patched
    with _patch_lock:
        if _patched:
            return
        _patched = True
    for name in _SYNC_METHODS:
        original = getattr(torch.Tensor, name)

        def wrapper(self, *args, _name=name, _original=original, **kwargs):
            if _guard_depth() > 0 and _allowed_reason() is None:
                raise HostSyncError(
                    f"implicit host sync via Tensor.{_name} inside "
                    "sync_guard — wrap designed sync points in "
                    "allowed_sync(reason)")
            return _original(self, *args, **kwargs)

        wrapper.__name__ = name
        wrapper.__qualname__ = f"Tensor.{name}"
        setattr(torch.Tensor, name, wrapper)


def _cuda_mode() -> int | None:
    """The CUDA sync debug mode now, or None where there is no card."""
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() \
        else None


def _set_cuda_mode(mode) -> None:
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)


@contextmanager
def sync_guard():
    """Fail on any host sync inside the region: CUDA's sync debug mode
    set to "error" on the card, the Tensor entry-point patches on both.
    Reentrant; the patches' flag is thread-local, the CUDA mode is
    process-wide (the engine steps on one thread)."""
    _install_patches()
    prev = _cuda_mode()
    _state.depth = _guard_depth() + 1
    _set_cuda_mode(None if prev is None else "error")
    try:
        yield
    finally:
        _set_cuda_mode(prev)
        _state.depth -= 1


@contextmanager
def allowed_sync(reason: str):
    """Declare a designed sync point inside a ``sync_guard`` region."""
    if not reason:
        raise ValueError("allowed_sync requires a reason string")
    prev_reason, prev_mode = _allowed_reason(), _cuda_mode()
    _state.allowed = reason
    _set_cuda_mode(None if prev_mode is None else "default")
    try:
        yield
    finally:
        _set_cuda_mode(prev_mode)
        _state.allowed = prev_reason


# --------------------------------------------------------------------------
# donation checker
# --------------------------------------------------------------------------
def storage_ptrs(tensors) -> list[int]:
    """The storage address of each tensor, to hand to assert_donated."""
    return [t.untyped_storage().data_ptr() for t in tensors]


def assert_donated(before: list[int], after, context: str = "state") -> int:
    """Assert every tensor of ``after`` still lies on the storage recorded
    in ``before`` (``storage_ptrs`` taken just before an in-place step):
    the step updated the pool in place instead of copying it. Returns the
    number of tensors checked."""
    after = list(after)
    now = storage_ptrs(after)
    moved = [i for i, (a, b) in enumerate(zip(before, now)) if a != b]
    if len(before) != len(now) or moved:
        shapes = ", ".join(f"{tuple(after[i].shape)}:{after[i].dtype}"
                           for i in moved[:4])
        raise DonationError(
            f"{context}: {len(moved)}/{len(now)} state tensor(s) moved to "
            f"new storage ({shapes}{', ...' if len(moved) > 4 else ''}) — "
            "the step copied instead of updating in place")
    return len(now)
