"""Checkpointing for the port: the snapshot + journal manager on torch
tensors (:mod:`.manager`) and the directory checker (:mod:`.fsck`), on the
reference's on-disk layout. The manager is imported on first use, so that
``python -m repro_torch.checkpoint.fsck`` runs on numpy alone and starts
without importing torch."""

__all__ = ["CheckpointManager"]


def __getattr__(name):
    if name == "CheckpointManager":
        from repro_torch.checkpoint.manager import CheckpointManager
        return CheckpointManager
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
