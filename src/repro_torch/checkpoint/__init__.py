"""Checkpointing for the port: the snapshot + journal manager on torch
tensors (:mod:`.manager`) and the directory checker (:mod:`.fsck`), on the
reference's on-disk layout."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
