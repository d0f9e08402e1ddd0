"""Checkpoints of the port, in the JAX package's on-disk format (own copy of
``repro.ckpt`` in PyTorch)."""
from .checkpoint import (CheckpointError, CheckpointManager,
                         ManifestMismatchError, TemplateMismatchError,
                         latest_step, restore, save)

__all__ = ["CheckpointError", "CheckpointManager", "ManifestMismatchError",
           "TemplateMismatchError", "latest_step", "restore", "save"]
