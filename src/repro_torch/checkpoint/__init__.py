"""Checkpointing of the port — counterpart of :mod:`repro.checkpoint`:
trees of tensors to the JAX package's on-disk format, async saves,
rotation and restore."""

from repro_torch.checkpoint import io  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["io", "CheckpointManager"]
