"""Optimisation of the port — counterpart of :mod:`repro.optim`: AdamW
(from scratch), schedules, gradient compression."""

from repro_torch.optim import adamw, compress, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "compress", "schedule", "AdamWConfig"]
