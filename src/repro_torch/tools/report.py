"""Report helpers — counterpart of :mod:`repro.tools.report`.  Only
:func:`weight_bytes` is ported so far (for ``cnn_eval --int8``); the
serving and footprint tables come with the benchmark port."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["weight_bytes"]


def weight_bytes(obj) -> int:
    """Total bytes of stored parameters for a Graph or Program: the
    on-device weight footprint, which int8 quantization shrinks ~4x.
    Parameters may be numpy arrays or tensors (on any device)."""
    graph = getattr(obj, "graph", obj)
    return int(sum(v.element_size() * v.numel() if isinstance(v, torch.Tensor)
                   else np.asarray(v).nbytes for v in graph.params.values()))
