"""Device placement for the port's entry points.

``device=None`` means ``"cuda"``.  A CUDA device without a card raises:
an entry point never falls back to the CPU; callers (the tests) ask for
the CPU explicitly with ``device="cpu"``.  On the card, float32 matrix
products and convolutions are pinned to full fp32 (no TF32), because the
JAX reference computes in fp32 everywhere and TF32 would break token
parity with it.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "to_tensor"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_tensor(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """numpy array, scalar or tensor -> tensor on ``device`` (default: where
    it already is, the CPU for host data).  A tensor already on ``device``
    is returned as is — shared, never copied.  A bfloat16 array (the
    ``ml_dtypes`` type JAX's arrays convert to, which ``torch.from_numpy``
    refuses; recognised by its dtype's name) becomes a bfloat16 tensor bit
    for bit, through a 16-bit integer view."""
    if isinstance(x, torch.Tensor):
        return x if device is None or x.device == device else x.to(device)
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)
