"""Checkpoint I/O: tree save/restore — counterpart of
:mod:`repro.checkpoint.io`, in its on-disk format.

A checkpoint is ``<dir>/step_%08d/arrays.npz`` (every leaf as a host
numpy array, keyed by its tree path: dict keys and list indices joined by
``/``) plus ``meta.json`` (the step, the sorted keys and the caller's
metadata).  The paths and the leaf order are JAX's
(:mod:`repro_torch.core.tree`), so the JAX package restores what the port
saves and the port what the JAX package saves, bit for bit, the int32
``step`` included.

A bfloat16 leaf is written as the JAX package writes it: its raw two-byte
values as a numpy void (``V2``) array.  Neither package can cast such an
array back (numpy has no bfloat16), so restoring it raises ``ValueError``
in both, as the JAX package's ``astype`` does.

Atomicity: writes go to ``<dir>.tmp`` then ``os.replace`` — a crash
mid-write never corrupts the previous checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike
from repro_torch.core.tree import leaves_with_paths, tree_unflatten

__all__ = ["save", "restore", "restore_metadata", "list_steps", "to_host"]

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def to_host(leaf: Any) -> np.ndarray:
    """A tensor (any device) or array as the host array the file holds: a
    copy, so an in-place update of the leaf after the call leaves it be."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {_key(path): to_host(leaf) for path, leaf in leaves_with_paths(tree)}


def save(ckpt_dir: str, step: int, tree: Any,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint for ``step``; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": int(step), "keys": sorted(flat), **(metadata or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True, default=str)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(steps)


def restore_metadata(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            device: DeviceLike = None) -> Any:
    """Restore into the structure of ``target``, a tree of tensors that
    gives each leaf's shape and dtype (``meta`` tensors allocate nothing).
    Returns new tensors on ``device``, or where each target leaf lies.  A
    leaf missing from the checkpoint raises ``KeyError``, a shape that
    differs or a dtype that cannot be cast ``ValueError``."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    out = []
    with np.load(path) as z:
        files = set(z.files)
        for pth, leaf in leaves_with_paths(target):
            key = _key(pth)
            if key not in files:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = z[key]
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"target {want_shape}")
            if arr.dtype.kind == "V":
                raise ValueError(f"{key}: No cast function available from the checkpoint's "
                                 f"raw {arr.dtype.str} values to {leaf.dtype}")
            dev = leaf.device if device is None else torch.device(device)
            # (np.ascontiguousarray would make a 0-d array 1-d)
            arr = arr if arr.flags.c_contiguous else arr.copy()
            out.append(torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype))
    return tree_unflatten(target, out)
