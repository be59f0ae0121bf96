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

Elastic checkpoints (JAX's ``restore(..., shardings=...)``): a tree of a
rank's slices on a :class:`~repro_torch.launch.mesh.ProcessMesh` is saved
with its specs and mesh (``save(..., specs=, mesh=)``: every leaf gathered
in turn to rank 0 (:func:`gather_to_host`), which writes the whole leaves,
then every rank waits at a barrier), so the file is the one a single
device writes;
``restore(..., specs=, mesh=)`` hands each rank of any mesh its slice.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike
from repro_torch.core.tree import leaves_with_paths, tree_unflatten
from repro_torch.sharding.specs import shard, spec_axes, spec_leaves

__all__ = ["save", "restore", "restore_metadata", "list_steps", "to_host", "gather_to_host"]

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


def gather_to_host(tree: Any, specs: Any, mesh: Any) -> Optional[Dict[str, np.ndarray]]:
    """The whole leaves of a tree of this rank's slices (``specs`` on the
    ProcessMesh ``mesh``) as host arrays by key on rank 0, ``None`` on the
    others (collective).  Leaf by leaf, every rank's slice goes to rank 0
    (``dist.gather``; through host memory over gloo), which puts each at
    its rank's coordinates."""
    rank0, world = mesh.rank == 0, math.prod(mesh.sizes)
    flat = {}
    for (path, leaf), spec in zip(leaves_with_paths(tree), spec_leaves(tree, specs)):
        part = leaf.detach().contiguous()
        if mesh.backend != "nccl":
            part = part.cpu()
        parts = [torch.empty_like(part) for _ in range(world)] if rank0 else None
        dist.gather(part, parts, dst=0)
        if not rank0:
            continue
        axes = [spec_axes(e) for e in spec] + [()] * (part.dim() - len(spec))
        whole = None
        for r, piece in enumerate(parts):
            blocks = [mesh.block(ax, mesh.coords_of(r)) for ax in axes]
            if whole is None:
                whole = torch.empty([n * k for n, (k, _) in zip(piece.shape, blocks)],
                                    dtype=piece.dtype)
            whole[tuple(slice(i * n, (i + 1) * n) for n, (_, i) in zip(piece.shape, blocks))] \
                = piece
        flat[_key(path)] = to_host(whole)
    return flat if rank0 else None


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[Dict[str, Any]] = None,
         *, specs: Any = None, mesh: Any = None) -> str:
    """Write checkpoint for ``step``; returns the final directory path.
    With ``specs`` and ``mesh`` ``tree`` is this rank's slices and every
    rank calls it (the module docstring)."""
    if mesh is None:
        return _write(ckpt_dir, step, _flatten(tree), metadata)
    flat = gather_to_host(tree, specs, mesh)
    path = _write(ckpt_dir, step, flat, metadata) if flat is not None else \
        os.path.join(ckpt_dir, f"step_{step:08d}")
    dist.barrier()
    return path


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
          metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write host arrays by key as the checkpoint for ``step``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
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
            device: DeviceLike = None, *, specs: Any = None, mesh: Any = None) -> Any:
    """Restore into the structure of ``target``, a tree of tensors that
    gives each leaf's shape and dtype (``meta`` tensors allocate nothing).
    Returns new tensors on ``device``, or where each target leaf lies; with
    ``specs`` and ``mesh`` (a ProcessMesh, or any mesh with ``coords``)
    each leaf's slice for this rank, cut on the host.  A leaf missing from
    the checkpoint raises ``KeyError``, a shape that differs or a dtype that
    cannot be cast ``ValueError``."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    out = []
    leaf_specs = spec_leaves(target, specs) if mesh is not None else None
    with np.load(path) as z:
        files = set(z.files)
        for i, (pth, leaf) in enumerate(leaves_with_paths(target)):
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
            host = torch.from_numpy(arr)
            if leaf_specs is not None:
                host = shard(host, leaf_specs[i], mesh)
            out.append(host.to(device=dev, dtype=leaf.dtype))
    return tree_unflatten(target, out)
