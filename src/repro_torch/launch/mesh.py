"""Meshes of the port — counterpart of :mod:`repro.launch.mesh`.

A tensor-parallel engine is one process a rank, in PyTorch's idiom: every
rank runs the same engine on the same requests and holds its slice of the
KV heads.  :func:`make_serving_mesh` joins (or initialises) the process
group of those ranks and returns it as a 1-D ``("model",)``
:class:`ProcessMesh`; :func:`make_mesh` returns a :class:`ProcessMesh` of
any number of axes over the whole group (sharded training:
``("data", "model")``, the pipeline's ``("pod", ...)``), with one process
group an axis or set of axes; :func:`make_test_mesh` is JAX's 2-D ``(data, model)`` layout for the
partition rules and bundles, with no process group behind it.

The process group comes from the usual ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` environment, which ``torchrun`` or
:func:`spawn_ranks` sets.  The backend:

* ``nccl`` when each rank has its own card (``device="cuda"``: rank r on
  ``cuda:LOCAL_RANK``);
* ``gloo`` on the CPU, and when the ranks share a card (``device="cuda:K"``:
  every rank on card K) — NCCL refuses two ranks on one device, so asking
  for ``nccl`` there raises.

The choice is printed, never silent.  gloo takes no point-to-point op on
CUDA tensors, so the ring matmul of :mod:`repro_torch.sharding.collectives`
stages its chunks through host memory there: a transport detail, not a
compute fallback.

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --engine --tp 2 --device cuda:0          # two ranks on one card
"""

from __future__ import annotations

import itertools
import math
import os
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike, resolve_device

__all__ = ["Mesh", "ProcessMesh", "make_mesh", "make_serving_mesh", "make_test_mesh",
           "make_fake_mesh", "make_production_mesh", "spawn_ranks"]


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes — all the partition rules read of a mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def block(self, axes: Sequence[str], coords: Dict[str, int]) -> Tuple[int, int]:
        """(n, i): a dim split over ``axes`` splits into n blocks, the product
        of their sizes, and the mesh coordinates ``coords`` hold block i,
        row-major over them (as GSPMD splits a dim named by several axes)."""
        n, i = 1, 0
        for a in axes:
            n, i = n * self.shape[a], i * self.shape[a] + coords[a]
        return n, i


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """JAX's small 2-D ``(data, model)`` layout, for the partition rules and
    bundles (no process group)."""
    return Mesh(("data", "model"), (data, model))


def _world() -> Tuple[int, int, bool]:
    """(world size, rank, group initialised)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), True
    return int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0")), False


def _rank_device(device: DeviceLike, tp: int) -> Tuple[torch.device, bool]:
    """The rank's device and whether the ranks share it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return resolve_device(dev), False
    if dev.index is not None:
        return resolve_device(dev), tp > 1
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    resolve_device("cuda")                      # raises without a card
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(
            f"rank {local} needs a card of its own: {count} visible; pass device='cuda:0' "
            f"to run the ranks on one card over gloo")
    return resolve_device(torch.device("cuda", local)), False


def _join(dev: torch.device, shared: bool, backend: Optional[str], initialised: bool,
          rank: int, world: int) -> Tuple[str, str]:
    """Pick the backend of the ``world``-rank group (the module docstring's rule),
    initialise the group from the environment unless it is already, and
    return (backend, why)."""
    if backend is not None:
        chosen, why = backend, "asked for"
    elif initialised:
        chosen, why = dist.get_backend(), "the initialised group's"
    elif dev.type == "cuda" and not shared:
        chosen, why = "nccl", "one card a rank"
    else:
        chosen, why = "gloo", "ranks share one card" if dev.type == "cuda" else "CPU"
    if chosen == "nccl" and (dev.type != "cuda" or shared):
        raise ValueError(f"backend nccl needs one card a rank; the {world} ranks are on "
                         f"{dev if dev.type == 'cuda' else 'the CPU'} (use gloo)")
    if initialised and dist.get_backend() != chosen:
        raise ValueError(f"backend {chosen} asked for; the initialised group runs "
                         f"{dist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not initialised:
        if os.environ.get("MASTER_ADDR") in ("127.0.0.1", "localhost"):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(chosen, init_method="env://", rank=rank, world_size=world)
    return chosen, why


def make_serving_mesh(tp: int = 1, *, backend: Optional[str] = None,
                      device: DeviceLike = None) -> "ProcessMesh":
    """The 1-D ``("model",)`` serving mesh of ``tp`` ranks, for
    ``build_lm_serving(mesh=...)`` and ``launch.serve --tp``.

    ``tp`` must be 1 (no group) or the size of the process group: the group
    already initialised, else the one the environment describes, which is
    initialised here.  ``device`` is the rank's (``None`` means ``"cuda"``:
    one card a rank); ``backend`` defaults as the module docstring says.
    With ``tp == 1`` no group is joined and the mesh has none (its one-rank
    axis runs no collective)."""
    world, rank, initialised = _world()
    if tp < 1 or tp > world:
        raise ValueError(f"tp={tp} needs 1..{world} devices")
    if 1 < tp < world:
        raise ValueError(f"tp={tp} on a group of {world} ranks: a serving mesh spans the "
                         f"whole group")
    dev, shared = _rank_device(device, tp)
    if tp == 1:
        return ProcessMesh(("model",), (1,), 0, dev, None, {("model",): None})
    chosen, why = _join(dev, shared, backend, initialised, rank, world)
    mesh = ProcessMesh(("model",), (tp,), rank, dev, chosen, {("model",): dist.group.WORLD})
    print(f"[mesh] tp={tp} rank {rank}: device {dev}, backend {chosen} ({why})", flush=True)
    return mesh


# --------------------------------------------------------------------------- #
# process meshes of several axes (sharded training, the pipeline)
# --------------------------------------------------------------------------- #

Axes = Union[str, Sequence[str]]


class ProcessMesh(Mesh):
    """This process's place in a mesh of ``shape`` over the whole process
    group: rank r sits at the row-major coordinates of r (the order in
    which ``jax.make_mesh`` lays out CPU devices).  ``group(axes)`` is the
    process group of the ranks that differ from this one only along
    ``axes`` (one axis name or several, in the mesh's order), their group
    ranks row-major over those axes; :func:`axis_index` is this rank's
    place in it.  ``traffic`` counts the bytes of the results of the
    collectives run on it: each all-gather's whole output under
    ``"gathered"``, each all-reduced tensor under ``"reduced"``;
    ``collectives`` maps (HLO op name, group size) to [calls, result
    bytes] for the same collectives, what the roofline's ring costs read."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...], rank: int,
                 device: torch.device, backend: str, groups: Dict[Tuple[str, ...], Any]):
        super().__init__(tuple(axis_names), tuple(sizes))
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "coords", self.coords_of(rank))
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "backend", backend)
        object.__setattr__(self, "_groups", groups)
        # bytes of the collectives' results on this rank (sharding.collectives)
        object.__setattr__(self, "traffic", {"gathered": 0, "reduced": 0})
        object.__setattr__(self, "collectives", {})

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of global rank ``rank`` (row-major)."""
        out = {}
        for a, n in reversed(list(zip(self.axis_names, self.sizes))):
            rank, out[a] = divmod(rank, n)
        return {a: out[a] for a in self.axis_names}

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if not key or any(a not in self.axis_names for a in key) or \
                list(key) != sorted(key, key=self.axis_names.index):
            raise ValueError(f"axes {axes!r}: name axes of {self.axis_names} in its order")
        return key

    def group(self, axes: Axes):
        """The process group along ``axes``."""
        return self._groups[self._key(axes)]

    def axis_size(self, axes: Axes) -> int:
        return self.block(self._key(axes), self.coords)[0]

    def axis_index(self, axes: Axes) -> int:
        """This rank's group rank along ``axes`` (row-major coordinates)."""
        return self.block(self._key(axes), self.coords)[1]

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def _axis_groups(axis_names: Tuple[str, ...], sizes: Tuple[int, ...]
                 ) -> Dict[Tuple[str, ...], Any]:
    """One process group for every non-empty set of axes (``WORLD`` for all
    of them), created on every rank in the same order: ``new_group`` is
    collective over the whole group."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    groups: Dict[Tuple[str, ...], Any] = {}
    for k in range(1, len(axis_names) + 1):
        for key in itertools.combinations(range(len(axis_names)), k):
            names = tuple(axis_names[i] for i in key)
            if k == len(axis_names):
                groups[names] = dist.group.WORLD
                continue
            fixed = [i for i in range(len(axis_names)) if i not in key]
            lists = []
            for outer in itertools.product(*(range(sizes[i]) for i in fixed)):
                base = sum(c * strides[i] for c, i in zip(outer, fixed))
                lists.append([base + sum(c * strides[i] for c, i in zip(inner, key))
                              for inner in itertools.product(*(range(sizes[i]) for i in key))])
            groups[names] = dist.new_subgroups_by_enumeration(lists)[0]
    return groups


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = None, backend: Optional[str] = None) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over the whole process group
    (initialised here from the environment unless it is already), whose
    size it must equal.  ``device`` and ``backend`` as in
    :func:`make_serving_mesh`."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
    world, rank, initialised = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    dev, shared = _rank_device(device, world)
    chosen, why = _join(dev, shared, backend, initialised, rank, world)
    mesh = ProcessMesh(axis_names, shape, rank, dev, chosen,
                       _axis_groups(axis_names, shape))
    print(f"[mesh] {dict(mesh.shape)} rank {rank} at {mesh.coords}: device {dev}, backend "
          f"{chosen} ({why})", flush=True)
    return mesh


def make_fake_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
                   rank: int = 0) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` in which this one process is rank
    ``rank`` of a ``fake`` process group of ``prod(shape)`` ranks
    (``torch.testing._internal.distributed.fake_pg``): its collectives run
    on fake tensors, move nothing and return at once, so a step can be
    lowered for one rank of a large mesh (:mod:`repro_torch.launch.dryrun`).
    The process's default group becomes that fake group (an earlier fake
    group of another size or rank is replaced; a real one raises), so run
    it in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(int(n) for n in shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(f"make_fake_mesh: this process is in a {dist.get_backend()} group")
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    return make_mesh(shape, axis_names, device="cpu")


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The dry-run meshes, as JAX's: single pod (data=16, model=16) = 256
    ranks; multi-pod (pod=2, data=16, model=16) = 512, "pod" data-parallel
    by default and the pipeline axis when pipelining.  This process is rank
    0 of a fake group of that size (:func:`make_fake_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


# --------------------------------------------------------------------------- #
# spawning ranks (tests, chip_smoke.py, launch.serve --tp)
# --------------------------------------------------------------------------- #

def _free_port() -> int:
    """A free TCP port on the loopback interface (the OS picks it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, tp: int, port: int, fn: Callable, args: tuple,
               queue: Any, env: Dict[str, str]) -> None:
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(tp),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        queue.put(("ok", rank, fn(*args)))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, tp: int, *args: Any, timeout: float = 600.0,
                env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``tp`` fresh processes, ranks 0..tp-1 of one
    group on a free loopback port (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` set, plus ``env``); ``fn`` builds its
    mesh with :func:`make_serving_mesh` or :func:`make_mesh`.  Returns each rank's return value,
    in rank order.  A rank that raises, or a run past ``timeout`` seconds,
    stops every rank and raises here (a rank left waiting in a collective
    never holds the caller).  ``fn`` must be importable by the children
    (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, tp, port, fn, args, queue, dict(env or {})),
                         daemon=True)
             for r in range(tp)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < tp:
            if not queue.empty():
                status, rank, value = queue.get()
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
                continue
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead and queue.empty():
                errors.append(f"rank {procs.index(dead[0])} exited with code "
                              f"{dead[0].exitcode} and no result")
                break
            if time.monotonic() > deadline:
                errors.append(f"timed out after {timeout:.0f} s with ranks "
                              f"{sorted(set(range(tp)) - set(results))} unfinished")
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn_ranks: " + "\n".join(errors))
    return [results[r] for r in range(tp)]
