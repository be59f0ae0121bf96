"""Meshes of the port — counterpart of :mod:`repro.launch.mesh`.

A tensor-parallel engine is one process a rank, in PyTorch's idiom: every
rank runs the same engine on the same requests and holds its slice of the
KV heads.  :func:`make_serving_mesh` joins (or initialises) the process
group of those ranks and returns a 1-D ``("model",)`` :class:`ServingMesh`;
:func:`make_test_mesh` is JAX's 2-D ``(data, model)`` layout for the
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

import os
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike, resolve_device

__all__ = ["Mesh", "ServingMesh", "make_serving_mesh", "make_test_mesh", "spawn_ranks"]


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes — all the partition rules read of a mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class ServingMesh(Mesh):
    """This process's place in a 1-D ``("model",)`` serving mesh of ``tp``
    ranks over the default process group (none when ``tp == 1``): its rank,
    its device and the group's backend."""

    def __init__(self, tp: int, rank: int, device: torch.device, backend: Optional[str]):
        super().__init__(("model",), (tp,))
        object.__setattr__(self, "tp", tp)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "backend", backend)

    def __repr__(self) -> str:
        return (f"ServingMesh(tp={self.tp}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


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


def make_serving_mesh(tp: int = 1, *, backend: Optional[str] = None,
                      device: DeviceLike = None) -> ServingMesh:
    """The 1-D ``("model",)`` serving mesh of ``tp`` ranks, for
    ``build_lm_serving(mesh=...)`` and ``launch.serve --tp``.

    ``tp`` must be 1 (no group) or the size of the process group: the group
    already initialised, else the one the environment describes, which is
    initialised here.  ``device`` is the rank's (``None`` means ``"cuda"``:
    one card a rank); ``backend`` defaults as the module docstring says."""
    world, rank, initialised = _world()
    if tp < 1 or tp > world:
        raise ValueError(f"tp={tp} needs 1..{world} devices")
    if 1 < tp < world:
        raise ValueError(f"tp={tp} on a group of {world} ranks: a serving mesh spans the "
                         f"whole group")
    dev, shared = _rank_device(device, tp)
    if tp == 1:
        return ServingMesh(1, 0, dev, None)
    if backend is not None:
        chosen, why = backend, "asked for"
    elif initialised:
        chosen, why = dist.get_backend(), "the initialised group's"
    elif dev.type == "cuda" and not shared:
        chosen, why = "nccl", "one card a rank"
    else:
        chosen, why = "gloo", "ranks share one card" if dev.type == "cuda" else "CPU"
    if chosen == "nccl" and (dev.type != "cuda" or shared):
        raise ValueError(f"backend nccl needs one card a rank; the {tp} ranks are on "
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
    mesh = ServingMesh(tp, rank, dev, chosen)
    print(f"[mesh] tp={tp} rank {rank}: device {dev}, backend {chosen} ({why})", flush=True)
    return mesh


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
    mesh with :func:`make_serving_mesh`.  Returns each rank's return value,
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
