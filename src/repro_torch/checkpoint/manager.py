"""Checkpoint manager: async saves, rotation, auto-resume, preemption hook
— counterpart of :mod:`repro.checkpoint.manager`.

The training driver calls ``maybe_save(step, state)`` every step; the
device-to-host copy happens on the caller (so the step that follows may
update the tensors in place) and the file write on a background thread.
``keep`` bounds disk usage; ``save_on_signal`` installs a SIGTERM handler
that checkpoints before exit (code 143).
"""

from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import io
from repro_torch.core.device import DeviceLike
from repro_torch.core.tree import tree_map

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, ckpt_dir: str, *, interval: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._last_saved = -1
        os.makedirs(ckpt_dir, exist_ok=True)

    # ------------------------------------------------------------------ #
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self) -> None:
        steps = io.list_steps(self.dir)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def save(self, step: int, state: Any, metadata: Optional[Dict[str, Any]] = None, *,
             specs: Any = None, mesh: Any = None) -> None:
        """Blocking device->host copy; file write possibly async.  With
        ``specs`` and ``mesh`` ``state`` is this rank's slices and every rank
        calls it: the whole leaves are gathered to rank 0, which writes them
        before every rank passes a barrier (no write thread)."""
        self.wait()
        if mesh is not None:
            io.save(self.dir, step, state, metadata, specs=specs, mesh=mesh)
            if mesh.rank == 0:
                self._rotate()
            self._last_saved = step
            return
        host_state = tree_map(io.to_host, state)

        def work():
            io.save(self.dir, step, host_state, metadata)
            self._rotate()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
        self._last_saved = step

    def maybe_save(self, step: int, state: Any,
                   metadata: Optional[Dict[str, Any]] = None) -> bool:
        if step % self.interval == 0 and step != self._last_saved:
            self.save(step, state, metadata)
            return True
        return False

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        steps = io.list_steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, target: Any, device: DeviceLike = None,
                step: Optional[int] = None, *, specs: Any = None, mesh: Any = None) -> Any:
        return io.restore(self.dir, target, step=step, device=device, specs=specs, mesh=mesh)

    # ------------------------------------------------------------------ #
    def save_on_signal(self, get_state: Callable[[], tuple],
                       signals=(signal.SIGTERM,)) -> None:
        """Install handlers that checkpoint (step, state) and exit —
        preemption-safe training."""
        def handler(signum, frame):
            step, state = get_state()
            self.save(step, state, {"preempted": True})
            self.wait()
            raise SystemExit(143)

        for s in signals:
            signal.signal(s, handler)
