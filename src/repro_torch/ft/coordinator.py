"""Cluster-membership simulation: heartbeats, failure detection, elastic
membership decisions — counterpart of :mod:`repro.ft.coordinator`, copied
whole (see :mod:`repro_torch.ft.watchdog` for why).

Hosts are simulated so the policy logic — who is alive, when to declare a
failure, what the new mesh should be after losing hosts — is
unit-testable.  The serving engine registers with a :class:`Coordinator`
and re-registers after every recovery, so a restart is a membership event.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["Coordinator", "plan_mesh_after_failure"]


@dataclass
class _Member:
    host_id: str
    last_beat: float
    alive: bool = True


class Coordinator:
    """Heartbeat registry with a failure deadline."""

    def __init__(self, deadline: float = 1.0):
        self.deadline = deadline
        self._members: Dict[str, _Member] = {}
        self._lock = threading.Lock()
        self.generation = 0          # bumps on every membership change

    def register(self, host_id: str) -> int:
        with self._lock:
            self._members[host_id] = _Member(host_id, time.monotonic())
            self.generation += 1
            return self.generation

    def heartbeat(self, host_id: str) -> None:
        with self._lock:
            m = self._members.get(host_id)
            if m is None:
                raise KeyError(f"unknown host {host_id}")
            m.last_beat = time.monotonic()

    def sweep(self) -> List[str]:
        """Mark members beyond the deadline dead; returns newly dead."""
        now = time.monotonic()
        dead = []
        with self._lock:
            for m in self._members.values():
                if m.alive and now - m.last_beat > self.deadline:
                    m.alive = False
                    dead.append(m.host_id)
            if dead:
                self.generation += 1
        return dead

    def alive(self) -> List[str]:
        with self._lock:
            return sorted(m.host_id for m in self._members.values() if m.alive)


def plan_mesh_after_failure(n_alive_chips: int, model_parallel: int = 16
                            ) -> Optional[Tuple[Tuple[int, int], Tuple[str, str]]]:
    """Largest (data, model) mesh that fits the survivors, keeping the TP
    degree fixed (params were sharded for it).  Returns None if fewer than
    one TP group survives."""
    if n_alive_chips < model_parallel:
        return None
    data = n_alive_chips // model_parallel
    return (data, model_parallel), ("data", "model")
