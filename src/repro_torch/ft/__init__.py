"""Fault tolerance of the port — counterpart of :mod:`repro.ft`: the
straggler watchdog and hang detector the self-healing serving engine arms
around every tick, and the membership coordinator it reports restarts to."""

from repro_torch.ft.coordinator import Coordinator, plan_mesh_after_failure
from repro_torch.ft.watchdog import HangDetector, StepWatchdog

__all__ = ["Coordinator", "plan_mesh_after_failure", "HangDetector",
           "StepWatchdog"]
