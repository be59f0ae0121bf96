"""Runtime of the port: slot scheduling and the continuous batcher
over layer-stack models (:mod:`.batching`), the Program-backed dense and
paged engine with self-healing, tier-aware overload control and its
asyncio front end (:mod:`.engine`), the trace-driven load harness
(:mod:`.loadgen`), the train step on one device or a process mesh
(:mod:`.train`) and the pipeline schedule over "pod" (:mod:`.pipeline`)."""

from repro_torch.runtime.batching import ContinuousBatcher, Request, SlotScheduler
from repro_torch.runtime.engine import (AsyncEngine, CheckpointSlot, Engine, EngineCheckpoint,
                                        EngineMetrics, EngineRequest, PagedProgramStepper,
                                        ProgramStepper, TickFailure, UnbatchedReference,
                                        build_lm_serving)
from repro_torch.runtime.kv_cache import BlockPool
from repro_torch.runtime.loadgen import (SLO, PrefixPopulation, TierSpec, Trace, TraceConfig,
                                         TraceRequest, generate_trace, run_load)
from repro_torch.runtime.pipeline import pipeline_apply
from repro_torch.runtime.train import make_train_step, train_state_shardings, value_and_grad

__all__ = ["ContinuousBatcher", "Request", "SlotScheduler",
           "AsyncEngine", "Engine", "EngineMetrics", "EngineRequest",
           "ProgramStepper", "PagedProgramStepper", "UnbatchedReference",
           "BlockPool", "build_lm_serving",
           "EngineCheckpoint", "CheckpointSlot", "TickFailure",
           "SLO", "TierSpec", "PrefixPopulation", "Trace", "TraceConfig",
           "TraceRequest", "generate_trace", "run_load", "make_train_step",
           "train_state_shardings", "value_and_grad", "pipeline_apply"]
