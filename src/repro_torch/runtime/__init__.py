"""Serving runtime of the port: slot scheduling and the continuous batcher
over layer-stack models (:mod:`.batching`), the Program-backed dense and
paged engine with self-healing and tier-aware overload control
(:mod:`.engine`), and the trace-driven load harness (:mod:`.loadgen`)."""
