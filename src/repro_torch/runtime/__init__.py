"""Serving runtime of the port: slot scheduling and the continuous batcher
over layer-stack models (:mod:`.batching`), and the Program-backed
dense and paged engine (:mod:`.engine`)."""
