"""Serving runtime of the port: slot scheduling (:mod:`.batching`) and the
Program-backed dense-cache engine (:mod:`.engine`)."""
