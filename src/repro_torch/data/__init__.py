"""Data pipeline of the port — counterpart of :mod:`repro.data`:
deterministic synthetic stream, packing, prefetch."""

from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM, pack_documents

__all__ = ["PrefetchLoader", "SyntheticLM", "pack_documents"]
