"""Deterministic synthetic token pipeline — a copy of
:mod:`repro.data.synthetic` (numpy only), so the port's batches are the
JAX package's bit for bit.

Tokens are a pure function of (seed, step, index) via a counter-based
philox-style mix — any host can materialise exactly its shard of any step
without coordination (the property real multi-host input pipelines need:
restart-stable, shardable, no state files).  The "documents" have a
repeating-ngram structure so a real model can actually reduce loss on them
(used by examples/train_lm.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLM", "pack_documents"]


def _mix(x: np.ndarray) -> np.ndarray:
    """64-bit splitmix-style mixer, vectorised."""
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


@dataclass
class SyntheticLM:
    """Batched LM stream: batch["tokens"] (B,S) int32, batch["labels"] (B,S)
    = next-token targets."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    ngram: int = 8           # structure scale: tokens repeat with period
                             # `ngram` within a doc -> learnable signal
    n_docs: int = 0          # 0: fresh docs every step (generalisation /
                             # induction task); >0: cycle a fixed doc pool
                             # (memorisable -> loss falls within ~100 steps)

    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        assert self.batch % num_shards == 0
        b_loc = self.batch // num_shards
        rows = np.arange(b_loc, dtype=np.uint64) + shard * b_loc
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)
        base = np.uint64(self.seed) << np.uint64(40)
        # document ids: unique per (step, row), or cycled through a fixed pool
        ids = np.uint64(step) * np.uint64(self.batch) + rows
        if self.n_docs:
            ids = ids % np.uint64(self.n_docs)
        doc = _mix(base ^ _mix(ids * np.uint64(2654435761) + np.uint64(1)))
        # position folded modulo ngram: the sequence repeats with period
        # `ngram` within a doc (learnable copy structure)
        pos = cols % np.uint64(self.ngram)
        grid = _mix(doc[:, None] ^ _mix(pos[None, :] + np.uint64(17)))
        toks = (grid % np.uint64(self.vocab)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pack_documents(docs, seq_len: int, pad_id: int = 0,
                   eos_id: int = 1) -> np.ndarray:
    """Greedy sequence packing: concatenate docs separated by EOS, emit
    fixed-length rows. Returns (n_rows, seq_len) int32."""
    buf: list = []
    rows = []
    for d in docs:
        buf.extend(int(t) for t in d)
        buf.append(eos_id)
        while len(buf) >= seq_len:
            rows.append(buf[:seq_len])
            buf = buf[seq_len:]
    if buf:
        rows.append(buf + [pad_id] * (seq_len - len(buf)))
    return np.asarray(rows, dtype=np.int32)
