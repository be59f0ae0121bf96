"""Paged KV cache: a refcounted block pool with prefix reuse — counterpart
of :mod:`repro.runtime.kv_cache`, copied whole so that the port never
imports the JAX package (importing ``repro.runtime.kv_cache`` runs
``repro/__init__.py``, which loads jax).  Every method and invariant is the
JAX package's; ``tests/test_torch_paged_pool.py`` drives both pools through
the same random operation sequence and asserts equal state after each step.

KV rows live in fixed-size **pages** drawn from one shared pool, each
sequence owns a **block table** mapping logical page -> physical block, and
pages holding identical token prefixes are **shared** between sequences via
a prefix index.  :class:`BlockPool` is pure bookkeeping; the device page
tensors and the compiled paged Programs live in
:class:`repro_torch.runtime.engine.PagedProgramStepper`, which consumes this
pool's block tables and applies its pending copy-on-write copies.

Invariants (``check_integrity`` asserts them):

* every block is in exactly one state — free, cached (refcount 0 but
  retained in the prefix index, evictable LRU), or live (refcount >= 1);
* a block's refcount equals the number of sequence block tables that
  contain it;
* reservations never exceed what the pool can provide, so an admitted
  sequence can always grow to its declared ``max_new_tokens`` without a
  mid-flight allocation failure;
* indexed blocks are frozen (immutable): any write that would land in a
  frozen or shared (refcount > 1) block first copies it (copy-on-write)
  into a private block, and the device-side page copy is queued in
  ``pending_copies`` for the stepper to apply before the next Program
  call.

Prefix sharing has two granularities:

* **full pages** — registered the moment a page fills; keyed by the
  token ids of the sequence from position 0 through the end of that page
  (content-addressed, so it is correct for generated tokens too);
* **partial tail pages** — registered when a sequence finishes; a new
  prompt that matches `m < page_size` leading rows of a cached tail
  shares the block read-only, and its first append into that page
  triggers the copy-on-write divergence path.

Reuse is capped at ``len(prompt) - 1`` tokens so at least one prompt
position is always prefilled — the first output token comes from that
position's logits.

:meth:`BlockPool.truncate` rolls back a speculative tick's rejected rows.
:meth:`BlockPool.snapshot` / :meth:`BlockPool.restore` are the self-healing
engine's resume substrate: it snapshots the pool at the start of every
guarded tick and restores it when the tick fails, so a requeued request
resumes from the pages it kept (``Engine(self_heal=True)``).
:meth:`BlockPool.fork` comes along unchanged.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["BlockPool", "SeqState", "pages_needed", "kv_page_bytes"]

# bytes per element of the supported KV storage dtypes (kept as a plain
# table so this module stays numpy-free)
_KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
# per-row scale-sidecar bytes: int8 pages carry one float32 scale per
# (page, kv head) for K and V each -> 2 * 4 bytes per kv head per page
_SCALE_BYTES = 4


def kv_page_bytes(n_layers: int, n_kv_heads: int, d_head: int,
                  page_size: int, kv_dtype: str = "float32") -> int:
    """Device bytes one pool page occupies across all layers, K and V,
    including the float32 scale sidecars for quantized dtypes.  This is
    the number honest equal-memory comparisons must use: an int8 pool
    with the same *page count* as an fp32 pool is ~4x smaller, not equal.
    """
    if kv_dtype not in _KV_ITEMSIZE:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}; "
                         f"known: {sorted(_KV_ITEMSIZE)}")
    per_kv = n_layers * 2 * page_size * n_kv_heads * d_head
    total = per_kv * _KV_ITEMSIZE[kv_dtype]
    if kv_dtype == "int8":
        total += n_layers * 2 * n_kv_heads * _SCALE_BYTES
    return total


def pages_needed(prompt_len: int, max_new_tokens: int, page_size: int) -> int:
    """Worst-case pages a request can ever occupy.  The cache stores
    ``prompt_len + max_new_tokens - 1`` rows at most: the last generated
    token is emitted but never written back (there is no step after it)."""
    rows = max(prompt_len + max_new_tokens - 1, 1)
    return -(-rows // page_size)


@dataclass
class _Block:
    bid: int
    ref: int = 0
    frozen: bool = False                  # indexed => immutable
    tokens: List[int] = field(default_factory=list)   # rows written so far
    index_key: Optional[Tuple[Any, ...]] = None


@dataclass
class SeqState:
    """One live sequence's view of the pool (block table + bookkeeping)."""

    sid: int
    table: List[int] = field(default_factory=list)    # logical page -> bid
    tokens: List[int] = field(default_factory=list)   # all rows, in order
    n_tokens: int = 0                                 # == len(tokens)
    reserved: int = 0                                 # blocks still owed to us


class BlockPool:
    """Fixed-size page pool with refcounting, prefix index, CoW and LRU
    reclamation of cached (refcount-0 but indexed) blocks.

    The pool tracks *block ids*, never tensor data.  The CoW copies it
    schedules (``pending_copies``) index axis 0 of every device cache
    tensor — page pools and int8 scale sidecars alike."""

    def __init__(self, n_blocks: int, page_size: int, *,
                 kv_dtype: str = "float32",
                 page_bytes: Optional[int] = None):
        if n_blocks < 1 or page_size < 1:
            raise ValueError("need n_blocks >= 1 and page_size >= 1")
        if kv_dtype not in _KV_ITEMSIZE:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}; "
                             f"known: {sorted(_KV_ITEMSIZE)}")
        self.n_blocks = n_blocks
        self.page_size = page_size
        # storage dtype of the device page arrays this pool describes,
        # and the per-page device footprint (scale sidecars included) —
        # pure metadata here, but it makes ``stats()`` report bytes so
        # equal-memory comparisons across kv dtypes stay honest
        self.kv_dtype = kv_dtype
        self.page_bytes = page_bytes
        self._blocks = [_Block(i) for i in range(n_blocks)]
        self._free: deque = deque(range(n_blocks))
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self._full: Dict[Tuple[int, ...], int] = {}
        self._partial: Dict[Tuple[int, ...], Dict[int, Tuple[int, ...]]] = {}
        self._seqs: Dict[int, SeqState] = {}
        self._next_sid = 0
        self._reserved_total = 0
        self.pending_copies: List[Tuple[int, int]] = []   # (src bid, dst bid)
        # bumped whenever availability may have GROWN (a block reached
        # refcount 0, or a reservation was returned) — lets callers skip
        # re-running an admission lookup that cannot succeed until then
        self.version = 0
        # stats
        self.n_admitted = 0
        self.n_admit_deferred = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.cow_count = 0
        self.evictions = 0

    # ------------------------------------------------------------------ #
    # capacity
    # ------------------------------------------------------------------ #
    @property
    def available_blocks(self) -> int:
        """Blocks an admission may claim right now: free + evictable
        cache, minus blocks already promised to live sequences."""
        return len(self._free) + len(self._evictable) - self._reserved_total

    def fits_ever(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Could this request run on an otherwise empty pool?"""
        return pages_needed(prompt_len, max_new_tokens,
                            self.page_size) <= self.n_blocks

    # ------------------------------------------------------------------ #
    # prefix lookup
    # ------------------------------------------------------------------ #
    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], Optional[int], int]:
        """Longest cached prefix of ``prompt``: full-page block chain, an
        optional partial tail block, and the reusable token count (capped
        at ``len(prompt) - 1``)."""
        page = self.page_size
        limit = len(prompt) - 1
        blocks: List[int] = []
        k = 0
        while (k + 1) * page <= limit:
            bid = self._full.get(tuple(prompt[:(k + 1) * page]))
            if bid is None:
                break
            blocks.append(bid)
            k += 1
        tail = tuple(prompt[k * page:limit])
        best_bid, best_m = None, 0
        for bid, rows in self._partial.get(tuple(prompt[:k * page]), {}).items():
            m = 0
            for a, b in zip(rows, tail):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best_bid, best_m = bid, m
        return blocks, best_bid, k * page + best_m

    # ------------------------------------------------------------------ #
    # sequence lifecycle
    # ------------------------------------------------------------------ #
    def admit(self, prompt: Sequence[int],
              max_new_tokens: int) -> Optional[Tuple[int, int]]:
        """Admit a request: claim its cached prefix and reserve every
        block it could still need.  Returns ``(sid, reused_tokens)``, or
        ``None`` when the pool cannot currently cover the worst case (the
        caller should leave the request queued)."""
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        blocks, tail_bid, reused = self.lookup(prompt)
        total = pages_needed(len(prompt), max_new_tokens, self.page_size)
        # pages k..total-1 each cost one allocation over the sequence's
        # lifetime; a shared partial tail is replaced (CoW) on first write,
        # so it is already counted in ``total - len(blocks)``
        need = total - len(blocks)
        table = list(blocks)
        if tail_bid is not None and reused > len(blocks) * self.page_size:
            table.append(tail_bid)
        # claiming a cached (refcount-0) prefix block removes it from the
        # reclaimable set, so it costs availability just like an allocation
        claimed = sum(1 for bid in table if self._blocks[bid].ref == 0)
        if need + claimed > self.available_blocks:
            self.n_admit_deferred += 1
            return None
        self.n_admitted += 1
        self.lookup_tokens += len(prompt)
        self.hit_tokens += reused
        sid = self._next_sid
        self._next_sid += 1
        for bid in table:
            self._incref(bid)
        self._seqs[sid] = SeqState(sid=sid, table=table,
                                    tokens=list(prompt[:reused]),
                                    n_tokens=reused, reserved=need)
        self._reserved_total += need
        return sid, reused

    def append(self, sid: int, tokens: Sequence[int]) -> None:
        """Record ``tokens`` written at the sequence's next positions.
        Allocates pages as they are entered and performs copy-on-write
        when a write would land in a frozen or shared block (the device
        copy is queued in ``pending_copies``)."""
        seq = self._seqs[sid]
        page = self.page_size
        for t in tokens:
            pi, row = divmod(seq.n_tokens, page)
            if pi == len(seq.table):
                seq.table.append(self._alloc(seq))
            bid = seq.table[pi]
            blk = self._blocks[bid]
            if blk.frozen or blk.ref > 1:
                nb = self._alloc(seq)
                self._blocks[nb].tokens = list(blk.tokens[:row])
                self.pending_copies.append((bid, nb))
                self.cow_count += 1
                self._decref(bid)
                seq.table[pi] = nb
                bid, blk = nb, self._blocks[nb]
            assert len(blk.tokens) == row, "non-append write to a page"
            blk.tokens.append(int(t))
            seq.tokens.append(int(t))
            seq.n_tokens += 1
            if len(blk.tokens) == page:
                self._register_full(seq, pi, bid)

    def truncate(self, sid: int, n_keep: int) -> None:
        """Roll a sequence back to its first ``n_keep`` rows — the
        speculative-decoding reject path.  A verify step appends the
        committed next token plus K draft proposals in one write; after
        acceptance the rejected tail rows must vanish from the
        bookkeeping (their device rows become garbage past the
        sequence's length, which attention masking already ignores —
        the same append-only-page argument :meth:`snapshot` relies on).

        Only rows the sequence itself appended can be dropped: every row
        past ``n_keep`` was written after admission (a frozen or shared
        page would have been copied-on-write first), so dropped blocks
        are private (``ref == 1``).  A block the speculative write
        filled — and therefore registered in the prefix index — is
        de-indexed before it is dropped or trimmed: its content encodes
        rejected tokens and must not be donated.  Whole dropped blocks
        return to the free list and their allocation is re-credited to
        the sequence's reservation (it may regrow to the same worst
        case it was admitted for)."""
        seq = self._seqs[sid]
        if not 0 <= n_keep <= seq.n_tokens:
            raise ValueError(f"truncate to {n_keep} outside "
                             f"[0, {seq.n_tokens}]")
        if n_keep == seq.n_tokens:
            return
        page = self.page_size
        n_before = seq.n_tokens
        keep_blocks = -(-n_keep // page)
        for bid in seq.table[keep_blocks:]:
            blk = self._blocks[bid]
            assert blk.ref == 1, \
                f"truncate dropping shared block {bid} (ref {blk.ref})"
            if blk.index_key is not None:
                self._drop_index(bid)
            self._decref(bid)
            seq.reserved += 1
            self._reserved_total += 1
        del seq.table[keep_blocks:]
        if keep_blocks:
            bid = seq.table[-1]
            blk = self._blocks[bid]
            row_keep = n_keep - (keep_blocks - 1) * page
            # rows of OURS in the tail block; blk.tokens may hold more
            # (a shared donor tail we only reused a prefix of) — those
            # are not ours to trim, and none of our rows live past them
            our_rows = min(page, n_before - (keep_blocks - 1) * page)
            if our_rows > row_keep:
                assert blk.ref == 1, \
                    f"truncate trimming shared block {bid} (ref {blk.ref})"
                if blk.index_key is not None:
                    self._drop_index(bid)
                del blk.tokens[row_keep:]
        del seq.tokens[n_keep:]
        seq.n_tokens = n_keep

    def fork(self, sid: int, max_new_tokens: int) -> Optional[int]:
        """Clone a sequence sharing every block (beam/speculative-style
        divergence): both copies keep reading the shared pages; the first
        write into the shared tail triggers copy-on-write.  Reserves the
        clone's worst-case growth; returns ``None`` when it cannot."""
        seq = self._seqs[sid]
        total = pages_needed(seq.n_tokens, max_new_tokens + 1, self.page_size)
        # worst case for the clone: every page beyond the current table,
        # plus a CoW replacement of the (now shared) tail page.  The PARENT
        # also gains a potential CoW (its next write hits a ref-2 block),
        # so it is granted one extra reserved block too.
        tail_cow = 1 if (seq.table and
                         len(self._blocks[seq.table[-1]].tokens)
                         < self.page_size) else 0
        need = max(total - len(seq.table), 0) + tail_cow
        if need + tail_cow > self.available_blocks:
            return None
        nsid = self._next_sid
        self._next_sid += 1
        for bid in seq.table:
            self._incref(bid)
        self._seqs[nsid] = SeqState(sid=nsid, table=list(seq.table),
                                     tokens=list(seq.tokens),
                                     n_tokens=seq.n_tokens, reserved=need)
        seq.reserved += tail_cow
        self._reserved_total += need + tail_cow
        return nsid

    def release(self, sid: int, *, register: bool = True) -> None:
        """Finish (``register=True``) or drop a sequence.  Finishing
        registers the partial tail page in the prefix index so future
        prompts can share it; every block is decref'd and refcount-0
        blocks return to the free list (unindexed) or the evictable LRU
        (indexed)."""
        seq = self._seqs.pop(sid)
        if register and seq.table:
            bid = seq.table[-1]
            blk = self._blocks[bid]
            if (0 < len(blk.tokens) < self.page_size and not blk.frozen
                    and blk.ref == 1 and blk.index_key is None):
                chain = tuple(seq.tokens[:(len(seq.table) - 1) * self.page_size])
                self._partial.setdefault(chain, {})[bid] = tuple(blk.tokens)
                blk.frozen = True
                blk.index_key = ("partial", chain)
        for bid in seq.table:
            self._decref(bid)
        self._reserved_total -= seq.reserved
        if seq.reserved:
            self.version += 1

    def block_table(self, sid: int) -> List[int]:
        return list(self._seqs[sid].table)

    def sequence(self, sid: int) -> SeqState:
        return self._seqs[sid]

    def take_copies(self) -> List[Tuple[int, int]]:
        """Drain the queued CoW (src, dst) page copies — the stepper must
        apply them to the device page arrays before its next Program call."""
        out, self.pending_copies = self.pending_copies, []
        return out

    # ------------------------------------------------------------------ #
    # snapshot / restore (engine self-healing)
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Any]:
        """Full pure-python copy of the pool's bookkeeping state.

        The self-healing engine captures one at the start of every guarded
        tick: a tick that crashes or hangs mid-flight may have recorded
        appends (and registered full pages in the prefix index) whose
        device writes never happened — :meth:`restore` rolls the pool back
        to the pre-tick state so bookkeeping matches the device arrays
        again.  Blocks are append-only and frozen blocks are never
        rewritten, so every row the restored state considers written is
        still bit-valid on device; rows written by the failed tick become
        garbage past each sequence's length, which the attention masking
        already ignores."""
        return {
            "blocks": [(b.ref, b.frozen, list(b.tokens), b.index_key)
                       for b in self._blocks],
            "free": list(self._free),
            "evictable": list(self._evictable),
            "full": dict(self._full),
            "partial": {k: dict(v) for k, v in self._partial.items()},
            "seqs": {sid: (list(s.table), list(s.tokens), s.reserved)
                     for sid, s in self._seqs.items()},
            "next_sid": self._next_sid,
            "reserved_total": self._reserved_total,
            "pending_copies": list(self.pending_copies),
            "version": self.version,
            "counters": (self.n_admitted, self.n_admit_deferred,
                         self.hit_tokens, self.lookup_tokens,
                         self.cow_count, self.evictions),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        """Restore state captured by :meth:`snapshot` (in place, so
        steppers holding a reference keep it).  Deep-copies out of the
        snapshot — the same snapshot can be restored repeatedly (a
        recovered engine may crash again).  Ends with
        :meth:`check_integrity`: a restore that does not satisfy every
        pool invariant is an error, not a latent corruption."""
        if len(snap["blocks"]) != self.n_blocks:
            raise ValueError(f"snapshot has {len(snap['blocks'])} blocks, "
                             f"pool has {self.n_blocks}")
        for blk, (ref, frozen, tokens, key) in zip(self._blocks,
                                                   snap["blocks"]):
            blk.ref, blk.frozen = ref, frozen
            blk.tokens = list(tokens)
            blk.index_key = key
        self._free = deque(snap["free"])
        self._evictable = OrderedDict((bid, None)
                                      for bid in snap["evictable"])
        self._full = dict(snap["full"])
        self._partial = {k: dict(v) for k, v in snap["partial"].items()}
        self._seqs = {
            sid: SeqState(sid=sid, table=list(table), tokens=list(tokens),
                          n_tokens=len(tokens), reserved=reserved)
            for sid, (table, tokens, reserved) in snap["seqs"].items()}
        self._next_sid = snap["next_sid"]
        self._reserved_total = snap["reserved_total"]
        self.pending_copies = list(snap["pending_copies"])
        self.version = snap["version"]
        (self.n_admitted, self.n_admit_deferred, self.hit_tokens,
         self.lookup_tokens, self.cow_count, self.evictions) = snap["counters"]
        self.check_integrity()

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _register_full(self, seq: SeqState, pi: int, bid: int) -> None:
        key = tuple(seq.tokens[:(pi + 1) * self.page_size])
        blk = self._blocks[bid]
        if key in self._full or blk.index_key is not None:
            return          # identical content already cached; keep private
        self._full[key] = bid
        blk.frozen = True
        blk.index_key = ("full", key)

    def _incref(self, bid: int) -> None:
        blk = self._blocks[bid]
        blk.ref += 1
        if blk.ref == 1:
            self._evictable.pop(bid, None)

    def _decref(self, bid: int) -> None:
        blk = self._blocks[bid]
        assert blk.ref > 0, f"double free of block {bid}"
        blk.ref -= 1
        if blk.ref == 0:
            if blk.index_key is not None:
                self._evictable[bid] = None
                self._evictable.move_to_end(bid)
            else:
                self._free.append(bid)
            self.version += 1

    def _alloc(self, seq: SeqState) -> int:
        assert seq.reserved > 0, (
            f"sequence {seq.sid} grew past its reservation")
        seq.reserved -= 1
        self._reserved_total -= 1
        if self._free:
            bid = self._free.popleft()
        else:
            bid = self._evict()
        blk = self._blocks[bid]
        assert blk.ref == 0 and blk.index_key is None
        blk.ref = 1
        blk.frozen = False
        blk.tokens = []
        return bid

    def _evict(self) -> int:
        bid, _ = self._evictable.popitem(last=False)     # LRU
        self._drop_index(bid)
        self.evictions += 1
        return bid

    def _drop_index(self, bid: int) -> None:
        blk = self._blocks[bid]
        kind, key = blk.index_key[0], blk.index_key[1]
        if kind == "full":
            if self._full.get(key) == bid:
                del self._full[key]
        else:
            group = self._partial.get(key, {})
            group.pop(bid, None)
            if not group:
                self._partial.pop(key, None)
        blk.index_key = None
        blk.frozen = False

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def live_sequences(self) -> int:
        return len(self._seqs)

    def stats(self) -> Dict[str, Any]:
        """Pool health: occupancy, internal fragmentation (allocated rows
        never written, over live blocks), prefix hit rate, CoW and
        eviction counters."""
        live = [b for b in self._blocks if b.ref > 0]
        used_rows = sum(len(b.tokens) for b in live)
        cap_rows = len(live) * self.page_size
        pb = self.page_bytes
        return {
            "n_blocks": self.n_blocks,
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "page_bytes": pb,
            "pool_bytes": None if pb is None else pb * self.n_blocks,
            "live_bytes": None if pb is None else pb * len(live),
            "free_blocks": len(self._free),
            "cached_blocks": len(self._evictable),
            "live_blocks": len(live),
            "reserved_blocks": self._reserved_total,
            "indexed_full_pages": len(self._full),
            "indexed_partial_pages": sum(len(g) for g in self._partial.values()),
            "fragmentation": 1.0 - used_rows / cap_rows if cap_rows else 0.0,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": (self.hit_tokens / self.lookup_tokens
                         if self.lookup_tokens else 0.0),
            "n_admitted": self.n_admitted,
            "n_admit_deferred": self.n_admit_deferred,
            "cow_count": self.cow_count,
            "evictions": self.evictions,
        }

    def check_integrity(self) -> None:
        """Assert the conservation invariants (see module docstring)."""
        free = list(self._free)
        assert len(free) == len(set(free)), "duplicate block in free list"
        refs = {i: 0 for i in range(self.n_blocks)}
        for seq in self._seqs.values():
            assert seq.n_tokens == len(seq.tokens)
            assert len(seq.table) == len(set(seq.table)), \
                "block repeated within one table"
            for bid in seq.table:
                refs[bid] += 1
        for blk in self._blocks:
            assert blk.ref == refs[blk.bid], (
                f"block {blk.bid}: ref {blk.ref} != {refs[blk.bid]} tables")
            states = [blk.bid in set(free), blk.bid in self._evictable,
                      blk.ref > 0]
            assert sum(states) == 1, f"block {blk.bid} in states {states}"
            if blk.bid in self._evictable:
                assert blk.index_key is not None, \
                    f"cached block {blk.bid} not indexed"
            if blk.index_key is not None:
                assert blk.frozen, f"indexed block {blk.bid} not frozen"
        assert self._reserved_total == sum(s.reserved
                                           for s in self._seqs.values())
        assert self._reserved_total <= len(free) + len(self._evictable), \
            "reservations exceed reclaimable blocks"
        for key, bid in self._full.items():
            assert self._blocks[bid].index_key == ("full", key)
        for chain, group in self._partial.items():
            for bid, rows in group.items():
                assert self._blocks[bid].index_key == ("partial", chain)
                assert tuple(self._blocks[bid].tokens) == rows
