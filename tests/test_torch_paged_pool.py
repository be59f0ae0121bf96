"""The port's block pool held against repro.runtime.kv_cache: both pools are
driven through the same seeded random sequence of admit, append, release,
fork, truncate, take_copies and snapshot/restore, and after every step
their tables, stats, pending copy-on-write copies and free/evictable order
must be equal and both must pass check_integrity.  Also the scheduler's
block-gated admission."""

import numpy as np
import pytest

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.runtime import kv_cache as J
from repro_torch.runtime import kv_cache as T
from repro_torch.runtime.batching import SlotScheduler


def _state(pool):
    return {
        "tables": {sid: pool.block_table(sid) for sid in sorted(pool._seqs)},
        "tokens": {sid: list(pool.sequence(sid).tokens) for sid in sorted(pool._seqs)},
        "stats": pool.stats(),
        "pending": list(pool.pending_copies),
        "version": pool.version,
        "available": pool.available_blocks,
        "free": list(pool._free),
        "evictable": list(pool._evictable),
    }


def _can_truncate(pool, sid, n_keep):
    """Whether truncate(sid, n_keep) drops only private rows (the engine's
    speculative path never asks for anything else)."""
    seq, page = pool.sequence(sid), pool.page_size
    keep_blocks = -(-n_keep // page)
    if any(pool._blocks[b].ref != 1 for b in seq.table[keep_blocks:]):
        return False
    if keep_blocks:
        our_rows = min(page, seq.n_tokens - (keep_blocks - 1) * page)
        if our_rows > n_keep - (keep_blocks - 1) * page:
            return pool._blocks[seq.table[keep_blocks - 1]].ref == 1
    return True


def _drive(seed, n_blocks, page, steps):
    rng = np.random.default_rng(seed)
    jp, tp = J.BlockPool(n_blocks, page), T.BlockPool(n_blocks, page)
    stems = [list(rng.integers(0, 5, 3 * page)) for _ in range(3)]
    room = {}      # sid -> rows it may still append (its reservation)
    snap = None
    counts = {}
    cows = hits = 0
    for _ in range(steps):
        live = sorted(room)
        op = rng.choice(["admit", "append", "release", "fork", "truncate", "copies",
                         "snapshot", "restore"], p=[.25, .3, .12, .08, .1, .05, .05, .05])
        if op == "admit":
            stem = stems[int(rng.integers(len(stems)))]
            prompt = [int(t) for t in stem[:int(rng.integers(1, len(stem) + 1))]]
            prompt += [int(t) for t in rng.integers(0, 5, int(rng.integers(0, 3)))]
            new = int(rng.integers(1, 2 * page))
            got = jp.admit(prompt, new)
            assert tp.admit(prompt, new) == got
            if got is not None:
                room[got[0]] = len(prompt) + new - 1 - got[1]
        elif op == "append" and live:
            sid = live[int(rng.integers(len(live)))]
            n = int(rng.integers(0, room[sid] + 1))
            toks = [int(t) for t in rng.integers(0, 5, n)]
            jp.append(sid, toks)
            tp.append(sid, toks)
            room[sid] -= n
        elif op == "release" and live:
            sid = live[int(rng.integers(len(live)))]
            register = bool(rng.integers(2))
            jp.release(sid, register=register)
            tp.release(sid, register=register)
            del room[sid]
        elif op == "fork" and live:
            sid = live[int(rng.integers(len(live)))]
            new = int(rng.integers(1, page + 1))
            got = jp.fork(sid, new)
            assert tp.fork(sid, new) == got
            if got is not None:
                room[got] = new
        elif op == "truncate" and live:
            sid = live[int(rng.integers(len(live)))]
            n_tok = jp.sequence(sid).n_tokens
            n_keep = int(rng.integers(0, n_tok + 1))
            if _can_truncate(jp, sid, n_keep):
                jp.truncate(sid, n_keep)
                tp.truncate(sid, n_keep)
                room[sid] += n_tok - n_keep
        elif op == "copies":
            assert tp.take_copies() == jp.take_copies()
        elif op == "snapshot":
            snap = (jp.snapshot(), tp.snapshot(), dict(room))
        elif op == "restore" and snap is not None:
            jp.restore(snap[0])
            tp.restore(snap[1])
            room = dict(snap[2])
        else:
            continue
        counts[op] = counts.get(op, 0) + 1
        jp.check_integrity()
        tp.check_integrity()
        assert _state(tp) == _state(jp), op
        cows, hits = max(cows, jp.cow_count), max(hits, jp.hit_tokens)
    return counts, cows, hits


@pytest.mark.parametrize("seed,n_blocks,page", [(0, 24, 4), (1, 18, 3), (2, 40, 1),
                                                (3, 16, 8)])
def test_pool_matches_the_jax_pool_step_for_step(seed, n_blocks, page):
    counts, cows, hits = _drive(seed, n_blocks, page, steps=400)
    # every operation ran, and the run reached the interesting paths (a
    # one-row page is never written twice, so it never copies on write)
    assert set(counts) == {"admit", "append", "release", "fork", "truncate", "copies",
                           "snapshot", "restore"}, counts
    assert hits > 0 and (cows > 0 or page == 1)


def test_page_bytes_and_pages_needed_match():
    for args in [(2, 2, 8, 8), (32, 32, 96, 16), (1, 2, 16, 8)]:
        for dt in ("float32", "int8", "bfloat16"):
            assert T.kv_page_bytes(*args, dt) == J.kv_page_bytes(*args, dt)
    # the phi3-mini page of the serving smoke: 12.58 MB fp32, 3.154 MB int8
    assert T.kv_page_bytes(32, 32, 96, 16) == 12_582_912
    assert T.kv_page_bytes(32, 32, 96, 16, "int8") == 3_153_920
    for plen, new, page in [(1, 1, 8), (12, 6, 8), (583, 32, 16), (7, 2, 1)]:
        assert T.pages_needed(plen, new, page) == J.pages_needed(plen, new, page)
    with pytest.raises(ValueError):
        T.BlockPool(4, 4, kv_dtype="int4")


def test_gated_admission_stops_at_the_first_refusal():
    sched = SlotScheduler(4)
    reqs = [type("R", (), {"uid": i, "priority": 0})() for i in range(4)]
    for r in reqs:
        assert sched.submit(r)
    assert sched.peek() is reqs[0]
    seen = []

    def gate(r):
        seen.append(r.uid)
        return r.uid != 1

    assert [r.uid for _, r in sched.admit(gate)] == [0]
    assert seen == [0, 1]                      # uid 2 is never overtaking uid 1
    assert sched.peek() is reqs[1]
    assert [r.uid for _, r in sched.admit()] == [1, 2, 3]
    assert sched.peek() is None
    sched.check_conservation()
