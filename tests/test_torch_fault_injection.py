"""Fault injection against the port's self-healing engine on the CPU —
tests/test_fault_injection.py (but its tp2 case, ROADMAP item 12) and the
spec crash and hang tests of tests/test_speculative.py on the port's own
variant matrix (dense, paged fp32, paged int8, spec), each also against the
JAX package's engine on the same numpy weights with the same faults:

* no request lost, no token duplicated or skipped (the streaming callback
  sees exactly ``out_tokens``), tokens equal to the uninterrupted run's and
  to JAX's recovered engine's;
* ``failed_ticks``, ``recovered_rows``, ``prefill_ticks`` and every
  request's ``n_requeues`` equal JAX's: the resume schedule is JAX's,
  a decoding request's resumed token going through one prefill tick;
* the pool passes ``check_integrity`` and leaks nothing;
* ``relocate_slots`` relocates a swapped pair and a chain, and a dense
  resume relocates rows between slots;
* a hang on a kv8 prefill or decode tick (its writes already landed)
  leaves the tokens equal to the uninterrupted kv8 run's.

The speculative-phase tests live in tests/test_torch_spec_recovery.py (one
file would take over a minute: the JAX package compiles every spec
engine anew).

Hangs run on a fake clock (the port's ``ft.watchdog`` clock monkeypatched:
an injected hang advances it past the deadline), so no count depends on
wall time; one test lets a real sleep overrun a real deadline."""

import time

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.ft import watchdog as jwd
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro_torch.ft.coordinator import Coordinator
from repro_torch.models.graph_lm import GraphLMConfig
from repro_torch.runtime.engine import (Engine, EngineRequest, TickFailure,
                                        build_lm_serving)

# tests/conftest.py's TINY_LM and ENGINE_VARIANTS (but tp2), kept here: the
# port does not use the JAX package's test helpers
TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
TINY = GraphLMConfig(**TINY_ARGS)
VARIANTS = {"dense": {}, "paged-fp32": {"paged": True, "page_size": 8},
            "paged-int8": {"paged": True, "page_size": 8, "kv_dtype": "int8"},
            "spec": {"spec_k": 3}}
N_REQS, MAX_NEW = 6, 6
HANG_TIMEOUT = 10.0        # fake-clock seconds; an injected hang adds 11
ALL_PHASES = ("decode", "prefill", "draft_prefill", "draft", "verify")


def make_engine(variant, *, jax=False, **overrides):
    """tests/conftest.py's make_engine: the port's engine on the CPU, or
    (``jax=True``) the JAX package's with the same weights."""
    kw = {"n_slots": 3, "chunk": 4, "cache_cap": 48, **VARIANTS[variant], **overrides}
    if jax:
        return jeng.build_lm_serving(jlm.GraphLMConfig(**TINY_ARGS), **kw)
    return build_lm_serving(TINY, device="cpu", **kw)


def _prompts():
    rng = np.random.default_rng(42)
    head = rng.integers(0, TINY.vocab, size=6).astype(np.int32)
    out = []
    for i in range(N_REQS):
        tail = rng.integers(0, TINY.vocab, size=int(rng.integers(2, 9))).astype(np.int32)
        out.append(np.concatenate([head, tail]) if i % 2 else tail)
    return out


PROMPTS = _prompts()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _FakeClock()
    monkeypatch.setattr("repro_torch.ft.watchdog.time.perf_counter", c)
    assert jwd.time.perf_counter is c      # one `time` module: JAX's sees it too
    return c


def _submit_all(engine, cls=EngineRequest, prompts=PROMPTS):
    reqs, streams = [], []
    for i, p in enumerate(prompts):
        toks = []
        req = cls(uid=i, prompt=p, max_new_tokens=MAX_NEW,
                  on_token=lambda r, t, toks=toks: toks.append(t))
        assert engine.submit(req)
        reqs.append(req)
        streams.append(toks)
    return reqs, streams


def _inject(stepper, at, phases=None, *, clock=None):
    """Wrap the stepper's step functions: the Nth call (counting across
    every wrapped phase) raises for N in ``at`` — or, given ``clock``,
    completes and then advances the fake clock past the hang deadline."""
    calls = [0]
    for phase in phases or [p for p in ALL_PHASES if hasattr(stepper, p)]:
        orig = getattr(stepper, phase)

        def wrapped(*args, _orig=orig):
            calls[0] += 1
            if calls[0] in at and clock is None:
                raise RuntimeError(f"injected fault at call {calls[0]}")
            out = _orig(*args)
            if calls[0] in at:
                clock.t += HANG_TIMEOUT + 1.0
            return out

        setattr(stepper, phase, wrapped)
    return calls


def _random_fail_calls(seed, n=3, lo=2, hi=16):
    rng = np.random.default_rng(seed)
    return set(int(c) for c in rng.choice(np.arange(lo, hi), size=n, replace=False))


_ORACLES = {}


def _oracle(variant):
    """One uninterrupted port run per variant; the fp32 variants are also
    pinned to the unbatched reference."""
    if variant not in _ORACLES:
        engine, ref = make_engine(variant)
        reqs, streams = _submit_all(engine)
        engine.run()
        for r, toks in zip(reqs, streams):
            assert r.done and toks == r.out_tokens
            if "int8" not in variant:
                assert r.out_tokens == ref.generate(r.prompt, MAX_NEW, chunk=4)
        _ORACLES[variant] = {r.uid: list(r.out_tokens) for r in reqs}
    return _ORACLES[variant]


def _check_identical(reqs, streams, outputs):
    for r, toks in zip(reqs, streams):
        assert r.done, (r.uid, r.dropped)
        assert r.out_tokens == outputs[r.uid], (r.uid, r.out_tokens, outputs[r.uid])
        assert toks == r.out_tokens, (r.uid, toks, r.out_tokens)


def _check_pool_clean(engine):
    if not engine.paged:
        return
    engine.stepper.pool.check_integrity()
    assert engine.stepper.pool.live_sequences == 0
    assert engine.stepper.pool.stats()["reserved_blocks"] == 0


def _record(engine, reqs):
    """What must equal JAX's after the same faults."""
    m = engine.metrics
    return ([list(r.out_tokens) for r in reqs], [r.n_requeues for r in reqs],
            {k: getattr(m, k) for k in ("failed_ticks", "n_crash_failures",
                                        "n_hang_failures", "n_recoveries",
                                        "requeued_requests", "recovered_rows",
                                        "prefill_ticks", "decode_ticks", "spec_ticks",
                                        "n_finished", "ticks")})


def _faulted_pair(variant, at, phases=None, clock=None, **kw):
    """The port's and JAX's engines, self-healing, the same faults injected
    into both; returns the port's (engine, reqs, streams) and both records."""
    if clock is not None:
        kw["hang_timeout"] = HANG_TIMEOUT
    out = []
    for jax in (False, True):
        engine, _ = make_engine(variant, jax=jax, self_heal=True, **kw)
        reqs, streams = _submit_all(engine, jeng.EngineRequest if jax else EngineRequest)
        _inject(engine.stepper, at, phases, clock=clock)
        engine.run(max_ticks=engine.tick + 4000)
        out.append((engine, reqs, streams, _record(engine, reqs)))
    (engine, reqs, streams, rec), (_, _, _, jrec) = out
    assert rec == jrec
    return engine, reqs, streams


# --------------------------------------------------------------------------- #
# the matrix: crash + hang recovery on every in-process variant
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_crash_recovery_token_identical(variant, seed):
    outputs = _oracle(variant)
    engine, reqs, streams = _faulted_pair(variant, _random_fail_calls(seed))
    m = engine.metrics
    assert m.n_recoveries >= 1
    assert m.n_crash_failures == m.failed_ticks
    assert m.requeued_requests >= 1
    _check_identical(reqs, streams, outputs)
    assert sum(r.n_requeues for r in reqs) == m.requeued_requests
    engine.sched.check_conservation()
    _check_pool_clean(engine)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hang_recovery_token_identical(variant, clock):
    outputs = _oracle(variant)
    engine, reqs, streams = _faulted_pair(variant, {3, 9}, clock=clock)
    assert engine.metrics.n_hang_failures == 2
    assert engine.metrics.n_recoveries == 2
    assert engine.metrics.n_crash_failures == 0
    _check_identical(reqs, streams, outputs)
    engine.sched.check_conservation()
    _check_pool_clean(engine)


def test_hang_recovery_with_a_real_deadline():
    """The one real-clock engine case: a call that sleeps past a real
    deadline (0.5 s, over 10x the slowest tiny tick here) is discarded.
    A loaded machine could add a phantom hang, so only the floor is
    asserted; tokens must be exact whatever the count."""
    outputs = _oracle("dense")
    engine, _ = make_engine("dense", self_heal=True, hang_timeout=0.5)
    reqs, streams = _submit_all(engine)
    calls = [0]
    orig = engine.stepper.decode

    def slow(*args):
        calls[0] += 1
        out = orig(*args)
        if calls[0] == 2:
            time.sleep(0.6)
        return out

    engine.stepper.decode = slow
    engine.run()
    assert engine.metrics.n_hang_failures >= 1
    _check_identical(reqs, streams, outputs)


# --------------------------------------------------------------------------- #
# page-level resume: deterministic tick counts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["dense", "paged-fp32", "paged-int8"])
def test_page_level_resume_skips_committed_rows(variant):
    """One request, 16-token prompt, chunk 4: crash the second decode call
    and the resume costs exactly ONE more prefill tick (the failed tick's
    token position, through the prefill Program as in JAX), with
    ``recovered_rows`` accounting for the fast-forward row for row."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(2, TINY.vocab, size=16).astype(np.int32)

    def run(inject, jax=False):
        engine, _ = make_engine(variant, jax=jax, self_heal=True)
        req = (jeng.EngineRequest if jax else EngineRequest)(
            uid=0, prompt=prompt, max_new_tokens=6)
        if inject:
            _inject(engine.stepper, {2}, phases=("decode",))
        assert engine.submit(req)
        engine.run()
        assert req.done and req.dropped is None
        return engine, req

    base_engine, base_req = run(inject=False)
    assert len(base_req.out_tokens) >= 3
    cold_prefill = base_engine.metrics.prefill_ticks
    assert cold_prefill == 4
    rec_engine, rec_req = run(inject=True)
    assert rec_engine.metrics.n_recoveries == 1
    assert rec_req.out_tokens == base_req.out_tokens
    assert rec_engine.metrics.recovered_rows == len(prompt) + 1
    assert rec_engine.metrics.prefill_ticks == cold_prefill + 1
    _check_pool_clean(rec_engine)
    j_engine, j_req = run(inject=True, jax=True)
    assert j_req.out_tokens == rec_req.out_tokens
    assert (j_engine.metrics.prefill_ticks, j_engine.metrics.recovered_rows) == \
        (rec_engine.metrics.prefill_ticks, rec_engine.metrics.recovered_rows)


@pytest.mark.parametrize("variant", ["paged-fp32", "paged-int8"])
def test_page_level_resume_burst_never_reprefills(variant):
    outputs = _oracle(variant)
    clean_engine, _ = make_engine(variant)
    _submit_all(clean_engine)
    clean_engine.run()
    clean_prefill = clean_engine.metrics.prefill_ticks
    engine, reqs, streams = _faulted_pair(variant, _random_fail_calls(3000, lo=8, hi=16),
                                          phases=("decode",))
    assert engine.metrics.n_recoveries >= 1
    _check_identical(reqs, streams, outputs)
    assert engine.metrics.recovered_rows > 0
    assert engine.metrics.prefill_ticks <= clean_prefill + engine.metrics.requeued_requests
    engine.sched.check_conservation()
    _check_pool_clean(engine)


# --------------------------------------------------------------------------- #
# the dense resume's row relocation
# --------------------------------------------------------------------------- #

def test_relocate_slots_moves_a_swapped_pair_and_a_chain():
    engine, _ = make_engine("dense", n_slots=4)
    st = engine.stepper
    gen = torch.Generator().manual_seed(0)
    for name in st.caches:
        st.caches[name] = torch.randn(st.caches[name].shape, generator=gen)
    before = {k: v.clone() for k, v in st.caches.items()}
    st.relocate_slots([(0, 1), (1, 0)])                 # a swapped pair
    for k, v in st.caches.items():
        assert torch.equal(v[0], before[k][1]) and torch.equal(v[1], before[k][0])
        assert torch.equal(v[2:], before[k][2:])
    before = {k: v.clone() for k, v in st.caches.items()}
    st.relocate_slots([(1, 2), (2, 3), (3, 0)])         # a chain 1 -> 2 -> 3 -> 0
    for k, v in st.caches.items():
        assert torch.equal(v[2], before[k][1]) and torch.equal(v[3], before[k][2])
        assert torch.equal(v[0], before[k][3]) and torch.equal(v[1], before[k][1])
    st.relocate_slots([])


def test_dense_resume_relocates_rows_into_another_slot():
    """Two slots: once uid 0 finishes, uid 2 takes slot 0 while uid 1 holds
    slot 1.  A crash then requeues both, and FIFO re-admission puts uid 1
    into slot 0 and uid 2 into slot 1 — a swap, each resuming from its
    relocated rows with its tokens intact."""
    outputs = _oracle("dense")
    engine, _ = make_engine("dense", n_slots=2, self_heal=True)
    reqs, streams = _submit_all(engine)
    moves, relocate = [], engine.stepper.relocate_slots
    engine.stepper.relocate_slots = lambda mv: (moves.extend(mv), relocate(mv))
    while not reqs[0].done or engine.slots[0] is None:
        engine.step()
    assert engine.slots[0].req is reqs[2] and engine.slots[1].req is reqs[1]
    _inject(engine.stepper, {1}, phases=("decode", "prefill"))
    engine.run()
    assert sorted(moves) == [(0, 1), (1, 0)]
    assert engine.metrics.recovered_rows > 0
    _check_identical(reqs, streams, outputs)


# --------------------------------------------------------------------------- #
# scheduler/recovery interactions
# --------------------------------------------------------------------------- #

def test_int8_weights_compose_with_recovery():
    """kv8 pages + int8 weight Programs through recovery, against an
    uninterrupted run of the same stack."""
    def run(inject):
        engine, _ = make_engine("paged-int8", quantize="int8", self_heal=inject)
        reqs, streams = _submit_all(engine)
        if inject:
            _inject(engine.stepper, _random_fail_calls(7))
        engine.run()
        for r, toks in zip(reqs, streams):
            assert r.done and toks == r.out_tokens
        if inject:
            assert engine.metrics.n_recoveries >= 1
            engine.stepper.pool.check_integrity()
        return {r.uid: list(r.out_tokens) for r in reqs}

    assert run(inject=False) == run(inject=True)


def test_recovery_requeue_never_sheds_admitted_requests():
    outputs = _oracle("dense")
    engine, _ = make_engine("dense", n_slots=2, self_heal=True, max_queue=2)
    reqs, streams = [], []
    for i, p in enumerate(PROMPTS):
        toks = []
        req = EngineRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW,
                            on_token=lambda r, t, toks=toks: toks.append(t))
        if engine.submit(req):
            reqs.append(req)
            streams.append(toks)
        else:
            assert req.dropped == "queue_full"
        if i == 1:
            engine.step()
    rejected0 = engine.metrics.n_rejected
    assert rejected0 >= 1 and len(reqs) >= 4
    assert engine.sched.queue_len == 2 and engine.sched.busy_slots == 2
    _inject(engine.stepper, {2, 4, 7}, phases=("decode", "prefill"))
    engine.run()
    assert engine.metrics.n_recoveries >= 1
    assert engine.metrics.requeued_requests >= 1
    assert engine.metrics.n_rejected == rejected0
    _check_identical(reqs, streams, outputs)
    engine.sched.check_conservation()


def test_recovery_is_a_membership_event():
    outputs = _oracle("dense")
    engine, _ = make_engine("dense")
    coord = Coordinator(deadline=60.0)
    engine = Engine(engine.stepper, self_heal=True, coordinator=coord, host_id="engine-0")
    gen0 = coord.generation
    assert coord.alive() == ["engine-0"]
    reqs, streams = _submit_all(engine)
    _inject(engine.stepper, {4}, phases=("decode", "prefill"))
    engine.run()
    assert engine.metrics.n_recoveries == 1
    assert coord.generation == gen0 + 1
    assert coord.alive() == ["engine-0"]
    _check_identical(reqs, streams, outputs)


def test_gives_up_after_max_recoveries():
    engine, _ = make_engine("dense", self_heal=True, max_recoveries=3)
    _submit_all(engine)
    _inject(engine.stepper, set(range(1, 10_000)))
    with pytest.raises(TickFailure, match="giving up"):
        engine.run()
    assert engine.metrics.n_recoveries == 3


def test_without_self_heal_faults_propagate():
    engine, _ = make_engine("dense")
    _submit_all(engine)
    _inject(engine.stepper, {2})
    with pytest.raises(RuntimeError, match="injected fault"):
        engine.run()
    assert engine.metrics.n_recoveries == 0


def test_a_real_out_of_memory_error_heals():
    """A torch out-of-memory error (what the card raises) inside a stepper
    call is a crash like any other: the tick is discarded and the run heals;
    without self_heal it propagates."""
    outputs = _oracle("paged-fp32")

    def run(self_heal):
        engine, _ = make_engine("paged-fp32", self_heal=self_heal)
        reqs, streams = _submit_all(engine)
        calls, orig = [0], engine.stepper.decode

        def oom(*args):
            calls[0] += 1
            if calls[0] == 3:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
            return orig(*args)

        engine.stepper.decode = oom
        engine.run()
        return engine, reqs, streams

    engine, reqs, streams = run(True)
    assert engine.metrics.n_crash_failures == 1
    _check_identical(reqs, streams, outputs)
    _check_pool_clean(engine)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run(False)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_kv8_hang_after_the_writes_landed_is_exact(phase, clock):
    """A hang on a kv8 tick is discarded after its page writes (and page
    scale growth) landed; the replayed tick writes the same rows again,
    which is bit-idempotent, so the tokens equal the uninterrupted run's."""
    outputs = _oracle("paged-int8")
    engine, reqs, streams = _faulted_pair("paged-int8", {2, 4}, phases=(phase,),
                                          clock=clock)
    assert engine.metrics.n_hang_failures == 2
    _check_identical(reqs, streams, outputs)
    _check_pool_clean(engine)
