"""Fault injection through the speculative phases of the port's
self-healing engine on the CPU — the crash and hang tests of
tests/test_speculative.py (:243-344) on the port's dense, paged fp32 and
paged int8 spec engines, token-exact against their uninterrupted runs; the
seed-0 crash cases, the hang cases and the commit crash also against the
JAX package's spec engine with the same faults on the same weights (equal
tokens and counters); plus: a crash at ``commit_spec`` never commits a
stale ``_pending_kv``.  The engines and helpers are
tests/test_torch_fault_injection.py's; hangs run on its fake clock."""

import numpy as np
import pytest

from repro.runtime import engine as jeng
from repro_torch.runtime.engine import EngineRequest
from test_torch_fault_injection import (HANG_TIMEOUT, TINY, _check_pool_clean,  # noqa: F401
                                        _inject, _record, clock, make_engine)

SPEC_PHASES = ("prefill", "draft_prefill", "draft", "verify")


def _spec_reqs(seed=42, cls=EngineRequest):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, TINY.vocab, size=int(rng.integers(1, 10)))
                .astype(np.int32), max_new_tokens=int(rng.integers(4, 7)))
            for i in range(6)]


def _run_burst(engine, cls=EngineRequest):
    reqs, streams = [], []
    for r in _spec_reqs(cls=cls):
        toks = []
        r.on_token = lambda _r, t, toks=toks: toks.append(t)
        assert engine.submit(r)
        reqs.append(r)
        streams.append(toks)
    engine.run(max_ticks=engine.tick + 4000)
    for r, toks in zip(reqs, streams):
        assert r.done and r.dropped is None, (r.uid, r.dropped)
        assert toks == r.out_tokens
    return {r.uid: list(r.out_tokens) for r in reqs}, _record(engine, reqs)[1:]


_SPEC_WANT = {}


def _spec_want(variant):
    if variant not in _SPEC_WANT:
        _SPEC_WANT[variant] = _run_burst(make_engine(variant, spec_k=3)[0])[0]
    return _SPEC_WANT[variant]


def _spec_pair(variant, at, phases, clock=None, against_jax=True):
    """The port's spec engine with the faults injected and — unless
    ``against_jax`` is off — the JAX package's with the same faults: equal
    tokens and counters.  Returns the port's engine and tokens.  (The JAX
    package compiles every spec engine anew, a few seconds each, so the
    repeated cases compare with the port's own uninterrupted run only.)"""
    kw = {"spec_k": 3, "self_heal": True}
    if clock is not None:
        kw["hang_timeout"] = HANG_TIMEOUT
    got = []
    for jax in (False, True)[:2 if against_jax else 1]:
        engine, _ = make_engine(variant, jax=jax, **kw)
        _inject(engine.stepper, at, phases, clock=clock)
        got.append((engine, _run_burst(engine, jeng.EngineRequest if jax else EngineRequest)))
    engine, (tokens, rec) = got[0]
    if against_jax:
        assert (tokens, rec) == got[1][1]
    return engine, tokens


@pytest.mark.parametrize("variant", ["dense", "paged-fp32", "paged-int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_crash_recovery_token_identical(variant, seed):
    rng = np.random.default_rng(seed)
    fails = set(int(c) for c in rng.choice(np.arange(2, 20), size=3, replace=False))
    engine, got = _spec_pair(variant, fails, SPEC_PHASES, against_jax=seed == 0)
    assert engine.metrics.n_recoveries >= 1
    assert got == _spec_want(variant)
    engine.sched.check_conservation()
    _check_pool_clean(engine)


@pytest.mark.parametrize("variant", ["dense", "paged-fp32", "paged-int8"])
def test_spec_hang_recovery_token_identical(variant, clock):
    engine, got = _spec_pair(variant, {3, 9}, SPEC_PHASES, clock=clock)
    assert engine.metrics.n_hang_failures == 2
    assert engine.metrics.n_recoveries == 2
    assert got == _spec_want(variant)
    _check_pool_clean(engine)


def test_spec_kv8_commit_crash_recovery_token_identical():
    engine, got = _spec_pair("paged-int8", {1, 3}, ("commit_spec",))
    assert engine.metrics.n_recoveries >= 2
    assert got == _spec_want("paged-int8")
    _check_pool_clean(engine)


def test_spec_kv8_commit_hang_recovery_token_identical(clock):
    engine, got = _spec_pair("paged-int8", {2}, ("commit_spec",), clock=clock,
                             against_jax=False)
    assert engine.metrics.n_hang_failures == 1
    assert got == _spec_want("paged-int8")
    _check_pool_clean(engine)


def test_commit_crash_never_commits_a_stale_pending_kv():
    """Every commit must replay the rows of the verify call just before it:
    a crash at commit_spec leaves the failed tick's rows stashed, and
    recovery drops them, so the next commit sees only its own verify's."""
    engine, _ = make_engine("paged-int8", spec_k=3, self_heal=True)
    st = engine.stepper
    seen = {"verified": None, "commits": 0}
    verify, commit = st.verify, st.commit_spec

    def spy_verify(*args):
        out = verify(*args)
        seen["verified"] = st._pending_kv
        return out

    def spy_commit(*args):
        assert st._pending_kv is not None and st._pending_kv is seen["verified"]
        seen["commits"] += 1
        if seen["commits"] in (1, 3):
            raise RuntimeError("injected fault at commit")
        return commit(*args)

    st.verify, st.commit_spec = spy_verify, spy_commit
    got, _ = _run_burst(engine)
    assert engine.metrics.n_crash_failures == 2 and st._pending_kv is None
    assert got == _spec_want("paged-int8")
