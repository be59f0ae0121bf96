"""The port's ``AsyncEngine`` (asyncio streaming front end of
``repro_torch.runtime.engine``) and ``launch.serve --engine --int8``
against the JAX package on the CPU: streams equal JAX's ``AsyncEngine``
streams and the port's ``UnbatchedReference`` (tests/test_serving_engine.py's
async test), concurrent streams tick for tick with the synchronous engine,
the rejection and mid-flight-drop errors, and the launcher's request lines
equal to JAX's."""

import asyncio
import sys

import numpy as np
import pytest

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.launch import serve as jserve
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro_torch.launch import serve as tserve
from repro_torch.models import graph_lm as tlm
from repro_torch.runtime import AsyncEngine, EngineRequest, build_lm_serving

TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)


@pytest.fixture(scope="module")
def serving():
    return build_lm_serving(tlm.GraphLMConfig(**TINY_ARGS), n_slots=3, chunk=4,
                            cache_cap=48, device="cpu")


@pytest.fixture(scope="module")
def jax_serving():
    return jeng.build_lm_serving(jlm.GraphLMConfig(**TINY_ARGS), n_slots=3, chunk=4,
                                 cache_cap=48)


def _stream_all(aeng, prompts, max_new):
    async def collect(prompt, n):
        return [tok async for tok in aeng.generate(prompt, n)]

    async def main():
        return await asyncio.gather(*[collect(p, n) for p, n in zip(prompts, max_new)],
                                    aeng.run())

    return asyncio.run(main())[:-1]


def test_streams_match_reference_and_jax(serving, jax_serving):
    engine, ref = serving
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32) for n in (3, 7)]
    got = _stream_all(AsyncEngine(engine), prompts, [5, 5])
    assert got == [ref.generate(p, 5) for p in prompts]
    assert got == _stream_all(jeng.AsyncEngine(jax_serving[0]), prompts, [5, 5])


@pytest.mark.parametrize("variant", [
    {"paged": True, "page_size": 8}, {"paged": True, "page_size": 8, "kv_dtype": "int8"},
    {"spec_k": 3}, {"quantize": "int8"}],
    ids=["paged-fp32", "paged-int8", "spec", "int8-weights"])
def test_streams_match_reference_on_every_variant(variant):
    engine, ref = build_lm_serving(tlm.GraphLMConfig(**TINY_ARGS), n_slots=3, chunk=4,
                                   cache_cap=48, device="cpu", **variant)
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32) for n in (3, 7, 11, 2)]
    got = _stream_all(AsyncEngine(engine), prompts, [5, 6, 3, 7])
    assert got == [ref.generate(p, n) for p, n in zip(prompts, [5, 6, 3, 7])]
    engine.sched.check_conservation()


def test_concurrent_streams_tick_for_tick(serving):
    """Eight streams submitted before the first tick: the same tokens and
    the same tick counts as the synchronous engine on the same requests."""
    engine, _ = serving
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 61, int(rng.integers(1, 13))).astype(np.int32)
               for _ in range(8)]
    max_new = [int(n) for n in rng.integers(1, 9, 8)]
    reqs = [EngineRequest(uid=100 + i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    engine.reset_metrics()
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    ticks = (engine.metrics.prefill_ticks, engine.metrics.decode_ticks)
    engine.reset_metrics()
    got = _stream_all(AsyncEngine(engine), prompts, max_new)
    assert got == [r.out_tokens for r in reqs]
    assert (engine.metrics.prefill_ticks, engine.metrics.decode_ticks) == ticks
    engine.sched.check_conservation()


def test_rejected_request_raises(serving):
    engine, _ = serving
    aeng = AsyncEngine(engine)

    async def main():
        return [t async for t in aeng.generate(np.zeros(45, np.int32), 30)]

    with pytest.raises(RuntimeError, match="request rejected: too_long"):
        asyncio.run(main())


def test_mid_flight_drop_raises(serving):
    """A deadline that expires after the first tokens: the stream ends with
    an error, not as a completion; what was streamed is kept."""
    engine, _ = serving
    aeng = AsyncEngine(engine)
    seen = []

    async def consume():
        async for tok in aeng.generate(np.arange(1, 4, dtype=np.int32), 20,
                                       deadline_tick=engine.tick + 4):
            seen.append(tok)

    async def main():
        await asyncio.gather(consume(), aeng.run())

    with pytest.raises(RuntimeError, match="dropped after .* tokens: deadline"):
        asyncio.run(main())
    assert 0 < len(seen) < 20
    engine.run()
    engine.sched.check_conservation()


def test_serve_int8_prints_jax_request_lines(capsys, monkeypatch):
    """``--engine --int8`` (int8 weights, one shared calibration): the
    engine line and every request line equal JAX's."""
    monkeypatch.setattr(sys, "argv", ["serve", "--engine", "--int8", "--device", "cpu",
                                      "--requests", "6"])
    tserve.main()
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve", "--engine", "--int8", "--requests", "6"])
    jserve.main()
    want = capsys.readouterr().out.splitlines()

    def lines(out):
        return [ln for ln in out if ln.startswith(("engine:", "  req", "paged pool"))]

    assert lines(got) == lines(want)
    assert lines(got)[0] == ("engine: slots=4 chunk=8 int8=True paged=False "
                             "kv_dtype=float32 requests=6")
    assert len(lines(got)) == 4
