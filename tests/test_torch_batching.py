"""The port's ContinuousBatcher on the CPU (gemma3-1b reduced: local and
global layers, MQA, prompts on both sides of the window of 16): every
request equals the port's unbatched greedy prefill + decode, and equals
the JAX package's ContinuousBatcher on the same weights and requests.
Also slot reuse, utilisation, the scheduler's conservation, and the
serving entry point ``python -m repro_torch.launch.serve``."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.models.lm import LM as JLM
from repro.runtime.batching import ContinuousBatcher as JBatcher
from repro.runtime.batching import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models.lm import LM, params_from_numpy
from repro_torch.runtime.batching import ContinuousBatcher, Request

ARCH, SLOTS, CAP = "gemma3-1b", 3, 64
# two prompt lengths (JAX compiles one prefill per length), one past the window
LENGTHS, MAX_NEW = (6, 21, 21, 6, 21, 6, 6, 21), (5, 3, 7, 4, 6, 2, 8, 5)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(2, vocab, n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LENGTHS, MAX_NEW))]


@pytest.fixture(scope="module")
def setup():
    jmodel = JLM(jget_reduced(ARCH))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = LM(get_reduced(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def port_run(setup):
    _, _, model, params = setup
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS, cache_cap=CAP, eos_id=-1)
    reqs = _requests(Request, model.cfg.vocab)
    for r in reqs:
        batcher.submit(r)
    finished = batcher.run()
    return batcher, reqs, finished


def _greedy(model, params, prompt, n):
    lg, caches, lengths = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                                        cache_cap=CAP)
    out = [int(torch.argmax(lg[0]))]
    while len(out) < n:
        lg, caches = model.decode_step(params, torch.tensor([out[-1]], dtype=torch.int32),
                                       caches, lengths)
        lengths = lengths + 1
        out.append(int(torch.argmax(lg[0])))
    return out


def test_batched_equals_unbatched_greedy(setup, port_run):
    _, _, model, params = setup
    _, reqs, _ = port_run
    for r in reqs:
        assert r.done and len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == _greedy(model, params, r.prompt, r.max_new_tokens), r.uid


def test_batched_equals_the_jax_batcher(setup, port_run):
    jmodel, jparams, model, _ = setup
    _, reqs, _ = port_run
    jb = JBatcher(jmodel, jparams, n_slots=SLOTS, cache_cap=CAP, eos_id=-1)
    jreqs = _requests(JRequest, model.cfg.vocab)
    for r in jreqs:
        jb.submit(r)
    jb.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


def test_slots_are_reused_and_kept_busy(port_run):
    batcher, reqs, finished = port_run
    assert sorted(r.uid for r in finished) == [r.uid for r in reqs]
    assert batcher.run() == []                     # handed out exactly once
    assert batcher.steps < sum(MAX_NEW)            # slots were shared across requests
    assert len(reqs) > SLOTS and batcher.utilisation > 0.5
    s = batcher.sched
    assert s.n_submitted == s.n_finished == len(reqs) and s.busy_slots == 0
    s.check_conservation()


def test_eos_finishes_a_request_early(setup):
    _, _, model, params = setup
    prompt = np.arange(2, 12, dtype=np.int32)
    want = _greedy(model, params, prompt, 6)
    batcher = ContinuousBatcher(model, params, n_slots=2, cache_cap=CAP, eos_id=want[2])
    r = Request(uid=0, prompt=prompt, max_new_tokens=6)
    batcher.submit(r)
    batcher.run()
    assert r.done and r.out_tokens == want[:want.index(want[2]) + 1]


def test_splice_writes_one_slot_of_stacked_and_plain_caches(setup):
    _, _, model, params = setup
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS, cache_cap=CAP)
    _, cache1, _ = model.prefill(params, {"tokens": torch.arange(2, 23)[None]}, cache_cap=CAP)
    batcher._splice_cache(1, cache1)
    for full, one in ((batcher.caches["period"][0]["mix"]["k"], cache1["period"][0]["mix"]["k"]),
                      (batcher.caches["suffix"][1]["mix"]["v"], cache1["suffix"][1]["mix"]["v"])):
        b_axis = full.dim() - 4
        assert torch.equal(full.narrow(b_axis, 1, 1), one)
        assert float(full.narrow(b_axis, 0, 1).abs().max()) == 0.0


def test_serve_entry_point_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--requests", "5", "--max-new", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert "arch=gemma3-1b-reduced device=cpu" in out and "completed 5/5" in out


def test_serving_config():
    cfg = serve.serving_config(ARCH, full=True, device="cpu")
    assert (cfg.d_model, cfg.n_layers, cfg.dtype, cfg.param_dtype) == \
        (1152, 26, "float32", "float32")
    assert cfg.backend("attention") == "ref"
    if torch.cuda.is_available():
        assert serve.serving_config(ARCH).backend("attention") == "cuda"
    else:                                          # no card: no silent fall-back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.serving_config(ARCH)
