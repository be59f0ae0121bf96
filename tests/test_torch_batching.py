"""The port's ContinuousBatcher on the CPU, on five reduced configs:
gemma3-1b (local and global layers, MQA, prompts on both sides of the
window of 16), qwen2-moe-a2.7b (MoE FFNs), mamba2-370m (SSD mixers,
conv and SSM state caches), deepseek-v2-lite-16b (MLA's latent caches and
absorbed decode) and zamba2-7b (Mamba2 blocks and the shared attention
blocks' per-application caches).  Every request equals the port's unbatched
greedy prefill + decode, and equals the JAX package's ContinuousBatcher on
the same weights and requests.  Also slot reuse, utilisation, the
scheduler's conservation, the splice of attention and mamba caches, and
the serving entry point ``python -m repro_torch.launch.serve``."""

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
ARCHS = [ARCH, "qwen2-moe-a2.7b", "mamba2-370m", "deepseek-v2-lite-16b", "zamba2-7b"]
# two prompt lengths (JAX compiles one prefill per length), one past the window
LENGTHS, MAX_NEW = (6, 21, 21, 6, 21, 6, 6, 21), (5, 3, 7, 4, 6, 2, 8, 5)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(2, vocab, n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LENGTHS, MAX_NEW))]


def _setup(arch):
    jmodel = JLM(jget_reduced(arch))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = LM(get_reduced(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def setup():
    return _setup(ARCH)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(setup, port_run) of one reduced config."""
    return _serve(_setup(request.param))


@pytest.fixture(scope="module")
def port_run(setup):
    return _serve(setup)[1]


def _serve(setup):
    _, _, model, params = setup
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS, cache_cap=CAP, eos_id=-1)
    reqs = _requests(Request, model.cfg.vocab)
    for r in reqs:
        batcher.submit(r)
    finished = batcher.run()
    return setup, (batcher, reqs, finished)


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


def test_batched_equals_unbatched_greedy(served):
    (_, _, model, params), (_, reqs, _) = served
    for r in reqs:
        assert r.done and len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == _greedy(model, params, r.prompt, r.max_new_tokens), r.uid


def test_batched_equals_the_jax_batcher(served):
    (jmodel, jparams, model, _), (_, reqs, _) = served
    jb = JBatcher(jmodel, jparams, n_slots=SLOTS, cache_cap=CAP, eos_id=-1)
    jreqs = _requests(JRequest, model.cfg.vocab)
    for r in jreqs:
        jb.submit(r)
    jb.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


def test_slots_are_reused_and_kept_busy(served):
    _, (batcher, reqs, finished) = served
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


def test_one_slot_batcher_equals_unbatched_greedy(setup):
    """With one slot every cache leaf has the prefill's shape: the splice
    writes the whole leaf."""
    _, _, model, params = setup
    batcher = ContinuousBatcher(model, params, n_slots=1, cache_cap=CAP, eos_id=-1)
    reqs = _requests(Request, model.cfg.vocab)[:3]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for r in reqs:
        assert r.out_tokens == _greedy(model, params, r.prompt, r.max_new_tokens), r.uid


def test_splice_writes_one_slot_of_mamba_caches():
    """A mamba block's conv tails (n_periods, B, K-1, C) and SSM state
    (n_periods, B, H, P, N) take the prefill's batch-1 leaves in one slot."""
    _, _, model, params = _setup("mamba2-370m")
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS, cache_cap=CAP)
    _, cache1, _ = model.prefill(params, {"tokens": torch.arange(2, 23)[None]}, cache_cap=CAP)
    s = model.cfg.ssm
    full = batcher.caches["period"][0]["mix"]
    shapes = {"conv_x": (s.conv_kernel - 1, s.d_inner),
              "ssm": (s.n_heads, s.head_dim, s.state)}
    batcher._splice_cache(2, cache1)
    for name, tail in shapes.items():
        assert tuple(full[name].shape) == (model.cfg.plan.n_periods, SLOTS) + tail
        one = cache1["period"][0]["mix"][name]
        assert torch.equal(full[name][:, 2:3], one) and float(full[name][:, :2].abs().max()) == 0
    assert full["ssm"].dtype == torch.float32


def test_serve_entry_point_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--requests", "5", "--max-new", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert "arch=gemma3-1b-reduced device=cpu" in out and "completed 5/5" in out


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_serve_entry_point_serves_moe_and_mamba(monkeypatch, capsys, arch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--device", "cpu",
                                      "--requests", "5", "--max-new", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced device=cpu" in out and "completed 5/5" in out


def test_serving_config():
    """gemma3-1b's published config at its published bfloat16: every kernel
    op it runs on the card (attention, decode_attention, rmsnorm, dense)
    has a bf16 body; the reduced config is fp32."""
    cfg = serve.serving_config(ARCH, full=True, device="cpu")
    assert (cfg.d_model, cfg.n_layers, cfg.dtype, cfg.param_dtype) == \
        (1152, 26, "bfloat16", "bfloat16")
    assert serve.serving_config(ARCH, device="cpu").dtype == "float32"
    assert cfg.backend("attention") == "ref"
    if torch.cuda.is_available():
        assert serve.serving_config(ARCH).backend("attention") == "cuda"
    else:                                          # no card: no silent fall-back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.serving_config(ARCH)
