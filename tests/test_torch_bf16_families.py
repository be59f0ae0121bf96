"""The MoE, MLA and Mamba2 families at the published bfloat16, held against
the JAX package on the CPU.

Inputs are drawn with numpy from a seed and rounded to bf16 once; both
sides get the same bits.

- The three bf16 entries this slice adds, through their wrappers on CPU
  tensors (the plain versions: the kernel's fp32 arithmetic on the upcast
  inputs, rounded once), against JAX's Pallas kernels in interpret mode at
  bf16: ``batched_gemm``, ``flash_decode`` at MLA's absorbed widths (D 576,
  Dv 512: the wide layout) and ``ssd_scan`` with bf16 x, B and C (dt, A
  and D fp32).  Both sides accumulate in fp32 and round once, so an
  element may differ by one bf16 ulp, plus the fp32 parity tolerance
  (2e-5).  JAX's scan rounds y to bf16 before its wrapper adds D x and
  rounds again; the port forms y + D x in fp32 and rounds once, so with D
  the bound adds half an ulp of the first rounding.
- The four reduced configs (qwen2-moe-a2.7b, deepseek-v2-lite-16b,
  mamba2-370m, zamba2-7b) overridden to bfloat16 on both sides, JAX's
  weights through ``params_from_numpy``, the port on ``CUDA_BACKENDS``
  (the plain versions on the CPU): prefill logits, caches and 4
  teacher-forced decode steps within twice JAX's own bf16-vs-fp32 gap.
- The ``ContinuousBatcher`` at bf16 on reduced qwen2-moe and mamba2,
  token-exact against its own unbatched run.
- ``chip_smoke.FP32_LEAVES`` against the leaves JAX's bf16 init keeps fp32.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.configs import list_configs as jlist_configs
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.kernels.gemm import batched_gemm as jbatched_gemm
from repro.kernels.ssd import ssd_scan as jssd_scan
from repro.models.lm import LM as JLM
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gemm import batched_gemm, batched_gemm_plain
from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
from repro_torch.models.lm import CUDA_BACKENDS, LM, params_from_numpy
from repro_torch.runtime.batching import ContinuousBatcher, Request
from test_torch_bf16 import _bf16, _f32, _flat, _ulp
from test_torch_bf16 import _within_one_ulp as _within

B, S0, CAP, STEPS = 2, 24, 40, 4
FAMILIES = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b"]
ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------- #
# the three kernels at bf16 against their Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("e,m,k,n", [(3, 5, 64, 48), (2, 17, 130, 40), (4, 1, 300, 37),
                                     (2, 4, 128, 96)])
def test_batched_gemm_bf16_against_pallas(e, m, k, n):
    rng = np.random.default_rng(e * m + k + n)
    jx, x = _bf16(rng, e, m, k)
    jw, w = _bf16(rng, e, k, n, scale=k ** -0.5)
    want = jbatched_gemm(jx, jw, interpret=True)
    got = batched_gemm(x, w)
    assert want.dtype == jnp.bfloat16
    _within(got, want)
    # the plain version is the fp32 product of the upcast operands, rounded once
    assert torch.equal(got, torch.bmm(x.float(), w.float()).to(torch.bfloat16))
    assert torch.equal(got, batched_gemm_plain(x, w))
    assert torch.equal(kops.moe_gemm(x, w, backend="cuda"), got)


@pytest.mark.parametrize("lens", [(0, 1, 37, 64), (64, 63, 2, 17)])
def test_wide_flash_decode_bf16_against_pallas(lens):
    """MLA's absorbed decode (16 query heads on 1 KV head, D 576, Dv 512)
    on the bf16 entry: the wide layout takes bf16 rows."""
    b, s, hq, d, dv = len(lens), 64, 16, 576, 512
    rng = np.random.default_rng(sum(lens))
    jq, q = _bf16(rng, b, hq, d)
    jk, k = _bf16(rng, b, s, 1, d)
    jv, v = _bf16(rng, b, s, 1, dv)
    lengths = np.asarray(lens, np.int32)
    scale = 1.0 / np.sqrt(192.0)
    want = jflash_decode(jq, jk, jv, jnp.asarray(lengths), scale=scale, block_kv=32,
                         interpret=True)
    got = fd.flash_decode(q, k, v, torch.from_numpy(lengths), scale=scale)
    assert got.shape == (b, hq, dv)
    _within(got, want)
    assert torch.equal(got, fd.flash_decode(q.float(), k.float(), v.float(),
                                            torch.from_numpy(lengths),
                                            scale=scale).to(torch.bfloat16))
    assert torch.equal(got, kops.decode_attention(q, k, v, torch.from_numpy(lengths),
                                                  scale=scale, backend="cuda"))
    if 0 in lens:
        assert not got[lens.index(0)].float().any()


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 64, 4, 16, 1, 32, 32), (2, 48, 4, 8, 2, 16, 16)])
@pytest.mark.parametrize("with_d", [False, True])
def test_ssd_scan_bf16_against_pallas(b, s, h, p, g, n, chunk, with_d):
    rng = np.random.default_rng(s + h + p + with_d)
    jx, x = _bf16(rng, b, s, h, p)
    jbm, bm = _bf16(rng, b, s, g, n, scale=0.3)
    jcm, cm = _bf16(rng, b, s, g, n, scale=0.3)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 3.0)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    dd = rng.standard_normal(h).astype(np.float32) if with_d else None
    jy, jst = jssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jbm, jcm,
                        None if dd is None else jnp.asarray(dd), chunk=chunk, interpret=True)
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    td = None if dd is None else torch.from_numpy(dd)
    y, st = ssd_scan(x, tdt, ta, bm, cm, td, chunk=chunk)
    assert jy.dtype == jnp.bfloat16 and st.dtype == torch.float32
    extra = 0.0
    if with_d:
        # JAX rounds y - D x to bf16 first: half an ulp of that value more
        extra = _ulp(np.abs(_f32(y) - _f32(x) * dd[None, None, :, None])) / 2
    _within(y, jy, extra)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-4)
    # one rounding of the fp32 scan of the upcast inputs (the D term in fp32)
    y32, st32 = ssd_scan(x.float(), tdt, ta, bm.float(), cm.float(), td, chunk=chunk)
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(st, st32)
    assert all(torch.equal(u, v) for u, v in zip((y, st), ssd_scan_plain(x, tdt, ta, bm, cm, td,
                                                                         chunk=chunk)))
    got = kops.ssd(x, tdt, ta, bm, cm, td, chunk=chunk, backend="cuda")
    assert torch.equal(got[0], y) and torch.equal(got[1], st)


def test_ssd_scan_refuses_mixed_types_naming_the_argument():
    x = torch.zeros(1, 16, 2, 4, dtype=torch.bfloat16)
    bc = torch.zeros(1, 16, 1, 8, dtype=torch.bfloat16)
    dt, a = torch.full((1, 16, 2), 0.1), -torch.ones(2)
    with pytest.raises(TypeError, match="C must be torch.bfloat16"):
        ssd_scan(x, dt, a, bc, bc.float())
    with pytest.raises(TypeError, match="dt must be float32"):
        ssd_scan(x, dt.to(torch.bfloat16), a, bc, bc)
    with pytest.raises(TypeError, match="D must be float32"):
        ssd_scan(x, dt, a, bc, bc, torch.ones(2, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        ssd_scan(x.half(), dt, a, bc.half(), bc.half())
    with pytest.raises(TypeError, match="need one dtype"):
        batched_gemm(torch.zeros(2, 3, 8, dtype=torch.bfloat16), torch.zeros(2, 8, 4))


# --------------------------------------------------------------------------- #
# the four reduced configs at bf16 against JAX's
# --------------------------------------------------------------------------- #

def _jax_run(jcfg, jparams, toks):
    """JAX's prefill logits, caches and decode logits, teacher-forced."""
    model = JLM(jcfg)
    lg, caches, lengths = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_cap=CAP))(
        jparams, jnp.asarray(toks[:, :S0]))
    out = {"prefill": {"": lg}, "caches": _flat(caches, "prefill"), "decode": {}}
    step = jax.jit(model.decode_step)
    for t in range(S0, S0 + STEPS):
        lg, caches = step(jparams, jnp.asarray(toks[:, t]), caches, lengths)
        lengths = lengths + 1
        out["decode"][t] = lg
    out["caches"].update(_flat(caches, "last"))
    return out


def _port_run(cfg, params, toks):
    model = LM(cfg)
    lg, caches, lengths = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S0])},
                                        cache_cap=CAP)
    out = {"prefill": {"": lg}, "caches": _flat(caches, "prefill"), "decode": {}}
    for t in range(S0, S0 + STEPS):
        lg, caches = model.decode_step(params, torch.from_numpy(toks[:, t]), caches, lengths)
        lengths = lengths + 1
        out["decode"][t] = lg
    out["caches"].update(_flat(caches, "last"))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_family_bf16_within_twice_jax_own_bf16_error(arch):
    jcfg = jget_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    jparams = JLM(jcfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    jax_bf16 = _jax_run(jcfg, jparams, toks)
    # JAX's fp32 on the same (upcast) weights: the yardstick
    jax_f32 = _jax_run(jcfg.with_overrides(dtype="float32", param_dtype="float32"),
                       jax.tree.map(lambda a: a.astype(jnp.float32), jparams), toks)
    cfg = get_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                           backends=CUDA_BACKENDS)
    port = _port_run(cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), toks)
    for part in ("prefill", "caches", "decode"):
        keys = sorted(jax_bf16[part], key=str)
        assert sorted(port[part], key=str) == keys, part
        # each output in JAX's dtype: bf16 logits and caches, the SSM state fp32
        for key in keys:
            assert str(port[part][key].dtype).split(".")[1] == str(jax_bf16[part][key].dtype), key
        gap = max(float(np.max(np.abs(_f32(jax_bf16[part][k]) - _f32(jax_f32[part][k]))))
                  for k in keys)
        diff = max(float(np.max(np.abs(_f32(port[part][k]) - _f32(jax_bf16[part][k]))))
                   for k in keys)
        assert 0.0 < gap and diff <= 2.0 * gap, (arch, part, diff, gap)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m"])
def test_batcher_at_bf16_is_token_exact_against_its_unbatched_run(arch):
    cfg = get_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                           backends=CUDA_BACKENDS)
    model = LM(cfg)
    params = model.init_params(0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip((6, 21, 21, 6, 21), (5, 3, 7, 4, 6)))]
    batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=CAP, eos_id=-1)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for r in reqs:
        lg, caches, lengths = model.prefill(params, {"tokens": torch.from_numpy(r.prompt)[None]},
                                            cache_cap=CAP)
        assert lg.dtype == torch.bfloat16
        out = [int(torch.argmax(lg[0]))]
        while len(out) < r.max_new_tokens:
            lg, caches = model.decode_step(params, torch.tensor([out[-1]], dtype=torch.int32),
                                           caches, lengths)
            lengths = lengths + 1
            out.append(int(torch.argmax(lg[0])))
        assert r.done and r.out_tokens == out, r.uid


def test_chip_smokes_fp32_leaves_are_jax_inits():
    """chip_smoke.py's check_served_dtype holds every leaf to the dtype
    JAX's init gives it: FP32_LEAVES are exactly the leaves JAX's bf16 init
    keeps fp32, over every config the batcher serves."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    fp32 = set()
    for arch in jlist_configs():
        jcfg = jget_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
        if jcfg.n_encoder_layers:
            continue
        shapes = jax.eval_shape(lambda k, m=JLM(jcfg): m.init_params(k), jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            if leaf.dtype == jnp.float32:
                fp32.add(path[-1].key)
            else:
                assert leaf.dtype == jnp.bfloat16, (arch, path)
    assert fp32 == set(cs.FP32_LEAVES)
