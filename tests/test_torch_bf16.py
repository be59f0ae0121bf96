"""The port at the published bfloat16, held against the JAX package on the
CPU.

Inputs are drawn with numpy from a seed and rounded to bf16 once; both
sides get the same bits (checked before anything is compared).

- The four kernels with a bf16 body (``gemm``, ``rmsnorm``,
  ``flash_attention``, ``flash_decode``): JAX's Pallas kernel in interpret
  mode, as tests/test_kernels.py runs it, against the port's wrapper on CPU
  tensors (its plain version: the kernel's fp32 arithmetic on the upcast
  inputs, rounded once).  Both sides accumulate in fp32 and round each
  output once, so an element may differ by one bf16 ulp where the two fp32
  values straddle a rounding point, plus the fp32 parity tolerance (2e-5)
  for their other summation order before the rounding.
- Reduced gemma3-1b overridden to bfloat16 on both sides, JAX's weights
  through ``params_from_numpy`` (bit for bit): prefill logits, the caches
  and 8 teacher-forced decode steps.  The two frameworks round at other
  places, so the yardstick is JAX's own bf16 against its fp32 on the same
  weights and tokens: the port may differ from JAX's bf16 by at most twice
  that.
- The port's ``ContinuousBatcher`` at bf16 on the ``cuda`` backends' plain
  versions, token-exact against its own unbatched greedy run.
- ``moe_gemm`` and ``ssd`` take bf16 on ``cuda`` too (their kernels and
  the wide decode: tests/test_torch_bf16_families.py) and raise on mixed
  types; ``serving_config`` picks each config's dtype from its ops, bf16
  for every published config.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models.lm import LM as JLM
from repro_torch.configs import get_reduced, list_configs
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gemm import gemm, gemm_plain
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch import serve
from repro_torch.models.lm import CUDA_BACKENDS, LM, params_from_numpy
from repro_torch.runtime.batching import ContinuousBatcher, Request

F32_TOL = 2e-5      # the fp32 parity tests' tolerance: another summation order
ARCH, B, S0, CAP, STEPS = "gemma3-1b", 2, 24, 40, 8


def _bf16(rng, *shape, scale=1.0):
    """(numpy bf16 array for JAX, the same bits as a torch bf16 tensor)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(a).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j).view(np.uint16),
                          t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_ulp(got: torch.Tensor, want, extra=0.0) -> float:
    """Both bf16: |got - want| <= one bf16 ulp of the larger + ``extra`` +
    F32_TOL; returns the largest difference in ulps."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    ulp = _ulp(np.maximum(np.abs(g), np.abs(w)))
    diff = np.abs(g - w)
    assert np.all(diff <= ulp + extra + F32_TOL), float(np.max(diff - ulp - extra))
    return float(np.max(diff / ulp))


# --------------------------------------------------------------------------- #
# the four kernels at bf16 against their Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m,k,n", [(4, 64, 96), (1, 300, 37), (64, 130, 40), (17, 24, 512)])
def test_gemm_bf16_against_pallas(m, k, n):
    rng = np.random.default_rng(m * k + n)
    jx, x = _bf16(rng, m, k)
    jw, w = _bf16(rng, k, n, scale=k ** -0.5)
    want = jgemm(jx, jw, interpret=True)
    got = gemm(x, w)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want)
    # the plain version is the fp32 product of the upcast operands, rounded once
    assert torch.equal(got, (x.float() @ w.float()).to(torch.bfloat16))
    assert torch.equal(got, gemm_plain(x, w))


@pytest.mark.parametrize("rows,d,residual", [(4, 64, False), (5, 96, True), (3, 30, True)])
def test_rmsnorm_bf16_against_pallas(rows, d, residual):
    rng = np.random.default_rng(rows + d)
    jx, x = _bf16(rng, rows, d)
    jw, w = _bf16(rng, d, scale=0.1)
    w, jw = w + 1.0, (jw.astype(jnp.float32) + 1.0).astype(jnp.bfloat16)
    assert np.array_equal(np.asarray(jw.astype(jnp.float32)), w.float().numpy())
    jr, r = _bf16(rng, rows, d) if residual else (None, None)
    want = jrmsnorm(jx, jw, eps=1e-6, residual=jr, interpret=True)
    got = rmsnorm(x, w, eps=1e-6, residual=r)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want)
    # the residual is added in fp32 and never rounded
    xf = x.float() if r is None else x.float() + r.float()
    assert torch.equal(got, (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
                             * w.float()).to(torch.bfloat16))


@pytest.mark.parametrize("b,sq,skv,hq,hk,d,causal,window", [
    (1, 64, 64, 4, 1, 64, True, 16),          # gemma3's MQA and a sliding window
    (2, 64, 128, 4, 2, 32, True, None),       # a query offset
    (1, 64, 64, 2, 2, 48, False, None),       # non-causal
])
def test_flash_attention_bf16_against_pallas(b, sq, skv, hq, hk, d, causal, window):
    rng = np.random.default_rng(sq + skv + d)
    jq, q = _bf16(rng, b, sq, hq, d)
    jk, k = _bf16(rng, b, skv, hk, d)
    jv, v = _bf16(rng, b, skv, hk, d)
    want = jflash_attention(jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32,
                            interpret=True)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want)
    assert torch.equal(got, fa.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                                               window=window).to(torch.bfloat16))
    # through the op: the cuda backend takes bf16, as JAX's pallas backend does
    assert torch.equal(kops.attention(q, k, v, causal=causal, window=window, backend="cuda"),
                       got)


@pytest.mark.parametrize("b,s,hq,hk,d,lens", [
    (3, 64, 4, 1, 64, (64, 17, 1)),           # gemma3's MQA group
    (2, 96, 4, 2, 32, (50, 96)),
    # the served narrow widths of the tensor-core decode body, G 1 and 4
    (2, 32, 2, 2, 112, (32, 5)), (2, 32, 4, 1, 112, (19, 32)),
    (2, 32, 2, 2, 128, (1, 32)), (2, 32, 4, 1, 128, (32, 30)),
    (1, 32, 1, 1, 256, (32,)), (2, 32, 4, 1, 256, (9, 32)),
])
def test_flash_decode_bf16_against_pallas(b, s, hq, hk, d, lens):
    rng = np.random.default_rng(s + d)
    jq, q = _bf16(rng, b, hq, d)
    jk, k = _bf16(rng, b, s, hk, d)
    jv, v = _bf16(rng, b, s, hk, d)
    lengths = np.asarray(lens, np.int32)
    want = jflash_decode(jq, jk, jv, jnp.asarray(lengths), block_kv=32, interpret=True)
    got = fd.flash_decode(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want)
    assert torch.equal(got, kops.decode_attention(q, k, v, torch.from_numpy(lengths),
                                                  backend="cuda"))


def test_combine_partials_writes_bf16():
    acc, m, l = fd.flash_decode_partial_plain(*(torch.randn(*s) for s in
                                                ((2, 3, 8), (2, 40, 1, 8), (2, 40, 1, 8))),
                                              torch.tensor([40, 7], dtype=torch.int32), 0.3, 4)
    got = fd.combine_partials(acc, m, l, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fd.combine_partials(acc, m, l).to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        fd.combine_partials(acc, m, l, dtype=torch.float16)


def test_bf16_bodies_refuse_mixed_types_and_the_wide_decode():
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        gemm(x, torch.zeros(8, 4))
    with pytest.raises(TypeError, match="all bfloat16"):
        rmsnorm(x, torch.ones(8))
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="alike"):
        fa.flash_attention(q, q.float(), q)
    with pytest.raises(TypeError, match="float32"):           # the chunk kernel: fp32 only
        fa.flash_chunk_attention(q, q, q, torch.zeros(1, dtype=torch.int32))
    # MLA's absorbed decode (D 576, Dv 512) takes the wide layout at bf16 too;
    # past the wide layout's widths bf16 refuses as fp32 does
    qd = torch.zeros(1, 4, 576, dtype=torch.bfloat16)
    kd, vd = torch.zeros(1, 8, 1, 576, dtype=torch.bfloat16), torch.zeros(1, 8, 1, 512,
                                                                         dtype=torch.bfloat16)
    out = fd.flash_decode(qd, kd, vd, torch.ones(1, dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 512)
    assert fd.decode_fits(4, 1, 576, 512) and fd.decode_fits(4, 1, 576, 512, bf16=True)
    # bf16 rings: 640 fits where fp32 stops at 596
    assert fd.decode_fits(4, 1, 640, 512, bf16=True) and not fd.decode_fits(4, 1, 640, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        fd.flash_decode(torch.zeros(1, 4, 644, dtype=torch.bfloat16),
                        torch.zeros(1, 8, 1, 644, dtype=torch.bfloat16), vd,
                        torch.ones(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="alike"):
        fd.flash_decode(qd, kd.float(), vd, torch.ones(1, dtype=torch.int32))
    # the partial kernel takes bf16 too (acc bf16, m and l fp32) and refuses mixed types
    acc, m, l = fd.flash_decode_partial(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert (acc.dtype, m.dtype, l.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    with pytest.raises(TypeError, match="alike"):
        fd.flash_decode_partial(q[:, 0], q.float(), q, torch.ones(1, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# moe_gemm and ssd at bf16, and the dtype serving_config picks
# --------------------------------------------------------------------------- #

def test_moe_gemm_and_ssd_cuda_raise_on_bf16():
    """Both now take bf16 on ``cuda`` (moe_gemm: x and w alike; ssd: x, B
    and C alike, dt and A fp32) and raise ``TypeError`` naming the kernel
    on anything else, as their supports guards say."""
    x, w = torch.zeros(2, 3, 8, dtype=torch.bfloat16), torch.zeros(2, 8, 4, dtype=torch.bfloat16)
    assert kops.moe_gemm(x, w, backend="cuda").dtype == torch.bfloat16
    with pytest.raises(TypeError, match="batched_gemm"):
        kops.moe_gemm(x, w.float(), backend="cuda")
    bs, s, h, p, g, n = 1, 16, 2, 4, 1, 8
    args = [torch.zeros(bs, s, h, p), torch.full((bs, s, h), 0.1), -torch.ones(h),
            torch.zeros(bs, s, g, n), torch.zeros(bs, s, g, n)]
    kops.ssd(*args, chunk=16, backend="cuda")                  # fp32 runs
    half = [a.to(torch.bfloat16) if i in (0, 3, 4) else a for i, a in enumerate(args)]
    y, st = kops.ssd(*half, chunk=16, backend="cuda")
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    with pytest.raises(TypeError, match="ssd"):
        kops.ssd(*[a.to(torch.bfloat16) for a in args], chunk=16, backend="cuda")
    def specs(tensors):
        return [kops.TensorSpec(tuple(a.shape), str(a.dtype)[6:]) for a in tensors]

    ssd_ok = kops.get_impl("ssd", "cuda").supports
    assert ssd_ok(specs(half) + [None], {"chunk": 16})
    assert not ssd_ok(specs(half[:4] + [args[4]]) + [None], {"chunk": 16})
    moe_ok = kops.get_impl("moe_gemm", "cuda").supports
    assert moe_ok(specs((x, w)), {}) and not moe_ok(specs((x, w.float())), {})


@pytest.mark.parametrize("arch", list_configs())
def test_serving_config_dtype_follows_the_ops(arch):
    """With ``full``, the published bfloat16 where every kernel op the
    config runs on the card has a bf16 body (every published config now:
    the MoE experts, MLA's wide absorbed decode and the Mamba2 scan have
    theirs), else fp32; reduced: fp32."""
    cfg = serve.serving_config(arch, full=True, device="cpu")
    ops = {op for op, _ in serve.kernel_ops(cfg)}
    assert ops <= kops.BF16_OPS and serve.has_bf16_bodies(cfg)
    assert (cfg.dtype, cfg.param_dtype) == ("bfloat16", "bfloat16")
    # the decision still comes from the ops: drop one of its ops' bf16 body
    # and the config serves fp32
    saved = serve.BF16_OPS
    try:
        serve.BF16_OPS = saved - {sorted(ops - {"dense", "rmsnorm"})[0]}
        assert serve.serving_config(arch, full=True, device="cpu").dtype == "float32"
    finally:
        serve.BF16_OPS = saved
    assert serve.serving_config(arch, device="cpu").dtype == "float32"


# --------------------------------------------------------------------------- #
# the slice: reduced gemma3-1b at bf16 against JAX's
# --------------------------------------------------------------------------- #

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {} if tree is None else {prefix: tree}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_run(jcfg, jparams, toks):
    """JAX's prefill logits, caches and decode logits, teacher-forced."""
    model = JLM(jcfg)
    lg, caches, lengths = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_cap=CAP))(
        jparams, jnp.asarray(toks[:, :S0]))
    out = {"prefill": [lg], "caches": list(_flat(caches).values()), "decode": []}
    step = jax.jit(model.decode_step)
    for t in range(S0, S0 + STEPS):
        lg, caches = step(jparams, jnp.asarray(toks[:, t]), caches, lengths)
        lengths = lengths + 1
        out["decode"].append(lg)
    out["caches"] += list(_flat(caches).values())
    return out


@pytest.fixture(scope="module")
def bf16_slice():
    jcfg = jget_reduced(ARCH).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    jparams = JLM(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, jparams


def test_params_from_numpy_carries_a_bf16_tree_bit_for_bit(bf16_slice):
    _, jparams = bf16_slice
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jflat, flat = _flat(jparams), _flat(params)
    assert sorted(flat) == sorted([*jflat, "/embed_t"])
    for path, leaf in jflat.items():
        assert flat[path].dtype == torch.bfloat16, path
        assert np.array_equal(flat[path].view(torch.int16).numpy().view(np.uint16),
                              np.asarray(leaf).view(np.uint16)), path
    assert flat["/embed_t"].is_contiguous()
    assert torch.equal(flat["/embed_t"].view(torch.int16), flat["/embed"].t().view(torch.int16))


def test_reduced_gemma3_bf16_within_twice_jax_own_bf16_error(bf16_slice):
    jcfg, jparams = bf16_slice
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    jax_bf16 = _jax_run(jcfg, jparams, toks)
    # JAX's fp32 on the same (upcast) weights: the yardstick
    jax_f32 = _jax_run(jcfg.with_overrides(dtype="float32", param_dtype="float32"),
                       jax.tree.map(lambda a: a.astype(jnp.float32), jparams), toks)

    cfg = get_reduced(ARCH).with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                           backends=CUDA_BACKENDS)
    model = LM(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    lg, caches, lengths = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S0])},
                                        cache_cap=CAP)
    port = {"prefill": [lg], "caches": list(_flat(caches).values()), "decode": []}
    for t in range(S0, S0 + STEPS):
        lg, caches = model.decode_step(params, torch.from_numpy(toks[:, t]), caches, lengths)
        lengths = lengths + 1
        port["decode"].append(lg)
    port["caches"] += list(_flat(caches).values())

    for part in ("prefill", "caches", "decode"):
        assert len(port[part]) == len(jax_bf16[part])
        assert all(p.dtype == torch.bfloat16 for p in port[part]), part
        gap = max(float(np.max(np.abs(_f32(a) - _f32(b))))
                  for a, b in zip(jax_bf16[part], jax_f32[part]))
        diff = max(float(np.max(np.abs(_f32(a) - _f32(b))))
                   for a, b in zip(port[part], jax_bf16[part]))
        assert 0.0 < gap and diff <= 2.0 * gap, (part, diff, gap)


def test_batcher_at_bf16_is_token_exact_against_its_unbatched_run():
    cfg = get_reduced(ARCH).with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                           backends=CUDA_BACKENDS)
    model = LM(cfg)
    params = model.init_params(0, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
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


def test_bf16_entries_take_at_most_the_fp32_shared_memory():
    """The bf16 decode ring holds 2-byte values (csrc/flash_decode.cu
    decode_smem_bytes_bf16), so every width the fp32 decode fits, the bf16
    one fits; at gemma3-1b's D = Dv = 256 a decode block takes 56 KB (104
    fp32).  The bf16 attention body (csrc/flash_attention.cu tc_smem_bytes:
    Q, K and V as [64][64] bf16 panels and 1 KB of alignment) takes 97 KB
    there (209 fp32), at most the fp32 body's at every served width, and
    fits the H100's limit at every width the fp32 body fits (at D, Dv <= 8
    its whole panels take up to 1 KB more than the fp32 tiles)."""
    assert fd.decode_smem_bytes(256, 256, bf16=True) == 57344
    assert fd.decode_smem_bytes(256, 256) == 106496
    assert fa.attention_smem_bytes(256, 256, bf16=True) == 99328
    assert fa.attention_smem_bytes(256, 256) == 214016
    for d, dv in ((256, 256), (96, 96), (64, 64), (4, 256), (30, 30), (6, 10), (128, 64)):
        assert fd.decode_smem_bytes(d, dv, bf16=True) <= fd.decode_smem_bytes(d, dv)
    for d, dv in ((256, 256), (96, 96), (64, 64), (128, 128), (112, 112), (192, 128),
                  (4, 256), (30, 30), (128, 64)):
        assert fa.attention_smem_bytes(d, dv, bf16=True) <= fa.attention_smem_bytes(d, dv)
    for d in range(1, 257, 5):
        for dv in range(1, 257, 7):
            if fa.attention_smem_bytes(d, dv) <= _cuda.MAX_SMEM_BYTES:
                assert fa.attention_smem_bytes(d, dv, bf16=True) <= _cuda.MAX_SMEM_BYTES
    src = (Path(repro_torch.__file__).parent / "csrc")
    assert "decode_smem_bytes_bf16(D, Dv)" in (src / "flash_decode.cu").read_text()
    assert ("1024 + (size_t)TC_PANEL * (2 * panels64(D) + panels64(Dv))"
            in (src / "flash_attention.cu").read_text())
