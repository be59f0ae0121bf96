"""The port's partition rules (``repro_torch.sharding.specs``), the
`partition` compile stage and partitioned OXF bundles, against the JAX
package, in-process (no process group: the rules read only a mesh's
``axis_names`` and ``shape``, so both packages take the same duck-typed
mesh, as tests/test_partition_specs.py does).

Mirrors tests/test_partition_specs.py on the port, and holds to JAX's:
``graph_partition_specs`` and ``partition_roles`` on every serving graph
(dense, paged fp32 and int8, verify, draft, spec commit) for tp 1/2/4 and
Hk 1/2/4; ``param_specs`` / ``cache_specs`` / ``batch_specs`` /
``opt_state_specs`` on reduced configs' parameter and cache trees;
``compile(mesh=)`` freezing the partition; partitioned bundles written by
either package and loaded by the other, ``program.json`` byte-identical, a
re-save byte-stable and a wrong mesh raising ``ValueError``.  Specs are
compared in their JSON form (JAX's ``PartitionSpec`` is not a tuple).
"""

import functools
import json
import os
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro  # noqa: F401  (registers every op/backend)
import repro_torch  # noqa: F401
from repro.core import passes as jpasses
from repro.core.program import Program as JProgram
from repro.core.program import compile as jcompile
from repro.core.selector import FixedPolicy as JFixed
from repro.models import graph_lm as jlm
from repro.sharding import specs as jspecs
from repro_torch.core import FixedPolicy, Program, compile, load_program
from repro_torch.core import passes as tpasses
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import graph_lm as tlm
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.specs import P


def fake_mesh(**axes):
    """Duck-typed mesh: the spec rules only read axis_names and shape."""
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


MESH2 = fake_mesh(data=1, model=2)
J_REF, T_REF = JFixed(prefer=("ref",)), FixedPolicy(prefer=("ref",))


def _leaf(shape):
    return types.SimpleNamespace(shape=tuple(shape))


def js(spec):
    """A spec of either package in its JSON form."""
    return tspecs.partition_spec_to_json(spec)


# --------------------------------------------------------------------------- #
# tests/test_partition_specs.py on the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("hk", [1, 2, 4])
def test_cache_specs_paged_pool_divides_or_replicates(hk):
    tree = {"l0": {"pages_k": _leaf((10, 4, hk, 8)), "pages_v": _leaf((10, 4, hk, 8)),
                   "pages_k_scale": _leaf((10, hk)), "pages_v_scale": _leaf((10, hk))}}
    specs = tspecs.cache_specs(tree, None, MESH2, batch=3)
    want_axis = "model" if hk % 2 == 0 else None
    assert specs["l0"]["pages_k"] == P(None, None, want_axis, None)
    assert specs["l0"]["pages_v"] == P(None, None, want_axis, None)
    assert specs["l0"]["pages_k_scale"] == P(None, want_axis)
    assert specs["l0"]["pages_v_scale"] == P(None, want_axis)


def test_cache_specs_paged_pool_never_batch_sharded():
    mesh = fake_mesh(data=2, model=2)
    specs = tspecs.cache_specs({"pages_k": _leaf((4, 4, 2, 8))}, None, mesh, batch=3)
    assert specs["pages_k"] == P(None, None, "model", None)


def test_serving_value_role_classification():
    role = tspecs.serving_value_role
    assert role("l0.wq", (32, 32)) == "col"
    assert role("l1.wg", (32, 64)) == "col"
    assert role("l0.wk", (32, 16)) == "kv_col"
    for name in ("l0.wo", "l0.wd", "embed", "head_w", "l0.norm1", "final_norm", "logits"):
        assert role(name, (32, 32)) == "replicated", name
    for name in ("tokens", "start", "n_new", "block_tables"):
        assert role(name, (3,)) == "replicated", name
    assert role("cache_k0", (3, 16, 2, 8)) == "dense_cache"
    assert role("cache_k0", (10, 4, 2, 8), paged=True) == "paged_pool"
    assert role("cache_v1_scale", (10, 2), paged=True) == "kv_scale"
    assert role("new_cache_k0", (3, 16, 2, 8)) == "dense_cache"


def test_partition_roles_covers_every_graph_value():
    cfg = tlm.GraphLMConfig(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64)
    g = tlm.build_paged_decode_graph(cfg, tlm.init_lm_params(cfg), batch=2, n_blocks=8,
                                     page_size=4, max_pages=4, kv_dtype="int8")
    roles = tlm.partition_roles(g)
    for name in list(g.inputs) + list(g.outputs):
        assert name in roles, name
    assert roles["cache_k0"] == "paged_pool"
    assert roles["cache_k0_scale"] == "kv_scale"
    assert roles["new_cache_v1"] == "paged_pool"
    assert roles["block_tables"] == "replicated"
    assert roles["logits"] == "replicated"


@pytest.mark.parametrize("hk,want", [(1, None), (2, "model"), (4, "model")])
def test_graph_specs_gqa_fallback(hk, want):
    cfg = tlm.GraphLMConfig(vocab=61, d_model=32, n_layers=1, n_heads=4, n_kv_heads=hk,
                            d_ff=64)
    g = tlm.build_decode_graph(cfg, tlm.init_lm_params(cfg), batch=2, cache_cap=16)
    specs = tspecs.graph_partition_specs(tpasses.infer_shapes(g), MESH2)
    assert specs["cache_k0"] == (P(None, None, "model", None) if want else P())
    assert specs["new_cache_k0"] == specs["cache_k0"]
    assert specs["l0.wq"] == P(None, "model")
    assert specs["l0.wk"] == (P(None, "model") if want else P())
    assert specs["l0.wo"] == P()
    assert specs["tokens"] == P()
    assert specs["logits"] == P()


def test_compile_mesh_stamps_frozen_partition():
    cfg = tlm.GraphLMConfig(vocab=61, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                            d_ff=64)
    g = tlm.build_paged_decode_graph(cfg, tlm.init_lm_params(cfg), batch=2, n_blocks=8,
                                     page_size=4, max_pages=4, kv_dtype="int8")
    prog = compile(g, mesh=MESH2, device="cpu")
    part = prog.partition
    assert dict(part["mesh"]) == {"data": 1, "model": 2}
    assert part["specs"]["cache_k0"] == P(None, None, "model", None)
    assert part["specs"]["cache_k0_scale"] == P(None, "model")
    with pytest.raises(TypeError):
        part["specs"]["cache_k0"] = P()
    for name in list(g.inputs) + list(g.outputs):
        assert name in part["specs"], name
    assert prog.pass_stats[-1].name == "partition"


def test_unpartitioned_compile_has_no_partition():
    cfg = tlm.GraphLMConfig(vocab=61, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                            d_ff=64)
    g = tlm.build_decode_graph(cfg, tlm.init_lm_params(cfg), batch=2, cache_cap=16)
    assert compile(g, device="cpu").partition is None


def test_check_mesh_compat():
    rec = tspecs.mesh_axes(MESH2)
    tspecs.check_mesh_compat(rec, fake_mesh(model=2, data=1))     # order-free match
    with pytest.raises(ValueError, match="mesh axes"):
        tspecs.check_mesh_compat(rec, fake_mesh(data=1, model=4))
    with pytest.raises(ValueError, match="re-partition"):
        tspecs.check_mesh_compat(rec, fake_mesh(model=2))
    # the port's own meshes are meshes to the rules too
    assert tspecs.mesh_axes(make_test_mesh(1, 2)) == rec


# --------------------------------------------------------------------------- #
# every serving graph: the port's specs and roles equal JAX's
# --------------------------------------------------------------------------- #

KINDS = ["decode", "prefill", "paged_decode", "paged_prefill", "paged_decode_int8",
         "paged_prefill_int8", "verify", "paged_verify", "paged_verify_seq_int8", "draft",
         "spec_commit"]


@functools.lru_cache(maxsize=None)
def graphs(kind, hk):
    """(port graph, JAX graph) of one serving graph kind, shapes inferred."""
    out = []
    for pkg, infer in ((tlm, tpasses.infer_shapes), (jlm, jpasses.infer_shapes)):
        cfg = pkg.GraphLMConfig(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=hk,
                                d_ff=64)
        params = jlm.init_lm_params(jlm.GraphLMConfig(vocab=61, d_model=32, n_layers=2,
                                                      n_heads=4, n_kv_heads=hk, d_ff=64))
        paged = dict(batch=2, n_blocks=8, page_size=4, max_pages=4)
        kv8 = dict(kv_dtype="int8") if kind.endswith("_int8") else {}
        base = kind.replace("_int8", "")
        if base == "decode":
            g = pkg.build_decode_graph(cfg, params, batch=2, cache_cap=16)
        elif base == "prefill":
            g = pkg.build_prefill_graph(cfg, params, batch=2, chunk=4, cache_cap=16)
        elif base == "paged_decode":
            g = pkg.build_paged_decode_graph(cfg, params, **paged, **kv8)
        elif base == "paged_prefill":
            g = pkg.build_paged_prefill_graph(cfg, params, chunk=4, **paged, **kv8)
        elif base == "verify":
            g = pkg.build_verify_graph(cfg, params, batch=2, width=3, cache_cap=16)
        elif base == "paged_verify":
            g = pkg.build_paged_verify_graph(cfg, params, width=3, **paged)
        elif base == "paged_verify_seq":
            g = pkg.build_paged_verify_seq_graph(cfg, params, width=3, **paged)
        elif base == "draft":
            g = pkg.build_draft_graph(cfg, params, batch=2, cache_cap=16, spec_k=2)
        else:
            g = pkg.build_spec_commit_graph(cfg, width=3, **paged)
        out.append(infer(g))
    return tuple(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hk", [1, 2, 4])
def test_graph_partition_specs_equal_jax(kind, hk):
    tg, jg = graphs(kind, hk)
    for tp in (1, 2, 4):
        mesh = fake_mesh(model=tp)
        got = {n: js(s) for n, s in tspecs.graph_partition_specs(tg, mesh).items()}
        want = {n: js(s) for n, s in jspecs.graph_partition_specs(jg, mesh).items()}
        assert got == want, (kind, hk, tp)
        sharded = any("model" in s for n, s in got.items() if n.startswith("cache_"))
        has_cache = any(n.startswith("cache_") for n in tg.inputs)
        assert sharded == (has_cache and hk % tp == 0), (kind, hk, tp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hk", [1, 2])
def test_cache_writes_slice_rows_where_their_cache_is_sharded(kind, hk):
    """tp_write_slices, from the partition specs alone: every cache write
    of a graph whose caches shard on "model" takes its rows' head slice —
    also a write into a cache an earlier write produced (the spec commit
    writes each cache once a stage) — and no other node does; with Hk = 1
    on two ranks (GQA-small: whole caches) no node does."""
    from repro_torch.core.ir import topological_order
    from repro_torch.kernels.serving_ops import tp_write_slices
    tg, _ = graphs(kind, hk)
    order = topological_order(tg)
    rows = tp_write_slices(order, tspecs.graph_partition_specs(tg, fake_mesh(model=2)))
    writes = {"cache_update": 1, "paged_cache_update": 1, "paged_cache_update_q": 2}
    want = [(writes[n.op], 2) if n.op in writes and hk == 2 else None for n in order]
    assert rows == want
    assert any(rows) == (hk == 2 and any(n.op in writes for n in order))


@pytest.mark.parametrize("kind", KINDS)
def test_partition_roles_equal_jax(kind):
    tg, jg = graphs(kind, 2)
    assert tlm.partition_roles(tg) == jlm.partition_roles(jg)


# --------------------------------------------------------------------------- #
# the parameter / cache / batch / optimizer rules on reduced configs
# --------------------------------------------------------------------------- #

def _flat_jax(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(path): js(spec) for path, spec in leaves}


def _flat_port(tree, like):
    """The port's spec tree in the key strings of ``like`` (JAX's tree of
    the same structure)."""
    paths, _ = jax.tree_util.tree_flatten_with_path(like)
    out = {}
    for path, _leaf_ in paths:
        node = tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        out[jax.tree_util.keystr(path)] = js(node)
    return out


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b", "mamba2-370m"])
def test_param_cache_batch_specs_equal_jax(arch):
    from repro.configs import get_reduced
    from repro.models.lm import LM
    cfg = get_reduced(arch)
    model = LM(cfg)
    p_shape = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    c_shape = jax.eval_shape(lambda: model.init_caches(2, 16))
    shapes_only = jax.tree_util.tree_map(lambda s: tuple(s.shape), p_shape)
    for mesh in (fake_mesh(data=2, model=2), fake_mesh(model=4), fake_mesh(data=4, model=1),
                 fake_mesh(pod=2, data=2, model=2)):
        jp = jspecs.param_specs(p_shape, cfg, mesh)
        want = _flat_jax(jp)
        assert _flat_port(tspecs.param_specs(p_shape, cfg, mesh), p_shape) == want
        assert _flat_port(tspecs.param_specs(shapes_only, cfg, mesh), p_shape) == want
        tp_spec = tspecs.param_specs(p_shape, cfg, mesh)
        assert _flat_port(tspecs.opt_state_specs(p_shape, tp_spec, mesh), p_shape) == \
            _flat_jax(jspecs.opt_state_specs(p_shape, jp, mesh))
        for batch in (1, 2):
            assert _flat_port(tspecs.cache_specs(c_shape, cfg, mesh, batch), c_shape) == \
                _flat_jax(jspecs.cache_specs(c_shape, cfg, mesh, batch))
        assert _flat_port(tspecs.batch_specs(c_shape, mesh), c_shape) == \
            _flat_jax(jspecs.batch_specs(c_shape, mesh))


# --------------------------------------------------------------------------- #
# partitioned bundles across the packages
# --------------------------------------------------------------------------- #

def _read(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["decode", "paged_prefill_int8"])
def test_partitioned_bundles_cross_the_packages(kind, tmp_path):
    """JAX's compile(mesh=) saves, the port loads it with the partition
    verbatim and re-saves byte for byte; the port's own compile(mesh=)
    writes JAX's program.json and model.json byte for byte and JAX loads
    it; a bundle with no partition is partitioned fresh on load; another
    mesh raises ValueError."""
    tg, jg = graphs(kind, 2)
    mesh = fake_mesh(data=1, model=2)
    jprog = jcompile(jg, J_REF, mesh=mesh)
    a, b, c = (str(tmp_path / x) for x in "abc")
    jprog.save(a)
    prog = load_program(a, mesh=mesh, device="cpu")
    assert {n: js(s) for n, s in prog.partition["specs"].items()} == \
        {n: js(s) for n, s in jprog.partition["specs"].items()}
    assert dict(prog.partition["mesh"]) == dict(jprog.partition["mesh"])
    prog.save(b)
    for name in ("model.json", "program.json"):
        assert _read(a, name) == _read(b, name), name
    tprog = compile(tg, T_REF, mesh=mesh, device="cpu")
    tprog.save(c)
    for name in ("model.json", "program.json"):
        assert _read(a, name) == _read(c, name), name
    back = JProgram.load(c, mesh=mesh)
    assert back.partition["specs"].keys() == jprog.partition["specs"].keys()
    assert json.loads(_read(c, "program.json"))["partition"]["mesh"] == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="mesh axes"):
        load_program(a, mesh=fake_mesh(data=1, model=4), device="cpu")
    # no partition in the bundle: the mesh partitions it fresh, as JAX's load
    plain = str(tmp_path / "plain")
    jcompile(jg, J_REF).save(plain)
    fresh = Program.load(plain, mesh=mesh, device="cpu")
    assert {n: js(s) for n, s in fresh.partition["specs"].items()} == \
        {n: js(s) for n, s in JProgram.load(plain, mesh=mesh).partition["specs"].items()}
    assert load_program(plain, device="cpu").partition is None


def test_partition_spec_json_round_trip():
    for spec in (P(), P(None, "model"), P(("pod", "data"), None), P("model", None, None)):
        entries = tspecs.partition_spec_to_json(spec)
        assert tspecs.partition_spec_from_json(json.loads(json.dumps(entries))) == spec
        assert entries == js(JP(*spec))
    assert np.array_equal(np.asarray(P(None, "model"), dtype=object),
                          np.asarray([None, "model"], dtype=object))
