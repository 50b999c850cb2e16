"""The port's sharding rule engine against the JAX package's.

``repro_torch.parallel.sharding`` copies the greedy, divisibility-checked
rule engine; its specs are plain tuples where the JAX package's are
``PartitionSpec``s.  On stub meshes (only ``.shape`` is read) of the
production geometry, ``{data: 16, model: 16}`` and ``{pod: 2, data: 16,
model: 16}``, and of the serving meshes ``{data: 1, model: 2}`` and
``{data: 1, model: 4}``, under the default table (FSDP + TP) and the serving
table (TP only), the port's spec of every parameter, paged-cache leaf and
logits tensor of every registered arch equals the JAX package's
``make_rules(...)`` output, tensor for tensor (the JAX package stacks the
layers on a leading axis, which no rule shards: its block specs carry one
more ``None`` in front, two for the vlm self layers).  Hypothesis cases
hold ``spec_for`` equal on random logical axes and dims, as
``test_sharding.py`` holds its invariants.  Then the executed layout: which
tensors the port keeps replicated where the table claims the model axis,
and ``shard_params`` cutting slices whose concatenation is the full tensor.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.config import MeshConfig as JaxMeshConfig, ParallelConfig as JaxParallelConfig
from repro.configs import get_config as jax_get_config
from repro.models import abstract_params, param_logical_axes
from repro.models.cache import init_paged_cache as jax_init_paged_cache, paged_cache_axes as jax_paged_cache_axes
from repro.models.cache import supports_paged
from repro.parallel import make_rules as jax_make_rules
from repro_torch.config import MeshConfig, ParallelConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import param_specs
from repro_torch.models.cache import paged_cache_layout
from repro_torch.parallel import make_rules
from repro_torch.parallel.sharding import attention_layout, executed_specs, replicated_claims, shard_params
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(2)


@dataclass
class StubMesh:
    shape: dict


MESHES = {
    "16x16": StubMesh({"data": 16, "model": 16}),
    "2x16x16": StubMesh({"pod": 2, "data": 16, "model": 16}),
    "1x2": StubMesh({"data": 1, "model": 2}),
    "1x4": StubMesh({"data": 1, "model": 4}),
}
TABLES = {"default": {}, "serving": dict(fsdp=False, tensor_parallel=True)}
ARCH_NAMES = sorted(ARCHS.names())


def _rules(mesh_name, table):
    multi = mesh_name == "2x16x16"
    return (jax_make_rules(JaxMeshConfig(multi_pod=multi), JaxParallelConfig(**TABLES[table])),
            make_rules(MeshConfig(multi_pod=multi), ParallelConfig(**TABLES[table])))


def _jax_leaf(tree, path):
    """The JAX tree's counterpart of a port path, and the leading entries
    the JAX spec carries for the stacked layer axes."""
    if path[0] != "blocks":
        node, skip = tree, 0
        for k in path:
            node = node[k]
        return node, skip
    rest, skip = path[2:], 1
    if rest[0] == "self" and isinstance(rest[1], int):  # a vlm group's self layers
        rest, skip = ("self",) + rest[2:], 2
    node = tree["blocks"]
    for k in rest:
        node = node[k]
    return node, skip


def test_production_meshes_are_shapes_alone():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_jax(arch, mesh_name, table):
    mesh = MESHES[mesh_name]
    jr, tr = _rules(mesh_name, table)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jspecs = jr.tree_specs(param_logical_axes(jcfg), abstract_params(jcfg), mesh, jr.param_rules())
    tspecs = tr.param_shardings(tcfg, mesh)
    shapes = param_specs(tcfg)
    paths = tree_paths(tspecs)
    assert len(paths) > 0
    for path, spec, ps in zip(paths, tree_leaves(tspecs), tree_leaves(shapes)):
        jspec, skip = _jax_leaf(jspecs, path)
        assert tuple(jspec)[:skip] == (None,) * skip, (arch, path, jspec)
        assert tuple(jspec)[skip:] == spec, (arch, mesh_name, table, path, jspec, spec)
        assert len(spec) == len(ps.shape)


@pytest.mark.parametrize("quantized", [False, "int8"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if supports_paged(jax_get_config(a))])
def test_paged_cache_and_logits_specs_equal_jax(arch, mesh_name, quantized):
    mesh = MESHES[mesh_name]
    jr, tr = _rules(mesh_name, "serving")
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    N, bs, B, nb = 33, 16, 4, 8
    jcache = jax.eval_shape(lambda: jax_init_paged_cache(jcfg, N, bs, B, nb, jnp.float32, quantized=quantized))
    jspecs = jr.tree_specs(jax_paged_cache_axes(jcfg, quantized=quantized), jcache, mesh, jr.cache_rules())
    lay = paged_cache_layout(tcfg, N, bs, B, nb, torch.float32, quantized=quantized)
    cache = {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in lay.items()}
    tspecs = tr.paged_cache_shardings(tcfg, mesh, cache)
    assert set(tspecs) == set(jspecs)
    for name, spec in tspecs.items():
        # the JAX package stacks a block table per layer, the port keeps one
        want = tuple(jspecs[name])[1:] if name == "tbl" else tuple(jspecs[name])
        assert spec == want, (arch, name, spec, want)
    for ndim in (2, 3):
        jlog = jr.spec_for((None,) * (ndim - 1) + ("vocab",), (1,) * (ndim - 1) + (jcfg.padded_vocab,), mesh,
                           jr.act_rules())
        assert tr.logits_sharding(tcfg, mesh, ndim) == tuple(jlog)


AXIS_NAMES = ["embed", "mlp", "heads", "kv_heads", "vocab", "expert", "expert_mlp", "head_dim", "batch", "kv_seq",
              "ssm_inner", "embed_v", None]


@settings(max_examples=200, deadline=None)
@given(
    dims=st.lists(st.integers(min_value=1, max_value=8192), min_size=1, max_size=4),
    axes=st.lists(st.sampled_from(AXIS_NAMES), min_size=1, max_size=4),
    mesh_name=st.sampled_from(sorted(MESHES)),
    table=st.sampled_from(sorted(TABLES)),
    which=st.sampled_from(["param_rules", "act_rules", "cache_rules"]),
)
def test_spec_for_equals_jax(dims, axes, mesh_name, table, which):
    n = min(len(dims), len(axes))
    dims, axes = tuple(dims[:n]), tuple(axes[:n])
    jr, tr = _rules(mesh_name, table)
    mesh = MESHES[mesh_name]
    assert tr.spec_for(axes, dims, mesh, getattr(tr, which)()) == tuple(
        jr.spec_for(axes, dims, mesh, getattr(jr, which)())
    )


def test_executed_layout():
    """What the port keeps replicated where the table claims the model
    axis at TP=2: nothing of olmo-1b (its norms have no parameters);
    mistral-nemo's norm scales (the embed fallback); hymba, whose 25 heads
    do not divide, its attention (the embed fallback of wq/wo) and its SSM
    heads besides; qwen3-moe its router.  At a model axis of 16, the
    query heads split where they divide it, whatever the kv heads do."""
    mesh = MESHES["1x2"]
    assert replicated_claims(get_config("olmo-1b"), mesh) == {}
    nemo = replicated_claims(get_config("mistral-nemo-12b"), mesh)
    assert nemo and all(p.endswith("scale") for p in nemo), nemo
    hymba = replicated_claims(get_config("hymba-1.5b"), mesh)
    assert "blocks/0/attn/wq" in hymba and "blocks/0/attn/wo" in hymba and "blocks/0/ssm/in_proj" in hymba
    assert "blocks/0/mlp/w_up" not in hymba  # its FFN hidden dim shards
    qwen = replicated_claims(get_config("qwen3-moe-235b-a22b"), mesh)
    assert "blocks/0/moe/router" in qwen and "blocks/0/moe/w_up" not in qwen
    spec = executed_specs(get_config("mistral-nemo-12b"), mesh)["executed"]
    assert spec["embed"]["tok"] == ("model", None) and spec["lm_head"] == (None, "model")
    assert spec["blocks"][0]["attn"]["wk"] == (None, "model", None)
    assert spec["blocks"][0]["mlp"]["w_down"] == ("model", None)
    # at a model axis of 16 the query heads of qwen3-moe (64 over 4) and
    # mistral-nemo (32 over 8) split while their kv heads stay whole (the
    # "grouped" layout); arctic's 56 and hymba's 25 do not divide: replicated
    wide = StubMesh({"data": 1, "model": 16})
    for arch, layout in (("qwen3-moe-235b-a22b", "grouped"), ("mistral-nemo-12b", "grouped"),
                         ("arctic-480b", "whole"), ("hymba-1.5b", "whole")):
        cfg = get_config(arch)
        assert attention_layout(wide, cfg.num_heads, cfg.num_kv_heads)[0] == layout, arch
        attn = executed_specs(cfg, wide)["executed"]["blocks"][0]["attn"]
        split = layout == "grouped"
        assert attn["wq"] == (None, "model" if split else None, None), arch
        assert attn["wo"] == ("model" if split else None, None, None), arch
        assert attn["wk"] == attn["wv"] == (None, None, None), arch
        claims = replicated_claims(cfg, wide)
        assert ("blocks/0/attn/wq" in claims) != split and "blocks/0/attn/wk" in claims, arch


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b"])
def test_shard_params_slices_concatenate(arch):
    from repro_torch.config import reduce_for_smoke
    from repro_torch.models import init_params

    cfg = reduce_for_smoke(get_config(arch))
    params = init_params(cfg, 0, device="cpu")

    class Rank:  # a (1, 2) mesh seen from one rank
        mesh_dim_names, shape = ("data", "model"), (1, 2)

        def __init__(self, r):
            self.r = r

        def get_local_rank(self, name):
            return self.r

    specs = executed_specs(cfg, Rank(0))["executed"]
    slices = [shard_params(cfg, params, specs, Rank(r)) for r in (0, 1)]
    for full, a, b, spec in zip(*(tree_leaves(t) for t in (params, *slices, specs))):
        if "model" in spec:
            dim = spec.index("model")
            assert torch.equal(torch.cat([a, b], dim=dim), full)
        else:
            assert a is full and b is full


def test_autotune_key_reads_the_local_heads(monkeypatch):
    """K1/K2's table key comes from the tensors a call gets: on a rank of
    mistral-nemo-12b at TP=4 (8 of 32 query heads, 2 of 8 kv heads) it
    reads the local shapes, whose query heads per kv head stay 4."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attention as K

    seen = []
    monkeypatch.setattr(autotune, "get_config", lambda *key: seen.append(key) or autotune.DEFAULT_CONFIG)
    q = torch.zeros((4, 8, 128))
    pool = torch.zeros((33, 32, 2, 128), dtype=torch.bfloat16)
    K.tuned_config(q, pool, torch.zeros((4, 16), dtype=torch.int32))
    assert seen == [(128, 32, 16, torch.bfloat16, 4)]
