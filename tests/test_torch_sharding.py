"""The port's sharding plans and mesh rules against the JAX package's.

Plans are bookkeeping, so they are held exactly: the port's spec equals
``tuple()`` of the JAX spec for the same name and shape, on the cases of
``tests/test_sharding_plans.py`` and ``tests/test_materialize_jax.py``.
The mesh rules take a JAX ``Mesh`` on the JAX side and a ``MeshSpec`` of
the same shape on the port's (a ``DeviceMesh`` needs a process group; the
multi-process tests are in ``test_torch_materialize_dist.py``).
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.parallel import mesh as jmesh
from torchdistx_tpu.parallel import sharding as jsh
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.parallel import mesh as tmesh
from torchdistx_tpu_torch.parallel import sharding as tsh

NAMES_SHAPES = [
    ("transformer.h.0.attn.c_attn.weight", (768, 2304)),
    ("transformer.h.0.attn.c_attn.bias", (2304,)),
    ("transformer.h.0.attn.c_proj.weight", (768, 768)),
    ("transformer.h.0.attn.c_proj.bias", (768,)),
    ("transformer.h.0.mlp.c_fc.weight", (768, 3072)),
    ("transformer.wte.weight", (50257, 768)),
    ("transformer.wpe.weight", (1024, 768)),
    ("transformer.h.0.ln_1.weight", (768,)),
    ("model.layers.0.self_attn.q_proj.weight", (4096, 4096)),
    ("model.layers.0.self_attn.o_proj.weight", (4096, 4096)),
    ("model.layers.0.mlp.down_proj.weight", (4096, 11008)),
    ("model.layers.0.mlp.up_proj.weight", (11008, 4096)),
    ("model.embed_tokens.weight", (32000, 4096)),
    ("lm_head.weight", (32000, 4096)),
    ("model.norm.weight", (4096,)),
    ("model.other.weight", (4096, 64)),
    ("layers.0.q_proj.weight", (64, 64)),
    ("small.bias", (16,)),
    ("scalar", ()),
]

PLANS = {
    "replicated": lambda m: m.replicated_plan(),
    "fsdp": lambda m: m.fsdp_plan(),
    "fsdp_min1": lambda m: m.fsdp_plan(min_size=1),
    "fsdp_dim0": lambda m: m.fsdp_plan("dp", largest_dim=False),
    "tp_gpt2": lambda m: m.tp_plan_gpt2(),
    "tp_llama": lambda m: m.tp_plan_llama("mp"),
    "fsdp_over_tp": lambda m: m.fsdp_over(m.tp_plan_llama()),
    "fsdp_over_tp_min1": lambda m: m.fsdp_over(m.tp_plan_llama(), min_size=1),
    "combined": lambda m: m.combine_plans(m.tp_plan_llama(), m.fsdp_plan(min_size=1)),
    "combined_gpt2": lambda m: m.combine_plans(m.tp_plan_gpt2(), m.fsdp_plan()),
}


def _same(port_spec, jax_spec):
    if jax_spec is None:
        assert port_spec is None
        return
    assert isinstance(port_spec, tsh.PartitionSpec)
    assert port_spec == tuple(jax_spec), (port_spec, jax_spec)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plans_match_jax(plan):
    jplan, tplan = PLANS[plan](jsh), PLANS[plan](tsh)
    for name, shape in NAMES_SHAPES:
        _same(tplan(name, shape), jplan(name, shape))


def test_combine_plans_honors_explicit_replication():
    plan = tsh.combine_plans(tsh.tp_plan_llama(), tsh.fsdp_plan(min_size=1))
    assert plan("model.norm.weight", (4096,)) == ()
    assert plan("model.other.weight", (4096, 64)) == ("fsdp", None)


def test_fsdp_over_tp_2d():
    plan = tsh.fsdp_over(tsh.tp_plan_llama())
    assert plan("model.layers.0.self_attn.q_proj.weight", (4096, 4096)) == ("tp", "fsdp")
    assert plan("model.norm.weight", (4096,)) == ("fsdp",)


def test_partition_spec_normalises_one_name_tuples():
    assert tsh.PartitionSpec(("dp",), None) == tuple(JP(("dp",), None)) == ("dp", None)
    assert tsh.PartitionSpec(("dp", "fsdp")) == tuple(JP(("dp", "fsdp")))
    assert tsh.PartitionSpec(None) == tuple(JP(None)) and tsh.PartitionSpec() == ()


FIT_CASES = [
    (dict(dp=8), ("fsdp", "tp")),
    (dict(dp=8), (("dp", "fsdp"), None)),
    (dict(fsdp=2, tp=4), (("dp", "fsdp"), "tp")),
    (dict(dp=2, tp=4), ("tp", None, ("dp", "sp"))),
    (dict(fsdp=8), (None, "fsdp")),
]


@pytest.mark.parametrize("axes, spec", FIT_CASES)
def test_fit_spec_to_mesh_matches_jax(axes, spec):
    jm = jmesh.make_mesh(jmesh.MeshSpec(**axes))
    got = tsh.fit_spec_to_mesh(tsh.PartitionSpec(*spec), tmesh.MeshSpec(**axes))
    _same(got, jsh.fit_spec_to_mesh(JP(*spec), jm))


@pytest.mark.parametrize("spec, shape", [(("tp",), (9,)), (("tp",), (10,)), (("tp",), (9, 5)),
                                         ((None, "tp"), (4, 6))])
def test_replicate_indivisible_matches_jax(spec, shape):
    jm = jmesh.make_mesh(jmesh.MeshSpec(tp=3), devices=jax.devices()[:3])
    got = tsh.replicate_indivisible(tsh.PartitionSpec(*spec), shape, tmesh.MeshSpec(tp=3))
    _same(got, jsh.replicate_indivisible(JP(*spec), shape, jm))


@pytest.mark.parametrize("axes", [dict(), dict(dp=2, fsdp=2, tp=2), dict(tp=4, fsdp=2),
                                  dict(ep=2, sp=2, pp=2)])
def test_mesh_spec_axes_match_jax(axes):
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    spec, jspec = tmesh.MeshSpec(**axes), jmesh.MeshSpec(**axes)
    assert spec.axes() == jspec.axes() and spec.size == jspec.size


def test_llama_param_specs_match_jax_leaf_by_leaf():
    # The JAX leaves are stacked (L, in, out); the port's weights are (out,
    # in), one per layer: drop the layer entry, swap the matrix dims.
    cfg = tllama.llama_test()
    jspecs = jllama.param_specs(jllama.llama_test())
    tspecs = tllama.param_specs(cfg)
    transposed = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}

    def want(jspec, layered, transpose):
        entries = list(jspec)[1:] if layered else list(jspec)
        if transpose:
            entries = entries[::-1]
        return tuple(entries)

    expected = {
        "embed.weight": want(jspecs["embed"]["weight"], False, False),
        "norm.weight": want(jspecs["norm"]["weight"], False, False),
        "lm_head.weight": want(jspecs["lm_head"]["weight"], False, True),
    }
    for i in range(cfg.n_layers):
        for key, jspec in jspecs["layers"].items():
            expected[f"layers.{i}.{key}.weight"] = want(jspec, True, key in transposed)
    model = tllama.Llama(cfg, device="meta")
    assert set(tspecs) == set(expected) == {n for n, _ in model.named_parameters()}
    for name, spec in tspecs.items():
        assert spec == expected[name], name
    # Custom axis names reach every sharded entry.
    custom = tllama.param_specs(cfg, tp="model", fsdp=None)
    assert custom["layers.0.wq.weight"] == ("model", None)
    assert custom["layers.1.w_down.weight"] == (None, "model")
