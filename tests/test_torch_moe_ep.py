"""The port's MoE expert parallelism (an ``ep`` mesh axis:
``models/moe.py``'s ``moe_ffn_ep`` and ``make_train_step(model=moe)``)
against the JAX MoE, whose experts XLA's partitioner splits over ``ep``
(``tests/test_moe.py``'s expert-parallel cases).

The port side is 4 gloo ranks in subprocesses (``_torch_moe_ep_child.py``,
suite ``moe_ep``) on ``moe_test`` (2 layers, dim 64, 4 experts, top-2,
float32) from the JAX ``init_params`` weights; the JAX side runs on virtual
CPU devices on the same mesh shapes.  Tolerances: outputs, logits, losses
and parameters after three AdamW steps (eps 1e-6, as the mesh tests')
atol 1e-5 (float32, the same arithmetic in other orders); the aux loss
1e-6; routing (each choice's expert, buffer position and whether it is
kept) exact.

- ``moe_ffn_ep`` on ``ep=4`` and ``fsdp=2 x ep=2`` at an ample capacity and
  at one that drops choices, against the JAX ``moe_ffn`` on the whole
  batch: the output, the aux loss, the routing on every rank, and the rows
  sent by ``all_to_all_single``: the kept choices only, each once;
- the ``ep=4`` forward against JAX's unsharded forward;
- three AdamW steps on ``ep=4``, ``fsdp=2 x ep=2`` and ``pp=2 x ep=2``
  (GPipe and 1F1B, 2 microbatches) against JAX's ``make_train_step`` on
  the same mesh;
- each rank's expert stacks hold ``E / ep`` experts, and a rank holds the
  elements of its shards only; ``materialize_module_torch`` gives each
  rank its slice of a full materialize's values.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import moe as jmoe
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.models import moe as tmoe
from torchdistx_tpu_torch.models.convert import moe_from_jax_params, to_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from _torch_mesh_child import launch, wait  # noqa: E402
from _torch_moe_ep_child import MESHES  # noqa: E402

ATOL = 1e-5
AUX_ATOL = 1e-6
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4)
FACTORS = {"ample": 4.0, "dropping": 0.5}
M = 2
STEPS = 3
TRAIN_MESHES = {"ep4": dict(ep=4), "fsdp2_ep2": dict(fsdp=2, ep=2),
                "pp2_ep2_gpipe": dict(pp=2, ep=2), "pp2_ep2_1f1b": dict(pp=2, ep=2)}


def _batches():
    rng = np.random.default_rng(21)
    return [{"tokens": rng.integers(0, 256, (4, 16)), "targets": rng.integers(0, 256, (4, 16))}
            for _ in range(STEPS)]


def _ffn_inputs(cfg):
    rng = np.random.default_rng(3)
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    return (rng.standard_normal((4, 8, d)).astype(np.float32), rand(d, e), rand(e, d, f),
            rand(e, d, f), rand(e, f, d))


def _jax_routing(h, router, cfg):
    """The JAX moe_ffn's routing, step for step: (experts, pos, keep)."""
    t, k, e = h.shape[0] * h.shape[1], cfg.experts_per_token, cfg.n_experts
    probs = jax.nn.softmax((jnp.asarray(h).reshape(t, -1) @ router).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1)
    keep = pos < jmoe._capacity(cfg, t)
    return np.asarray(idx), np.asarray(pos).reshape(t, k), np.asarray(keep).reshape(t, k)


def _jax_train(name, params):
    """Three AdamW steps of the JAX ``make_train_step`` on ``name``'s mesh."""
    spec = TRAIN_MESHES[name]
    pp = {}
    if "pp" in spec:
        pp = dict(pp_axis="pp", n_microbatches=M, pp_schedule=name.rsplit("_", 1)[1])
    mesh = jax_make_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:4])
    init_fn, step_fn = jts.make_train_step(jmoe.moe_test(), mesh, optax.adamw(**ADAMW),
                                           model=jmoe, attn_impl="jnp", **pp)
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(
        lambda x, a: jax.device_put(a, x.sharding), state.params, params))
    bs = jts.batch_sharding(mesh)
    losses = []
    for batch in _batches():
        state, m = step_fn(state, {k: jax.device_put(jnp.asarray(v), bs)
                                   for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port, params)``: the JAX references and rank 0's report."""
    d = tmp_path_factory.mktemp("moe_ep")
    cfg = jmoe.moe_test()
    params = jax.tree.map(np.asarray, jmoe.init_params(jax.random.PRNGKey(0), cfg))
    ffn = _ffn_inputs(cfg)
    tokens = np.random.default_rng(8).integers(0, 256, (4, 16))
    inputs = {"adamw": ADAMW, "batches": _batches(), "moe_params": params, "ffn": ffn,
              "factors": FACTORS, "forward_tokens": tokens, "n_microbatches": M}
    procs = launch("moe_ep", 4, d, inputs, script=os.path.join(HERE, "_torch_moe_ep_child.py"))
    try:
        want = {}
        for label, factor in FACTORS.items():
            c = dataclasses.replace(cfg, capacity_factor=factor)
            out, aux = jmoe.moe_ffn(*(jnp.asarray(x) for x in ffn), c)
            want[f"ffn_{label}"] = {"out": np.asarray(out), "aux": float(aux),
                                    "routing": _jax_routing(ffn[0], ffn[1], c)}
        want["logits"] = np.asarray(jmoe.forward(params, jnp.asarray(tokens), cfg,
                                                 attn_impl="jnp"))
        for name in TRAIN_MESHES:
            want[f"train_{name}"] = _jax_train(name, params)
    finally:
        port = wait(procs, d, "the moe_ep suite")
    return want, port, params


CASES = [(m, f) for m in MESHES for f in FACTORS]


@pytest.mark.parametrize("mesh,factor", CASES)
def test_moe_ffn_ep_matches_jax(runs, mesh, factor):
    want, port, _ = runs
    got, ref = port[f"ffn_{mesh}_{factor}"], want[f"ffn_{factor}"]
    np.testing.assert_allclose(got["out"], ref["out"], atol=ATOL, rtol=0)
    assert abs(got["aux"] - ref["aux"]) <= AUX_ATOL


@pytest.mark.parametrize("mesh,factor", CASES)
def test_routing_is_jax_routing_on_every_rank(runs, mesh, factor):
    """``experts``, ``pos`` and ``keep`` of the whole batch, exactly, the
    same on every rank; the dropping factor drops choices."""
    want, port, _ = runs
    got, (experts, pos, keep) = port[f"ffn_{mesh}_{factor}"], want[f"ffn_{factor}"]["routing"]
    assert got["routing_same_on_every_rank"] is True
    np.testing.assert_array_equal(got["routing"]["experts"], experts)
    np.testing.assert_array_equal(got["routing"]["pos"], pos)
    np.testing.assert_array_equal(got["routing"]["keep"], keep)
    assert (not keep.all()) == (factor == "dropping")


@pytest.mark.parametrize("mesh,factor", CASES)
def test_only_kept_choices_cross_ranks(runs, mesh, factor):
    """Every rank sends its share's kept choices once (the dropped ones
    never), and what one rank sends another receives."""
    want, port, _ = runs
    got = port[f"ffn_{mesh}_{factor}"]
    keep = want[f"ffn_{factor}"]["routing"][2]
    sizes = got["sizes"]
    assert sum(sum(s["send"]) for s in sizes) == int(keep.sum())
    n_ep = MESHES[mesh]["ep"]
    for rank, s in enumerate(sizes):
        group = [r for r in range(len(sizes)) if r // n_ep == rank // n_ep]
        for j, peer in enumerate(group):
            assert sizes[peer]["recv"][rank % n_ep] == s["send"][j], (rank, peer)


def test_ep_forward_matches_unsharded_jax(runs):
    want, port, _ = runs
    np.testing.assert_allclose(port["forward_ep4"]["logits"], want["logits"], atol=ATOL, rtol=0)


def _port_tree(values, params_np):
    model = moe_from_jax_params(params_np, tmoe.moe_test(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in values.items()})
    return to_jax_params(model)


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_three_adamw_steps_match_jax(runs, name):
    want, port, params = runs
    got, ref = port[f"train_{name}"], want[f"train_{name}"]
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=ATOL, rtol=0)
    assert got["losses"][-1] < got["losses"][0]
    flat_got = jax.tree_util.tree_leaves_with_path(_port_tree(got["params"], params))
    flat_want = jax.tree.leaves(ref["params"])
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_each_rank_holds_its_experts_only(runs, name):
    """A rank's expert stacks are ``(E / ep, ...)``, and it holds its shards'
    elements only: fewer than the whole model's."""
    _, port, _ = runs
    cfg = tmoe.moe_test()
    spec = TRAIN_MESHES[name]
    e_loc = cfg.n_experts // spec["ep"]
    d, f = cfg.dim, cfg.ffn_dim
    d_loc = d // spec.get("fsdp", 1)
    for rank, r in enumerate(port[f"train_{name}"]["shards"]):
        assert r["local_shapes"], rank
        for key, shape in r["local_shapes"].items():
            want = {"e_gate": (e_loc, d_loc, f), "e_up": (e_loc, d_loc, f),
                    "e_down": (e_loc, f, d_loc)}[key.split(".")[-1]]
            assert shape == want, (rank, key, shape)
        assert r["held_elements"] < tmoe.num_params(cfg), rank


def test_ep_materialize_gives_each_rank_its_slice(runs):
    _, port, _ = runs
    for rank, r in enumerate(port["materialize"]):
        assert r["slices_equal"] and all(r["slices_equal"].values()), rank
        assert r["others_whole"] is True, rank
