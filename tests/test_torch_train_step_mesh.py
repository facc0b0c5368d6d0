"""The port's training step on a mesh (``make_train_step(mesh=)``) against
the JAX package's ``make_train_step`` on the same mesh shape.

The port side is 4 gloo ranks in subprocesses (``_torch_mesh_child.py``,
suite ``train``), each starting from the JAX ``init_fn``'s parameters
(through numpy and ``models/convert.py``, then cut to the rank's shards by
the plan); the JAX side runs on virtual CPU devices.  Both take three AdamW
steps on the same numpy batches (4 x 16).  Tolerance: atol 1e-5 on every
step's loss and on every parameter after the third step (float32, the same
arithmetic reduced in other orders); MoE's parameters 2e-5 (below).

AdamW's ``eps`` is 1e-6 here, not the 1e-8 of the single-device tests: an
element whose gradient is near ``eps`` turns float32 summation-order noise
into a large share of a step, and at 1e-8 the port's mesh steps were
1.0e-5 to 1.9e-5 from JAX's on one element or two of ~100k, over four data
seeds, where JAX's own step on two mesh shapes (``fsdp=2, tp=2`` and
``dp=4``) differs by 5.3e-6 on the same data.  MoE's routing adds its own
sensitivity (top-2 near-ties and capacity drops): its parameters are held
at 2e-5 (JAX's own two meshes: 5.8e-6 apart; the port's mesh step against
its own unsharded step: 5e-7).

- Llama (``llama_test``) under ``MeshSpec(fsdp=2, tp=2)`` and ``MeshSpec(dp=2,
  tp=2)``, GPT-2 (``gpt2_test``) under ``fsdp=2, tp=2`` and MoE
  (``moe_test``) under ``dp=2, fsdp=2``, each against JAX;
- Llama on a mesh named ``("data", "model")`` with ``fsdp="data",
  tp="model"``, under ``fsdp=2, tp=2`` with ``tp=None`` (the ``tp`` axis
  replicates the compute), and under ``fsdp=2, tp=2`` with a custom
  ``loss_fn`` (cross-entropy plus a z-loss in torch ops on the ``DTensor``
  logits; JAX's the same in ``jnp`` on its logits), each against JAX's
  step with the same arguments;
- at AdamW eps 1e-5 (ROADMAP C4), Llama under ``fsdp=2, tp=2`` and MoE
  under ``dp=2, fsdp=2`` against the port's unsharded step (1e-6) and the
  JAX unsharded step (1e-5);
- the ``fsdp=2, tp=2`` run against the port's own step without a mesh, and
  ``fsdp=2, sp=2`` with ring attention, contiguous and zigzag, against it
  (the JAX sequence-parallel train step's test is marked slow there);
- placements: every parameter, gradient and AdamW moment a ``DTensor``
  placed as ``param_specs`` fitted to the mesh (``wq`` and ``wo`` have one
  shape and transposed specs), each rank holding only its shards;
- a ``_tdx_nan`` batch on one rank skips the step on every rank;
- the JAX dry run's ``train_dp_fsdp_tp``, ``flash_sharded`` and ``sp_ring``
  stages on the 4 ranks, finite;
- in this process: the pipeline arguments' misuses and a custom loss with
  the zigzag layout raise JAX's messages.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.models import moe as jmoe
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models import moe as tmoe
from torchdistx_tpu_torch.models.convert import (
    gpt2_from_jax_params,
    llama_from_jax_params,
    moe_from_jax_params,
    to_jax_params,
)
from torchdistx_tpu_torch.parallel.train_step import make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_child import launch, wait  # noqa: E402

ATOL = 1e-5
MOE_PARAM_ATOL = 2e-5
# ROADMAP C4: at AdamW eps 1e-5 the mesh step is held to its own unsharded
# step at C4_SELF_ATOL and to JAX's unsharded step at ATOL.
C4_EPS = 1e-5
C4_SELF_ATOL = 1e-6
STEPS = 3
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4)
Z_LOSS = 1e-3


def _jax_ce_z_loss(params, tokens, targets):
    """The port child's ``ce_z_loss`` in ``jnp``: the JAX custom ``loss_fn``."""
    logits = jllama.forward(params, tokens, jllama.llama_test(), attn_impl="jnp")
    lse = jax.nn.logsumexp(logits, axis=-1)
    nll = lse - jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return nll.mean() + Z_LOSS * (lse * lse).mean()


RUNS = {  # run -> (family, JAX mesh: a MeshSpec or make_mesh's keywords, step keywords)
    "llama_fsdp_tp": ("llama", JaxMeshSpec(fsdp=2, tp=2), {}),
    "llama_dp_tp": ("llama", JaxMeshSpec(dp=2, tp=2), {}),
    "gpt2_fsdp_tp": ("gpt2", JaxMeshSpec(fsdp=2, tp=2), {}),
    "moe_dp_fsdp": ("moe", JaxMeshSpec(dp=2, fsdp=2), {}),
    "llama_named_axes": ("llama", {"axis_names": ("data", "model"), "shape": (2, 2)},
                         {"fsdp": "data", "tp": "model"}),
    "llama_tp_none": ("llama", JaxMeshSpec(fsdp=2, tp=2), {"tp": None}),
    "llama_custom_loss": ("llama", JaxMeshSpec(fsdp=2, tp=2), {"loss_fn": _jax_ce_z_loss}),
}
FAMILIES = {  # family -> (JAX module, JAX config, port builder from JAX params)
    "llama": (jllama, jllama.llama_test, llama_from_jax_params, tllama.llama_test),
    "gpt2": (jgpt2, jgpt2.gpt2_test, gpt2_from_jax_params, None),
    "moe": (jmoe, jmoe.moe_test, moe_from_jax_params, tmoe.moe_test),
}


def _batches():
    rng = np.random.default_rng(9)
    return [{"tokens": rng.integers(0, 256, (4, 16)), "targets": rng.integers(0, 256, (4, 16))}
            for _ in range(STEPS)]


def _jax_init(family, spec, **kw):
    jmod, jcfg, _, _ = FAMILIES[family]
    if isinstance(spec, dict):
        mesh = jax_make_mesh(**spec, devices=jax.devices()[:4])
    else:
        mesh = jax_make_mesh(spec, devices=jax.devices()[:4])
    init_fn, step_fn = jts.make_train_step(jcfg(), mesh, optax.adamw(**ADAMW), model=jmod,
                                           **kw)
    return mesh, init_fn(jax.random.PRNGKey(0)), step_fn


def _jax_run(family, spec, params_np, **kw):
    mesh, state, step_fn = _jax_init(family, spec, **kw)
    state = state._replace(params=jax.tree.map(
        lambda x, a: jax.device_put(a, x.sharding), state.params, params_np))
    bs = jts.batch_sharding(mesh)
    losses = []
    for batch in _batches():
        state, m = step_fn(state, {k: jax.device_put(jnp.asarray(v), bs)
                                   for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


def _jax_run_eps(family, spec, params_np, eps):
    """The JAX step at AdamW ``eps`` on ``spec`` (None: one device)."""
    jmod, jcfg, _, _ = FAMILIES[family]
    devices = jax.devices()[:4] if spec is not None else jax.devices()[:1]
    mesh = jax_make_mesh(spec if spec is not None else JaxMeshSpec(), devices=devices)
    init_fn, step_fn = jts.make_train_step(jcfg(), mesh, optax.adamw(**dict(ADAMW, eps=eps)),
                                           model=jmod)
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(
        lambda x, a: jax.device_put(a, x.sharding), state.params, params_np))
    bs = jts.batch_sharding(mesh)
    losses = []
    for batch in _batches():
        state, m = step_fn(state, {k: jax.device_put(jnp.asarray(v), bs)
                                   for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


def _max_diff(a, b):
    """The largest |difference| of two port runs' losses and parameters."""
    worst = float(np.max(np.abs(np.subtract(a["losses"], b["losses"]))))
    for key, value in b["params"].items():
        worst = max(worst, float(np.max(np.abs(a["params"][key] - value))))
    return worst


def _max_diff_jax(a, b):
    """The same of two JAX runs."""
    worst = float(np.max(np.abs(np.subtract(a["losses"], b["losses"]))))
    for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
        worst = max(worst, float(np.max(np.abs(x - y))))
    return worst


def _max_diff_port_jax(family, port_run, jax_run, params_np):
    """The same of a port run against a JAX run."""
    tree = _port_tree(family, port_run["params"], params_np)
    return _max_diff_jax({"losses": port_run["losses"], "params": tree}, jax_run)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port)``: the JAX runs by name and rank 0's report."""
    d = tmp_path_factory.mktemp("train_step_mesh")
    params = {f: jax.tree.map(np.asarray, _jax_init(f, JaxMeshSpec(fsdp=2, tp=2))[1].params)
              for f in FAMILIES}
    rng = np.random.default_rng(4)
    inputs = {"adamw": ADAMW, "batches": _batches(), "eps": [C4_EPS],
              "dry_tokens": rng.integers(0, 256, (8, 32)),
              "dry_tokens_sp": rng.integers(0, 256, (4, 64)),
              **{f"{f}_params": p for f, p in params.items()}}
    procs = launch("train", 4, d, inputs)
    try:
        want = {name: _jax_run(family, spec, params[family], **kw)
                for name, (family, spec, kw) in RUNS.items()}
        for family in ("llama", "moe"):
            want[f"{family}_jax_single_{C4_EPS}"] = _jax_run_eps(family, None, params[family],
                                                                 C4_EPS)
    finally:
        port = wait(procs, d, "the train suite")
    return want, port, params


def _port_tree(family, values, params_np):
    """The port's whole values in the JAX layout."""
    _, jcfg, from_jax, _ = FAMILIES[family]
    cfg = {"llama": tllama.llama_test, "moe": tmoe.moe_test}.get(family)
    if cfg is None:
        from torchdistx_tpu_torch.models import gpt2 as tgpt2

        cfg = tgpt2.gpt2_test
    model = from_jax(params_np, cfg(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in values.items()})
    return to_jax_params(model)


@pytest.mark.parametrize("name", list(RUNS))
def test_three_adamw_steps_match_jax(runs, name):
    want, port, params = runs
    family = RUNS[name][0]
    np.testing.assert_allclose(port[name]["losses"], want[name]["losses"], atol=ATOL, rtol=0)
    got = _port_tree(family, port[name]["params"], params[family])
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree.leaves(want[name]["params"])
    assert len(flat_got) == len(flat_want)
    atol = MOE_PARAM_ATOL if family == "moe" else ATOL
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_mesh_step_at_eps_1e5_against_unsharded_steps(runs, family):
    """ROADMAP C4 at AdamW eps 1e-5 (scripts/torch_mesh_eps_probe.py reads
    4.8e-7 against the port's unsharded step and 8.3e-7 against JAX's):
    the mesh step (Llama ``fsdp x tp``, MoE ``dp x fsdp``) within 1e-6 of
    the port's unsharded step and within ATOL of JAX's unsharded step."""
    want, port, params = runs
    mesh, single = port["eps"][f"{family}_mesh_{C4_EPS}"], port["eps"][f"{family}_single_{C4_EPS}"]
    assert _max_diff(mesh, single) <= C4_SELF_ATOL
    assert _max_diff_port_jax(family, mesh, want[f"{family}_jax_single_{C4_EPS}"],
                              params[family]) <= ATOL


@pytest.mark.parametrize("name", ["llama_fsdp_tp", "llama_sp_contiguous", "llama_sp_zigzag"])
def test_mesh_step_equals_the_unsharded_step(runs, name):
    _, port, _ = runs
    single = port["llama_single"]
    np.testing.assert_allclose(port[name]["losses"], single["losses"], atol=ATOL, rtol=0)
    for key, value in single["params"].items():
        np.testing.assert_allclose(port[name]["params"][key], value, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("check", ["params_placed", "moments_placed", "moments_by_name",
                                   "no_grads_held", "whole_is_full_tensor"])
def test_state_is_placed_by_the_plan(runs, check):
    _, port, _ = runs
    assert port["placements"][check] is True


def test_each_rank_holds_only_its_shards(runs):
    _, port, _ = runs
    p = port["placements"]
    assert p["local_elements"] == p["expected_local_elements"]
    assert p["local_elements"] < tllama.num_params(tllama.llama_test())


def test_gradients_are_placed_as_their_parameters(runs):
    _, port, _ = runs
    assert port["grads_placed"] is True


def test_nan_on_one_rank_skips_every_rank(runs):
    _, port, _ = runs
    assert port["nan_skips_everywhere"] is True


@pytest.mark.parametrize("stage", ["train_dp_fsdp_tp", "flash_sharded", "sp_ring"])
def test_dryrun_stages(runs, stage):
    _, port, _ = runs
    assert np.isfinite(port["dryrun"][stage])


class _Mesh:
    """What ``make_train_step`` reads of a mesh before any collective."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.device_type = "cpu"


# The step takes every argument the JAX step does; these cases hold the JAX
# step's validation messages (the pp axis missing from the mesh, 1F1B
# without pp_axis, 1F1B with a sequence axis).  The custom loss, ep and
# axis-name arguments run against JAX above and in test_torch_moe_ep.py.
@pytest.mark.parametrize("kwargs,match", [
    ({"pp_axis": "pp"}, "mesh has no axis 'pp'"),
    ({"n_microbatches": 2, "pp_schedule": "1f1b"}, "requires pp_axis="),
    ({"pp_schedule": "1f1b", "pp_axis": "pp", "seq_axis": "sp",
      "mesh": _Mesh(pp=2, sp=2)}, "does not compose with seq_axis"),
], ids=["pp_axis", "n_microbatches", "pp_schedule"])
def test_unported_arguments_raise_naming_a5b(kwargs, match):
    kw = {"mesh": _Mesh(fsdp=2, tp=2), **kwargs}
    with pytest.raises(ValueError, match=match):
        make_train_step(tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1),
                        device="cpu", **kw)


def test_custom_loss_with_zigzag_layout_raises_as_jax():
    """A custom loss cannot take the zigzag layout (the model applies it
    inside its own loss): JAX's check and message."""
    msg = "cannot be combined with a custom loss_fn"
    mesh = jax_make_mesh(JaxMeshSpec(sp=4), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=msg):
        jts.make_train_step(jllama.llama_test(), mesh, optax.sgd(0.1), seq_axis="sp",
                            seq_layout="zigzag", loss_fn=lambda p, t, y: jnp.float32(0))
    with pytest.raises(ValueError, match=msg):
        make_train_step(tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1),
                        device="cpu", mesh=_Mesh(sp=4), seq_axis="sp", seq_layout="zigzag",
                        loss_fn=lambda m, t, y, **kw: m.loss(t, y, **kw))


def test_unknown_pp_schedule_raises():
    with pytest.raises(ValueError, match="unknown pp_schedule"):
        make_train_step(tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1),
                        device="cpu", pp_schedule="zb")
