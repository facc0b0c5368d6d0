"""The port's SlowMo training step (``make_slowmo_train_step``) against the
JAX package's on ``llama_test`` (2 layers, dim 64, 4/2 heads, float32).

The JAX side is ``make_slowmo_train_step`` on its own ``MeshSpec(dp=2,
tp=4)`` of virtual CPU devices: 2 stacked replicas, SGD 0.1,
``slowmo_freq=2``, 4 steps on one ``(2, 4, 32)`` batch whose rows differ.
The port side is 2 gloo ranks in subprocesses (``_torch_slowmo_child.py``,
suite ``step``; 60 s a rank) on a ``MeshSpec(dp=2)`` mesh, from replica 0
of JAX's initial parameters (through numpy, ``models/convert.py``) and the
same batch.  Tolerance: atol 1e-5 on each step's mean loss and on every
replica's parameters after every step (float32, the same arithmetic summed
in different orders).  The replicas must be bit-equal after the averaging
steps 2 and 4 and differ after steps 1 and 3.

Replicas of two ranks (suite ``step_mesh``, 4 gloo ranks): the same run on
``MeshSpec(dp=2, tp=2)`` and ``MeshSpec(dp=2, fsdp=2)`` against JAX's
``make_slowmo_train_step`` on the same mesh shapes (4 virtual devices),
each replica's parameters ``DTensor`` shards over its ``tp`` / ``fsdp``
ranks, held to the same tolerance and the same bit-equality; the batch
block of ``slowmo_batch_sharding`` is JAX's ``P(dp, fsdp, None)``.

Also here, in this process: the ``slowmo_freq=1`` closed-form oracle of
``tests/test_train_step.py``; ``fit`` over the SlowMo step with one replica
(no group), stopped at a checkpoint between two averaging steps and resumed,
bit-equal to a straight run; and the step's argument checks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu.parallel.slowmo import SlowMomentumOptimizer as JaxSlowMo
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.parallel.fit import fit
from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
from torchdistx_tpu_torch.parallel.train_step import (
    make_slowmo_train_step,
    slowmo_batch_sharding,
)
from torchdistx_tpu_torch.utils.checkpoint import latest_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_slowmo_child import _flat, launch, wait  # noqa: E402

ATOL = 1e-5
STEPS = 4


def _batch():
    # Distinct rows per replica.
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 4, 32)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, ranks)``: the JAX run (each step's mean loss and stacked
    params) and the 2 ranks' ``.npz`` reports."""
    d = tmp_path_factory.mktemp("slowmo_step")
    cfg = jllama.llama_test()
    mesh = jax_make_mesh(JaxMeshSpec(dp=2, tp=4))
    opt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=2)
    init_fn, step_fn = jts.make_slowmo_train_step(cfg, mesh, opt)
    state = init_fn(jax.random.PRNGKey(0))
    replica0 = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
    tokens, targets = _batch()
    np.savez(d / "in.npz", tokens=tokens, targets=targets,
             **{f"param/{k}": v for k, v in _flat(replica0).items()})
    procs = launch("step", 2, d, d / "in.npz")
    try:
        bs = jts.slowmo_batch_sharding(mesh)
        batch = {"tokens": jax.device_put(jnp.asarray(tokens), bs),
                 "targets": jax.device_put(jnp.asarray(targets), bs)}
        want = {"init_replicas_equal": all(
            np.array_equal(np.asarray(x[0]), np.asarray(x[1]))
            for x in jax.tree.leaves(state.params))}
        for i in range(1, STEPS + 1):
            state, metrics = step_fn(state, batch)
            want[f"loss/{i}"] = float(metrics["loss"])
            want[f"params/{i}"] = jax.tree.map(np.asarray, state.params)
    finally:
        wait(procs, "the step suite")
    return want, [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def test_replicas_start_equal(runs):
    want, ranks = runs
    assert want["init_replicas_equal"]
    assert ranks[0]["init_digest"] == ranks[1]["init_digest"]


def test_losses_match_jax(runs):
    want, ranks = runs
    for i in range(1, STEPS + 1):
        assert ranks[0][f"loss/{i}"] == ranks[1][f"loss/{i}"]  # one all-reduce
        np.testing.assert_allclose(ranks[0][f"loss/{i}"][0], want[f"loss/{i}"], atol=ATOL,
                                   rtol=0, err_msg=f"step {i}")
        assert ranks[0][f"step/{i}"][0] == i


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_every_replica_matches_jax(runs, step):
    want, ranks = runs
    jax_params = _flat(want[f"params/{step}"])
    for rank, rep in enumerate(ranks):
        for key, value in jax_params.items():
            np.testing.assert_allclose(rep[f"params/{step}/{key}"], value[rank], atol=ATOL,
                                       rtol=0, err_msg=f"rank {rank} step {step} {key}")


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_replicas_bit_equal_only_after_averaging(runs, step):
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith(f"params/{step}/")]
    equal = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in keys)
    assert equal == (step % 2 == 0)
    for rep in ranks:
        assert bool(rep[f"equal_prev/{step}"][0]) == (step % 2 == 0)
        assert (rep[f"momentum_max/{step}"][0] > 0) == (step >= 2)


def test_slowmo_math_oracle(runs):
    # slowmo_freq=1, one step (tests/test_train_step.py's oracle): the
    # parameters equal prev after the averaging step, and prev1 = prev0 -
    # slowmo_lr * base_lr * m1.
    _, ranks = runs
    for rep in ranks:
        names = [k[len("oracle/param/"):] for k in rep if k.startswith("oracle/param/")]
        assert names
        for name in names:
            p, prev1 = rep[f"oracle/param/{name}"], rep[f"oracle/prev1/{name}"]
            assert np.array_equal(p, prev1)
            np.testing.assert_allclose(
                prev1, rep[f"oracle/prev0/{name}"] - 1.0 * 0.1 * rep[f"oracle/m1/{name}"],
                atol=1e-6, rtol=0)
    assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]
               if k.startswith("oracle/param/"))


def _sgd_slowmo(ps):
    return SlowMomentumOptimizer(torch.optim.SGD(ps, lr=0.1), base_lr=0.1, slowmo_freq=2)


def _state_tensors(state):
    view = state.optimizer.slowmo_state
    return ([p.detach().clone() for p in state.model.parameters()],
            [t.clone() for t in view.prev], [t.clone() for t in view.momentum])


def test_fit_resume_between_averaging_steps_is_bit_exact(tmp_path):
    # One replica (no group).  Averaging at steps 2, 4, 6; the checkpoint at
    # step 3 lies between two of them.
    init_fn, step_fn = make_slowmo_train_step(tllama.llama_test(), None, _sgd_slowmo,
                                              device="cpu")

    def batches():
        g = torch.Generator().manual_seed(3)
        while True:
            t = torch.randint(0, 256, (1, 4, 17), generator=g)
            yield {"tokens": t[..., :-1], "targets": t[..., 1:]}

    straight, _ = fit(init_fn, step_fn, batches(), seed=0, n_steps=6)
    run = str(tmp_path / "run")
    first, _ = fit(init_fn, step_fn, batches(), seed=0, n_steps=3, checkpoint_dir=run,
                   checkpoint_every=3)
    assert first.step == 3 and latest_step(run) == 3
    seen = []

    def probe(state, batch):
        if not seen:
            seen.append((state.step, state.optimizer.slowmo_step,
                         [t.clone() for t in state.optimizer.slowmo_state.momentum]))
        return step_fn(state, batch)

    resumed, _ = fit(init_fn, probe, batches(), seed=0, n_steps=6, checkpoint_dir=run,
                     checkpoint_every=3)
    assert seen[0][:2] == (3, 3) and any(m.abs().max() > 0 for m in seen[0][2])
    assert resumed.step == straight.step == 6
    assert resumed.optimizer.slowmo_step == 6
    for a, b in zip(_state_tensors(straight), _state_tensors(resumed)):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_one_replica_step_trains():
    init_fn, step_fn = make_slowmo_train_step(tllama.llama_test(), None, _sgd_slowmo,
                                              device="cpu")
    state = init_fn(0)
    t = torch.randint(0, 256, (1, 2, 17), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": t[..., :-1], "targets": t[..., 1:]}
    losses = []
    for _ in range(4):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
    assert state.step == metrics["step"] == 4 and losses[-1] < losses[0]


class _Mesh:
    """The parts of a ``DeviceMesh`` that the step reads, without a group."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("mesh, match", [
    (_Mesh(fsdp=1), "has no 'dp' axis"),
], ids=["no_dp"])
def test_mesh_axes_within_a_replica_raise(mesh, match):
    with pytest.raises(ValueError, match=match):
        make_slowmo_train_step(tllama.llama_test(), mesh, _sgd_slowmo, device="cpu")


def test_argument_checks():
    cfg = tllama.llama_test()
    with pytest.raises(TypeError, match="model must be a model family"):
        make_slowmo_train_step(cfg, None, _sgd_slowmo, model=object(), device="cpu")
    init_fn, step_fn = make_slowmo_train_step(
        cfg, None, lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu")
    with pytest.raises(TypeError, match="SlowMomentumOptimizer"):
        init_fn(0)
    shard = slowmo_batch_sharding(None)
    t = torch.zeros((1, 2, 8), dtype=torch.long)
    assert shard({"tokens": t, "targets": t})["tokens"].shape == (2, 8)
    with pytest.raises(ValueError, match=r"must be \(dp=1, B, S\)"):
        shard({"tokens": t[0], "targets": t[0]})


# ---------------------------------------------------------------------------
# Replicas of two ranks: tp / fsdp within a replica

REPLICA_MESHES = {"dp2_tp2": dict(dp=2, tp=2), "dp2_fsdp2": dict(dp=2, fsdp=2)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``(jax, ranks)``: the JAX runs on each replica mesh (each step's
    mean loss and stacked params) and the 4 ranks' ``.npz`` reports."""
    d = tmp_path_factory.mktemp("slowmo_step_mesh")
    cfg = jllama.llama_test()
    opt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=2)
    tokens, targets = _batch()
    want = {}
    procs = None
    try:
        for label, spec in REPLICA_MESHES.items():
            mesh = jax_make_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:4])
            init_fn, step_fn = jts.make_slowmo_train_step(cfg, mesh, opt)
            state = init_fn(jax.random.PRNGKey(0))
            if procs is None:
                replica0 = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
                np.savez(d / "in.npz", tokens=tokens, targets=targets,
                         **{f"param/{k}": v for k, v in _flat(replica0).items()})
                procs = launch("step_mesh", 4, d, d / "in.npz")
            bs = jts.slowmo_batch_sharding(mesh)
            batch = {"tokens": jax.device_put(jnp.asarray(tokens), bs),
                     "targets": jax.device_put(jnp.asarray(targets), bs)}
            for i in range(1, STEPS + 1):
                state, metrics = step_fn(state, batch)
                want[f"{label}/loss/{i}"] = float(metrics["loss"])
                want[f"{label}/params/{i}"] = _flat(jax.tree.map(np.asarray, state.params))
    finally:
        if procs is not None:
            wait(procs, "the step_mesh suite")
    return want, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("label", list(REPLICA_MESHES))
def test_replica_mesh_losses_match_jax(mesh_runs, label):
    want, ranks = mesh_runs
    for i in range(1, STEPS + 1):
        assert all(r[f"{label}/loss/{i}"] == ranks[0][f"{label}/loss/{i}"] for r in ranks)
        np.testing.assert_allclose(ranks[0][f"{label}/loss/{i}"][0], want[f"{label}/loss/{i}"],
                                   atol=ATOL, rtol=0, err_msg=f"{label} step {i}")


@pytest.mark.parametrize("step", range(1, STEPS + 1))
@pytest.mark.parametrize("label", list(REPLICA_MESHES))
def test_replica_mesh_every_replica_matches_jax(mesh_runs, label, step):
    """Each rank's replica (its ``dp`` coordinate) against JAX's stacked
    replica of that index."""
    want, ranks = mesh_runs
    for rank, rep in enumerate(ranks):
        replica = int(rep[f"{label}/coordinate"][0])
        for key, value in want[f"{label}/params/{step}"].items():
            np.testing.assert_allclose(rep[f"{label}/params/{step}/{key}"], value[replica],
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{label} rank {rank} step {step} {key}")


@pytest.mark.parametrize("label", list(REPLICA_MESHES))
def test_replica_mesh_replicas_bit_equal_only_after_averaging(mesh_runs, label):
    """Ranks 0 and 2 hold the same shard of replicas 0 and 1; ranks of one
    replica hold its same whole values."""
    _, ranks = mesh_runs
    for step in range(1, STEPS + 1):
        keys = [k for k in ranks[0] if k.startswith(f"{label}/params/{step}/")]
        across = all(np.array_equal(ranks[0][k], ranks[2][k]) for k in keys)
        assert across == (step % 2 == 0), step
        within = all(np.array_equal(ranks[0][k], ranks[1][k])
                     and np.array_equal(ranks[2][k], ranks[3][k]) for k in keys)
        assert within, step


@pytest.mark.parametrize("label", list(REPLICA_MESHES))
def test_replica_mesh_state_is_per_shard(mesh_runs, label):
    """Parameters are ``DTensor`` shards, and ``prev`` holds each rank's
    local shard."""
    _, ranks = mesh_runs
    for rep in ranks:
        assert bool(rep[f"{label}/sharded"][0]) and bool(rep[f"{label}/prev_is_local_shard"][0])


@pytest.mark.parametrize("label", list(REPLICA_MESHES))
def test_replica_mesh_batch_block_is_jax_placement(mesh_runs, label):
    """``slowmo_batch_sharding``: row ``dp``, then its rows over ``fsdp``
    (JAX's ``P(dp, fsdp, None)``)."""
    _, ranks = mesh_runs
    tokens, _ = _batch()
    n_fsdp = REPLICA_MESHES[label].get("fsdp", 1)
    for rep in ranks:
        coord = rep[f"{label}/coordinate"]
        block = tokens[coord[0]]
        if n_fsdp > 1:
            block = np.split(block, n_fsdp)[coord[1]]
        np.testing.assert_array_equal(rep[f"{label}/batch_block"], block)
