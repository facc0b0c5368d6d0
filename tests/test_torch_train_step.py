"""The port's loss, gradients and training step against the JAX package on
``llama_test`` (2 layers, dim 64, 4/2 heads, float32): the JAX
``init_params`` weights go through numpy into the port's model; token ids
and targets are made with numpy.

Tolerance: atol 1e-5 on the loss, every gradient and every parameter after
three optimizer steps (float32, the same arithmetic summed in different
orders).  The guard's skip is checked bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec, make_mesh
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import (
    copy_jax_params_,
    llama_from_jax_params,
    llama_to_jax_params,
)
from torchdistx_tpu_torch.parallel.train_step import make_train_step
from torchdistx_tpu_torch.resilience.guard import (
    NonFiniteError,
    SkipTracker,
    tree_allfinite,
)

ATOL = 1e-5
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jllama.llama_test()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape), rng.integers(0, 256, shape)


def _assert_trees_close(got, want, atol=ATOL):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(
            g, np.asarray(w), atol=atol, rtol=0, err_msg=jax.tree_util.keystr(path)
        )


def test_loss_and_grads_match_jax(jax_params):
    cfg, params, params_np = jax_params
    tokens, targets = _batch((2, 16), seed=1)
    loss = functools.partial(jllama.loss_fn, cfg=cfg)
    j_loss, j_grads = jax.value_and_grad(loss)(
        params, jnp.asarray(tokens), jnp.asarray(targets)
    )
    model = llama_from_jax_params(params_np, tllama.llama_test(), device="cpu")
    t_loss = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    assert t_loss.dtype == torch.float32 and t_loss.dim() == 0
    np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=ATOL, rtol=0)
    t_loss.backward()
    _assert_trees_close(llama_to_jax_params(model, grads=True), j_grads)


def test_loss_is_ce_of_forward(jax_params):
    _, _, params_np = jax_params
    model = llama_from_jax_params(params_np, tllama.llama_test(), device="cpu")
    tokens, targets = (torch.from_numpy(x) for x in _batch((2, 12), seed=2))
    with torch.no_grad():
        want = torch.nn.functional.cross_entropy(
            model(tokens).reshape(-1, 256), targets.reshape(-1)
        )
        got = model.loss(tokens, targets)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_remat_gives_the_same_gradients(jax_params, monkeypatch):
    # Importing the JAX package registers a "tpu" device module in this
    # process, which torch.utils.checkpoint would take as the device of
    # CPU-only inputs; pin it to the CPU, as in a process without it.
    monkeypatch.setattr(
        torch.utils.checkpoint.DefaultDeviceType, "_default_device_type", "cpu"
    )
    _, _, params_np = jax_params
    tokens, targets = (torch.from_numpy(x) for x in _batch((2, 16), seed=3))
    grads = []
    for remat in (False, True):
        cfg = tllama.LlamaConfig(**{**tllama.llama_test().__dict__, "remat": remat})
        model = llama_from_jax_params(params_np, cfg, device="cpu")
        model.loss(tokens, targets).backward()
        grads.append([p.grad for p in model.parameters()])
    for off, on in zip(*grads):
        assert torch.equal(off, on)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_three_steps_match_jax_make_train_step(jax_params, opt):
    cfg, _, _ = jax_params
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    if opt == "sgd":
        jtx, ttx = optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)
    else:
        h = ADAMW
        jtx = optax.adamw(**h)
        ttx = lambda ps: torch.optim.AdamW(  # noqa: E731
            ps, lr=h["learning_rate"], betas=(h["b1"], h["b2"]), eps=h["eps"],
            weight_decay=h["weight_decay"],
        )
    j_init, j_step = jts.make_train_step(cfg, mesh, jtx)
    j_state = j_init(jax.random.PRNGKey(0))
    t_init, t_step = make_train_step(tllama.llama_test(), ttx, device="cpu")
    t_state = t_init(0)
    copy_jax_params_(t_state.model, jax.tree.map(np.asarray, j_state.params))
    sharding = jts.batch_sharding(mesh)
    for i in range(3):
        tokens, targets = _batch((2, 16), seed=10 + i)
        j_state, j_m = j_step(j_state, {
            "tokens": jax.device_put(tokens, sharding),
            "targets": jax.device_put(targets, sharding),
        })
        t_state, t_m = t_step(t_state, {
            "tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets),
        })
        np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]), atol=ATOL, rtol=0)
        assert t_m["step"] == int(j_m["step"]) == i + 1
        assert t_m["nonfinite"] is False and not bool(j_m["nonfinite"])
    _assert_trees_close(llama_to_jax_params(t_state.model), j_state.params)


def test_guard_skip_is_bit_identical_and_matches_jax(jax_params):
    cfg, _, _ = jax_params
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    j_init, j_step = jts.make_train_step(cfg, mesh, optax.adamw(**ADAMW))
    t_init, t_step = make_train_step(
        tllama.llama_test(), lambda ps: torch.optim.AdamW(ps, lr=1e-3), device="cpu"
    )
    j_state, t_state = j_init(jax.random.PRNGKey(0)), t_init(0)
    copy_jax_params_(t_state.model, jax.tree.map(np.asarray, j_state.params))
    tokens, targets = _batch((2, 16), seed=20)
    clean = {"tokens": tokens, "targets": targets}
    j_state, _ = j_step(j_state, clean)  # moments become non-trivial
    t_state, _ = t_step(t_state, {k: torch.from_numpy(v) for k, v in clean.items()})

    j_before = jax.tree.map(np.array, (j_state.params, j_state.opt_state))
    params_before = [p.detach().clone() for p in t_state.model.parameters()]
    opt_before = {
        k: {n: t.clone() if torch.is_tensor(t) else t for n, t in s.items()}
        for k, s in t_state.optimizer.state_dict()["state"].items()
    }
    j_state, j_m = j_step(j_state, {**clean, "_tdx_nan": True})
    t_state, t_m = t_step(t_state, {
        "tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets),
        "_tdx_nan": True,
    })
    assert bool(j_m["nonfinite"]) and t_m["nonfinite"] is True
    assert np.isnan(float(j_m["loss"])) and torch.isnan(t_m["loss"])
    assert int(j_m["step"]) == t_m["step"] == t_state.step == 1
    for a, b in zip(jax.tree.leaves(j_before),
                    jax.tree.leaves((j_state.params, j_state.opt_state))):
        np.testing.assert_array_equal(np.asarray(b), a)
    for before, p in zip(params_before, t_state.model.parameters()):
        assert torch.equal(before, p)
    for k, s in t_state.optimizer.state_dict()["state"].items():
        for n, t in s.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(opt_before[k][n])), n
    assert all(p.grad is None for p in t_state.model.parameters())


def test_guard_off_applies_the_poisoned_step():
    init_fn, step_fn = make_train_step(
        tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1),
        device="cpu", nonfinite_guard=False,
    )
    state = init_fn(0)
    tokens, targets = (torch.from_numpy(x) for x in _batch((2, 8), seed=5))
    state, m = step_fn(state, {"tokens": tokens, "targets": targets, "_tdx_nan": True})
    assert "nonfinite" not in m and torch.isnan(m["loss"]) and state.step == 1


def test_init_fn_is_deterministic_for_a_seed():
    init_fn, _ = make_train_step(
        tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu"
    )
    rng_before = torch.get_rng_state()
    a, b, c = init_fn(3), init_fn(3), init_fn(4)
    assert torch.equal(torch.get_rng_state(), rng_before)
    assert a.step == 0 and isinstance(a.optimizer, torch.optim.SGD)
    pa, pb, pc = (list(s.model.parameters()) for s in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not torch.equal(pa[0], pc[0])
    assert all(p.device.type == "cpu" for p in pa)


def test_tree_allfinite_and_skip_tracker():
    ok = tree_allfinite(torch.ones(3), {"a": [torch.zeros(2), None, 3]})
    assert ok.dtype == torch.bool and bool(ok)
    assert not bool(tree_allfinite([torch.tensor([1.0, float("inf")])]))
    assert bool(tree_allfinite(torch.tensor([1, 2])))  # integers are skipped
    tracker = SkipTracker(max_consecutive=2)
    tracker.observe(True, 1)
    tracker.observe(False, 2)
    tracker.observe(True, 3)
    with pytest.raises(NonFiniteError) as err:
        tracker.observe(True, 4)
    assert err.value.step == 4 and err.value.consecutive == 2 and tracker.total == 3
    never = SkipTracker(max_consecutive=0)
    for step in range(5):
        never.observe(True, step)
    assert never.total == 5


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"mesh": object()}, ValueError),
        ({"tp": "tp"}, ValueError),
        ({"fsdp": "fsdp"}, ValueError),
        ({"seq_axis": "sp"}, ValueError),
        ({"pp_axis": "pp"}, ValueError),
        ({"n_microbatches": 4}, ValueError),
        ({"pp_schedule": "1f1b"}, ValueError),
        ({"seq_layout": "zigzag"}, ValueError),
        ({"model": object()}, TypeError),
    ],
    ids=lambda x: next(iter(x)) if isinstance(x, dict) else x.__name__,
)
def test_mesh_arguments_are_rejected(kwargs, error):
    with pytest.raises(error):
        make_train_step(
            tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1),
            device="cpu", **kwargs,
        )
