"""The port's SlowMo optimizer (``parallel/slowmo.py``) against the JAX
package's, case for case with ``tests/test_slowmo.py``.

The JAX tests stack DP = 4 replicas on a leading axis and give replica r
its own gradient; here the replicas are 4 gloo ranks on the CPU, in
subprocesses (``_torch_slowmo_child.py``, suite ``optimizer``; a
``FileStore``, 60 s a rank), rank r taking replica r's gradient, and every
rank's parameters and ``prev``/``momentum`` buffers are held against the
JAX replica's and state's.

Tolerances, float32: relative 1e-6 for SGD (the mean is summed over ranks
in gloo's order and over the stacked axis in XLA's), 1e-5 for Adam
(``torch.optim.Adam`` and ``optax.adam`` place eps alike, and differ in
how they round the bias corrections).  ``momentum = (prev - avg) / base_lr
+ ...`` cancels: one ulp of ``avg`` moves it by ``ulp(prev) / base_lr``,
so momentum is held relative to ``max(|momentum|, |prev| / base_lr)``, the
scale it is formed at.  Replicas are bit-equal after an averaging step, and
the state dict round trip through ``torch.save`` is bit-exact.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.parallel.slowmo import SlowMomentumOptimizer as JaxSlowMo
from torchdistx_tpu_torch.parallel.slowmo import (
    SlowMomentumOptimizer,
    SlowMoState,
    load_slowmo_state_dict,
    slowmo_grad_sync,
    slowmo_state_dict,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_slowmo_child import launch, wait  # noqa: E402

DP = 4
RTOL = 1e-6
ADAM_RTOL = 1e-5


def _converge_data():
    rng = np.random.default_rng(0)
    true_w = rng.standard_normal((8, 1)).astype(np.float32)
    x = rng.standard_normal((DP, 64, 8)).astype(np.float32)
    return x, (x @ true_w).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' reports of the ``optimizer`` suite, by rank."""
    d = tmp_path_factory.mktemp("slowmo")
    x, y = _converge_data()
    np.savez(d / "data.npz", x=x, y=y)
    procs = launch("optimizer", DP, d, d / "data.npz")
    wait(procs, "the optimizer suite")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(DP)]


# -- the JAX side (tests/test_slowmo.py's inputs) -----------------------------


def _stacked_params():
    return {
        "w": jnp.tile(jnp.arange(6.0).reshape(1, 2, 3), (DP, 1, 1)),
        "b": jnp.ones((DP, 3)),
    }


def _distinct_grads():
    return {
        "w": jnp.stack([jnp.full((2, 3), float(r + 1)) for r in range(DP)]),
        "b": jnp.stack([jnp.full((3,), 0.1 * (r + 1)) for r in range(DP)]),
    }


def _jax_run(tx, lr, steps, **kw):
    """(each step's stacked params, the final state) of the JAX optimizer."""
    opt = JaxSlowMo(tx(lr), base_lr=lr, **kw)
    params, grads = _stacked_params(), _distinct_grads()
    state = opt.init(params)
    out = []
    for _ in range(steps):
        params, state = opt.update(grads, state, params)
        out.append(params)
    return out, state


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want), rtol=rtol, atol=0)


def _check_steps(ranks, case, jax_steps, rtol=RTOL):
    for rank, rep in enumerate(ranks):
        for step, (got, want) in enumerate(zip(rep[case]["steps"], jax_steps)):
            _close(got[0], want["w"][rank], rtol)
            _close(got[1], want["b"][rank], rtol)


def _close_momentum(got, want, prev, lr, rtol=RTOL):
    """``got`` within ``rtol`` of ``max(|want|, |prev| / lr)``: the scale
    of ``(prev - avg) / lr``, whose difference cancels."""
    want = np.asarray(want)
    scale = max(np.abs(want).max(), np.abs(np.asarray(prev)).max() / lr)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=rtol * scale)


def _check_buffers(ranks, case, state, lr, rtol=RTOL):
    for rep in ranks:
        for i, key in enumerate(("w", "b")):
            _close(rep[case]["prev"][i], state.prev[key], rtol)
            _close_momentum(rep[case]["momentum"][i], state.momentum[key], state.prev[key],
                            lr, rtol)
        assert rep[case]["step"] == int(state.step)


# -- the cases ----------------------------------------------------------------


def test_replicas_diverge_then_average(ranks):
    jax_steps, state = _jax_run(optax.sgd, 0.1, 3, slowmo_freq=3, slowmo_factor=0.0,
                                slowmo_lr=1.0)
    _check_steps(ranks, "diverge", jax_steps)
    _check_buffers(ranks, "diverge", state, 0.1)
    for step in range(3):
        rows = [rep["diverge"]["steps"][step] for rep in ranks]
        if step < 2:
            assert rows[0] != rows[1]
        else:
            assert all(r == rows[0] for r in rows)  # bit-equal after averaging


def test_momentum_math_closed_form(ranks):
    lr, alpha, slr = 0.1, 0.5, 0.7
    p0 = np.arange(6.0).reshape(2, 3)
    g = np.stack([np.full((2, 3), float(r + 1)) for r in range(DP)])
    avg = (p0 - 2 * lr * g).mean(axis=0)
    m = (p0 - avg) / lr
    prev = p0 - slr * lr * m
    jax_steps, state = _jax_run(optax.sgd, lr, 2, slowmo_freq=2, slowmo_factor=alpha,
                                slowmo_lr=slr)
    _check_steps(ranks, "closed_form", jax_steps)
    _check_buffers(ranks, "closed_form", state, lr)
    for rep in ranks:
        np.testing.assert_allclose(rep["closed_form"]["steps"][1][0], prev, rtol=1e-5)
        np.testing.assert_allclose(rep["closed_form"]["momentum"][0], m, rtol=1e-5)
        np.testing.assert_allclose(rep["closed_form"]["prev"][0], prev, rtol=1e-5)


def test_momentum_accumulates_across_cycles(ranks):
    opt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=1, slowmo_factor=0.5,
                    slowmo_lr=1.0)
    params, grads = _stacked_params(), _distinct_grads()
    state = opt.init(params)
    want = []
    for _ in range(2):
        params, state = opt.update(grads, state, params)
        want.append(state.momentum)
    for rep in ranks:
        m1, m2 = (np.asarray(m[0]) for m in rep["accumulate"]["momentum"])
        _close_momentum(m1, want[0]["w"], np.arange(6.0), 0.1)
        _close_momentum(m2, want[1]["w"], np.arange(6.0), 0.1)
        assert not np.allclose(m1, m2) and np.abs(m2).max() > 0


def test_on_a_mesh(ranks):
    # The JAX test jits the update on a dp-sharded mesh and holds it against
    # the unjitted one; here the optimizer averages over a DeviceMesh's dp
    # group, against the JAX update.
    jax_steps, state = _jax_run(optax.sgd, 0.05, 2, slowmo_freq=2, slowmo_factor=0.3,
                                slowmo_lr=1.0)
    _check_steps(ranks, "mesh", jax_steps)
    _check_buffers(ranks, "mesh", state, 0.05)


def test_works_with_adam(ranks):
    jax_steps, state = _jax_run(optax.adam, 0.01, 4, slowmo_freq=2, slowmo_factor=0.5,
                                slowmo_lr=1.0)
    _check_steps(ranks, "adam", jax_steps, ADAM_RTOL)
    _check_buffers(ranks, "adam", state, 0.01, ADAM_RTOL)
    last = [rep["adam"]["steps"][-1] for rep in ranks]
    assert np.isfinite(np.asarray(last[0][0])).all()
    assert all(r == last[0] for r in last)


def test_training_converges(ranks):
    x, y = _converge_data()
    opt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=4, slowmo_factor=0.5,
                    slowmo_lr=1.0)
    params = {"w": jnp.zeros((DP, 8, 1))}
    state = opt.init(params)

    def replica_loss(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    @jax.jit
    def train_step(params, state):
        loss, grads = jax.vmap(jax.value_and_grad(replica_loss))(params["w"], x, y)
        params, state = opt.update({"w": grads}, state, params)
        return params, state, loss

    losses = []
    for _ in range(60):
        params, state, loss = train_step(params, state)
        losses.append(np.asarray(loss))
    port = np.array([rep["converge"]["losses"] for rep in ranks]).T  # (step, rank)
    assert port.mean(axis=1)[-1] < 0.05 * port.mean(axis=1)[0]
    # A residual cancels as it converges: the losses are held at the scale
    # of the first one (|y|^2), which their rounding errors are relative to.
    np.testing.assert_allclose(port, np.stack(losses), rtol=0, atol=RTOL * port[0].max())
    for rank, rep in enumerate(ranks):
        _close(rep["converge"]["w"], params["w"][rank])
        _close(rep["converge"]["prev"][0], state.prev["w"])
        _close_momentum(rep["converge"]["momentum"][0], state.momentum["w"],
                        state.prev["w"], 0.1)


def test_ctor_validation():
    base = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    for kw, name in (({"slowmo_freq": 0}, "slowmo_freq"), ({"slowmo_factor": -1.0},
                     "slowmo_factor"), ({"slowmo_lr": -0.1}, "slowmo_lr")):
        with pytest.raises(ValueError) as port_err:
            SlowMomentumOptimizer(base, base_lr=0.1, **kw)
        with pytest.raises(ValueError) as jax_err:
            JaxSlowMo(optax.sgd(0.1), base_lr=0.1, **kw)
        assert str(port_err.value) == str(jax_err.value) and name in str(port_err.value)
    with pytest.raises(ValueError, match="base_lr") as port_err:
        SlowMomentumOptimizer(base, base_lr=0.0)
    with pytest.raises(ValueError) as jax_err:
        JaxSlowMo(optax.sgd(0.1), base_lr=0.0)
    assert str(port_err.value) == str(jax_err.value)


def test_state_dict_roundtrip(ranks):
    jax_steps, state = _jax_run(optax.sgd, 0.1, 4, slowmo_freq=3, slowmo_factor=0.5,
                                slowmo_lr=2.0)
    for rank, rep in enumerate(ranks):
        sd = rep["state_dict"]
        assert sd["step"] == 3 and sd["freq"] == 3
        assert sd["hyper"] == [3, 0.5, 2.0, 0.1]
        assert sd["same_bits"] and sd["after"] == sd["after_loaded"]
        _close(sd["after"][0], jax_steps[-1]["w"][rank])
        _close(sd["after"][1], jax_steps[-1]["b"][rank])


def test_state_dict_missing_key():
    params = [torch.nn.Parameter(torch.zeros(2))]
    opt = SlowMomentumOptimizer(torch.optim.SGD(params, lr=0.1), base_lr=0.1)
    d = slowmo_state_dict(opt)
    del d["base_lr"]
    jopt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1)
    jd = {k: v for k, v in jopt.state_dict(jopt.init(_stacked_params())).items()
          if k != "base_lr"}
    with pytest.raises(ValueError, match="base_lr") as port_err:
        load_slowmo_state_dict(opt, d)
    with pytest.raises(ValueError) as jax_err:
        jopt.load_state_dict(jd)
    assert str(port_err.value) == str(jax_err.value)


def test_grad_sync_hook(ranks):
    # slowmo_comm parity: the JAX pmean over the "tp" axis of a (dp=2, tp=2)
    # shard_map, against the port's all-mean over the mesh's tp group.
    from jax.sharding import PartitionSpec as P

    from torchdistx_tpu.parallel import MeshSpec, make_mesh
    from torchdistx_tpu.parallel.slowmo import slowmo_grad_sync as jax_sync

    try:  # jax >= 0.7 promoted the export; 0.4.x has only the module
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=jax.devices()[:4])
    g = jnp.arange(4.0).reshape(2, 2)
    want = shard_map(lambda g: jax_sync(g, axis_name="tp"), mesh=mesh,
                     in_specs=P("dp", "tp"), out_specs=P("dp", "tp"))(g)
    for rank, rep in enumerate(ranks):
        i, j = rep["grad_sync"]["coord"]
        assert rep["grad_sync"]["synced"] == [[float(want[i, j])]]
        assert rep["grad_sync"]["disabled"] == [[float(g[i, j])]]
        assert rep["grad_sync"]["world"] == [1.5, 1.5]  # mean of ranks 0..3


def test_one_replica_without_a_group():
    # No group and no initialized default group: one replica, whose mean is
    # the parameter itself; against the JAX optimizer with DP = 1.
    assert not torch.distributed.is_initialized()
    w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    opt = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), base_lr=0.1, slowmo_freq=2,
                                slowmo_factor=0.5, slowmo_lr=0.7)
    jopt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=2, slowmo_factor=0.5,
                     slowmo_lr=0.7)
    jp = {"w": jnp.arange(6.0).reshape(1, 2, 3)}
    jstate = jopt.init(jp)
    for step in range(1, 6):
        w.grad = torch.full((2, 3), float(step))
        opt.step()
        jp, jstate = jopt.update({"w": jnp.full((1, 2, 3), float(step))}, jstate, jp)
        _close(w.detach(), jp["w"][0])
    view = opt.slowmo_state
    assert isinstance(view, SlowMoState) and view.step == 5
    _close(view.prev[0], jstate.prev["w"])
    _close_momentum(view.momentum[0], jstate.momentum["w"], jstate.prev["w"], 0.1)
    assert slowmo_grad_sync([w]) == [w]  # no group: unchanged


def test_state_dict_round_trips_through_torch_save(tmp_path):
    # Before and after the first step (prev and momentum are made there),
    # the loaded optimizer continues bit for bit.
    def make(freq=2):
        w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
        return w, SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1, momentum=0.9),
                                        base_lr=0.1, slowmo_freq=freq)

    for warm in (0, 3):
        w, opt = make()
        for step in range(warm):
            w.grad = torch.full((2, 3), float(step + 1))
            opt.step()
        torch.save(opt.state_dict(), tmp_path / "sd.pt")
        w2, opt2 = make(freq=5)
        w2.data.copy_(w.detach())
        opt2.load_state_dict(torch.load(tmp_path / "sd.pt", weights_only=True))
        assert opt2.slowmo_freq == 2 and opt2.slowmo_step == warm
        for step in range(3):
            for p in (w, w2):
                p.grad = torch.full((2, 3), float(step - 1))
            opt.step()
            opt2.step()
            assert torch.equal(w, w2), (warm, step)
        for a, b in zip(opt.slowmo_state.prev + opt.slowmo_state.momentum,
                        opt2.slowmo_state.prev + opt2.slowmo_state.momentum):
            assert torch.equal(a, b)
