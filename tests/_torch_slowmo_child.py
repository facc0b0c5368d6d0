"""One rank of the port's multi-rank SlowMo and mesh tests
(``test_torch_slowmo.py``, ``test_torch_slowmo_step.py``,
``test_torch_distributed.py``); imports torch, numpy and the port only.

Launched as ``python tests/_torch_slowmo_child.py <suite> <rank> <world>
<store_file> <out> [<in_npz>]``.  Joins a gloo group through a
``FileStore``, runs every case of ``suite`` and writes what the parent holds
against the JAX package: JSON for ``optimizer`` and ``mesh``, an ``.npz``
for ``step``.

- ``optimizer`` (4 ranks): the cases of the JAX package's
  ``tests/test_slowmo.py``, rank ``r`` taking the gradient of stacked
  replica ``r`` there;
- ``mesh`` (4 ranks): ``make_hybrid_mesh`` and collectives over its axes;
- ``step`` (2 ranks): ``make_slowmo_train_step`` on ``llama_test`` (or, when
  ``<in_npz>`` holds ``family="gpt2"``, on ``gpt2_test`` with
  ``model=gpt2``) from the JAX weights and batch in ``<in_npz>``;
- ``step_mesh`` (4 ranks): the same on ``llama_test`` with replicas of 2
  ranks, ``MeshSpec(dp=2, tp=2)`` then ``MeshSpec(dp=2, fsdp=2)``: each
  step's mean loss and the whole parameters of this rank's replica.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(suite, world, directory, extra=None):
    """For the parent test: ``world`` ranks of ``suite``, started together;
    rank ``r`` writes ``directory / rank<r>.<json|npz>``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("LOCAL_WORLD_SIZE", None)
    ext = "npz" if suite.startswith("step") else "json"
    args = [] if extra is None else [str(extra)]
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(rank), str(world),
             str(directory / "store"), str(directory / f"rank{rank}.{ext}"), *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


def wait(procs, what):
    """For the parent test: every rank's exit, 60 s each; fails with the
    output of a rank that did not exit 0, and kills any rank left."""
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {what} exited {p.returncode}:\n{out[-3000:]}"


def _stacked_params():
    return (torch.nn.Parameter(torch.arange(6.0).reshape(2, 3)),
            torch.nn.Parameter(torch.ones(3)))


def _grads(rank):
    return (torch.full((2, 3), float(rank + 1)), torch.full((3,), 0.1 * (rank + 1)))


def _slowmo(params, base, **kw):
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer

    lr = kw.pop("lr")
    return SlowMomentumOptimizer(base(params, lr=lr), base_lr=lr, **kw)


def _run(opt, params, grads, steps):
    """``steps`` steps on fixed gradients; each step's parameters."""
    out = []
    for _ in range(steps):
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        out.append([p.detach().clone().tolist() for p in params])
    return out


def _buffers(opt):
    view = opt.slowmo_state
    return {"prev": [t.tolist() for t in view.prev],
            "momentum": [t.tolist() for t in view.momentum], "step": view.step}


def suite_optimizer(rank, world, extra):
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.slowmo import (
        SlowMomentumOptimizer,
        load_slowmo_state_dict,
        slowmo_grad_sync,
        slowmo_state_dict,
    )

    sgd = torch.optim.SGD
    out = {}
    grads = _grads(rank)

    params = _stacked_params()
    opt = _slowmo(params, sgd, lr=0.1, slowmo_freq=3, slowmo_factor=0.0, slowmo_lr=1.0)
    out["diverge"] = {"steps": _run(opt, params, grads, 3), **_buffers(opt)}

    params = _stacked_params()
    opt = _slowmo(params, sgd, lr=0.1, slowmo_freq=2, slowmo_factor=0.5, slowmo_lr=0.7)
    out["closed_form"] = {"steps": _run(opt, params, grads, 2), **_buffers(opt)}

    params = _stacked_params()
    opt = _slowmo(params, sgd, lr=0.1, slowmo_freq=1, slowmo_factor=0.5, slowmo_lr=1.0)
    m = []
    for _ in range(2):
        _run(opt, params, grads, 1)
        m.append(_buffers(opt)["momentum"])
    out["accumulate"] = {"momentum": m}

    # Under a mesh: the optimizer averages over the mesh's dp group.
    mesh = make_mesh(MeshSpec(dp=world), device_type="cpu")
    params = _stacked_params()
    opt = _slowmo(params, sgd, lr=0.05, slowmo_freq=2, slowmo_factor=0.3, slowmo_lr=1.0,
                  group=mesh.get_group("dp"))
    out["mesh"] = {"steps": _run(opt, params, grads, 2), **_buffers(opt)}

    params = _stacked_params()
    opt = _slowmo(params, torch.optim.Adam, lr=0.01, slowmo_freq=2, slowmo_factor=0.5,
                  slowmo_lr=1.0)
    out["adam"] = {"steps": _run(opt, params, grads, 4), **_buffers(opt)}

    # Convergence: fit y = x @ w, replica r on its own (64, 8) rows.
    x = torch.from_numpy(extra["x"][rank])
    y = torch.from_numpy(extra["y"][rank])
    w = torch.nn.Parameter(torch.zeros(8, 1))
    opt = _slowmo([w], sgd, lr=0.1, slowmo_freq=4, slowmo_factor=0.5, slowmo_lr=1.0)
    losses = []
    for _ in range(60):
        loss = torch.mean((x @ w - y) ** 2)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    out["converge"] = {"losses": losses, "w": w.detach().tolist(), **_buffers(opt)}

    # State dict through torch.save, into an optimizer of other
    # hyperparameters; one more step on both must give the same bits.
    params = _stacked_params()
    opt = _slowmo(params, sgd, lr=0.1, slowmo_freq=3, slowmo_factor=0.5, slowmo_lr=2.0)
    _run(opt, params, grads, 3)
    d = slowmo_state_dict(opt)
    buf = io.BytesIO()
    torch.save(d, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=True)
    params2 = tuple(torch.nn.Parameter(p.detach().clone()) for p in params)
    opt2 = SlowMomentumOptimizer(sgd(params2, lr=0.1), base_lr=0.1, slowmo_freq=99)
    load_slowmo_state_dict(opt2, loaded)
    hyper = [opt2.slowmo_freq, opt2.slowmo_factor, opt2.slowmo_lr, opt2.base_lr]
    a = _run(opt, params, grads, 1)[0]
    b = _run(opt2, params2, grads, 1)[0]
    va, vb = opt.slowmo_state, opt2.slowmo_state
    same = (all(torch.equal(x, y) for x, y in zip(params, params2))
            and all(torch.equal(x, y) for x, y in zip(va.prev + va.momentum,
                                                        vb.prev + vb.momentum))
            and va.step == vb.step == 4)
    out["state_dict"] = {"step": d["step"], "freq": d["slowmo_freq"], "hyper": hyper,
                         "same_bits": same, "after": a, "after_loaded": b}

    # Gradient all-mean: over the mesh's tp group, then with enabled=False,
    # then over the default group (a parameter's .grad).
    mesh = make_mesh(MeshSpec(dp=2, tp=2), device_type="cpu")
    i, j = mesh.get_coordinate()
    g = torch.tensor([[float(2 * i + j)]])
    slowmo_grad_sync([g], mesh.get_group("tp"))
    h = torch.tensor([[float(2 * i + j)]])
    slowmo_grad_sync([h], mesh.get_group("tp"), enabled=False)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(rank))
    slowmo_grad_sync([p])
    out["grad_sync"] = {"coord": [i, j], "synced": g.tolist(), "disabled": h.tolist(),
                        "world": p.grad.tolist()}
    return out


def suite_mesh(rank, world, extra):
    import os

    from torchdistx_tpu_torch.parallel import MeshSpec, initialize, make_hybrid_mesh
    from torchdistx_tpu_torch.parallel.distributed import world_info

    out = {"info": list(world_info().__dict__.values()),
           "adopted": list(initialize(device="cpu").__dict__.values())}
    mesh = make_hybrid_mesh(MeshSpec(tp=2), MeshSpec(dp=2), device_type="cpu")
    x = torch.tensor([float(rank)])
    dist.all_reduce(x, group=mesh.get_group("dp"))
    after_dp = x.item()
    dist.all_reduce(x, group=mesh.get_group("tp"))
    out.update({"names": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist(),
                "coord": list(mesh.get_coordinate()), "after_dp": after_dp,
                "after_both": x.item()})
    # Two hosts of two ranks by LOCAL_WORLD_SIZE: one granule each.
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    out["two_hosts"] = make_hybrid_mesh(MeshSpec(tp=2), MeshSpec(dp=2),
                                        device_type="cpu").mesh.tolist()
    # Four hosts cannot form two DCN granules.
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        make_hybrid_mesh(MeshSpec(tp=2), MeshSpec(dp=2), device_type="cpu")
        out["four_hosts"] = "built"
    except ValueError as e:
        out["four_hosts"] = str(e)
    del os.environ["LOCAL_WORLD_SIZE"]
    return out


def _jax_tree(flat):
    """The JAX parameter pytree from ``{"a/b": array}``."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def suite_step(rank, world, extra):
    from torchdistx_tpu_torch.models import gpt2, llama
    from torchdistx_tpu_torch.models.convert import copy_jax_params_, to_jax_params
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
    from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step

    params = _jax_tree({k[len("param/"):]: v for k, v in extra.items()
                        if k.startswith("param/")})
    batch = {"tokens": torch.from_numpy(extra["tokens"]),
             "targets": torch.from_numpy(extra["targets"])}
    mesh = make_mesh(MeshSpec(dp=world), device_type="cpu")
    family = gpt2 if str(extra.get("family", "llama")) == "gpt2" else llama
    cfg = gpt2.gpt2_test() if family is gpt2 else llama.llama_test()
    out = {}

    def build(freq, factor=0.5):
        def opt(ps):
            return SlowMomentumOptimizer(torch.optim.SGD(ps, lr=0.1), base_lr=0.1,
                                         slowmo_freq=freq, slowmo_factor=factor)

        return make_slowmo_train_step(cfg, mesh, opt, model=family, device="cpu")

    init_fn, step_fn = build(2)
    state = init_fn(0)
    out["init_digest"] = np.array([float(sum(p.double().sum() for p in
                                             state.model.parameters()))])
    copy_jax_params_(state.model, params)
    for i in range(1, 5):
        state, metrics = step_fn(state, batch)
        out[f"loss/{i}"] = np.array([metrics["loss"].item()])
        out[f"step/{i}"] = np.array([metrics["step"]])
        # Copies: to_jax_params may return views of the parameters, which
        # the next step updates in place.
        for key, value in _flat(to_jax_params(state.model)).items():
            out[f"params/{i}/{key}"] = value.copy()
        view = state.optimizer.slowmo_state
        ps = list(state.model.parameters())
        out[f"equal_prev/{i}"] = np.array([all(torch.equal(p, q)
                                               for p, q in zip(ps, view.prev))])
        out[f"momentum_max/{i}"] = np.array([max(m.abs().max().item()
                                                 for m in view.momentum)])

    # slowmo_freq=1: the closed-form oracle of one averaging step.
    init_fn, step_fn = build(1)
    state = init_fn(0)
    copy_jax_params_(state.model, params)
    prev0 = [p.detach().clone() for p in state.model.parameters()]
    state, _ = step_fn(state, batch)
    view = state.optimizer.slowmo_state
    for n, (name, p) in enumerate(state.model.named_parameters()):
        out[f"oracle/param/{name}"] = p.detach().numpy().copy()
        out[f"oracle/prev0/{name}"] = prev0[n].numpy()
        out[f"oracle/prev1/{name}"] = view.prev[n].numpy().copy()
        out[f"oracle/m1/{name}"] = view.momentum[n].numpy().copy()
    return out


def suite_step_mesh(rank, world, extra):
    from torch.distributed.tensor import distribute_tensor

    from torchdistx_tpu_torch.models import llama
    from torchdistx_tpu_torch.models.convert import llama_from_jax_params, to_jax_params
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import (
        make_slowmo_train_step,
        slowmo_batch_sharding,
    )

    params = _jax_tree({k[len("param/"):]: v for k, v in extra.items()
                        if k.startswith("param/")})
    batch = {"tokens": torch.from_numpy(extra["tokens"]),
             "targets": torch.from_numpy(extra["targets"])}
    cfg = llama.llama_test()
    plain = llama_from_jax_params(params, cfg, device="cpu")
    values = {k: v.detach().clone() for k, v in plain.state_dict().items()}

    def opt(ps):
        return SlowMomentumOptimizer(torch.optim.SGD(ps, lr=0.1), base_lr=0.1, slowmo_freq=2)

    out = {}
    for label, spec in (("dp2_tp2", MeshSpec(dp=2, tp=2)), ("dp2_fsdp2", MeshSpec(dp=2, fsdp=2))):
        mesh = make_mesh(spec, device_type="cpu")
        out[f"{label}/coordinate"] = np.array(mesh.get_coordinate())
        out[f"{label}/batch_block"] = slowmo_batch_sharding(mesh)(batch)["tokens"].numpy()
        init_fn, step_fn = make_slowmo_train_step(cfg, mesh, opt, device="cpu")
        state = init_fn(0)
        named = dict(state.model.named_parameters())
        out[f"{label}/sharded"] = np.array([all(
            hasattr(p, "placements") and p.to_local().numel() <= p.numel()
            for p in named.values())])
        with torch.no_grad():
            for name, p in named.items():
                p.to_local().copy_(distribute_tensor(values[name], p.device_mesh,
                                                     p.placements).to_local())
        for i in range(1, 5):
            state, metrics = step_fn(state, batch)
            out[f"{label}/loss/{i}"] = np.array([metrics["loss"].item()])
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    plain.get_parameter(name).copy_(whole(p))
            for key, value in _flat(to_jax_params(plain)).items():
                out[f"{label}/params/{i}/{key}"] = value.copy()
        view = state.optimizer.slowmo_state
        out[f"{label}/prev_is_local_shard"] = np.array([all(
            t.shape == p.to_local().shape for t, p in zip(view.prev, named.values()))])
    return out


SUITES = {"optimizer": suite_optimizer, "mesh": suite_mesh, "step": suite_step,
          "step_mesh": suite_step_mesh}


def main() -> None:
    suite, rank, world, store_file, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    extra = dict(np.load(sys.argv[6])) if len(sys.argv) > 6 else {}
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        out = SUITES[suite](rank, world, extra)
    finally:
        dist.destroy_process_group()
    if out_path.endswith(".npz"):
        np.savez(out_path, **out)
    else:
        with open(out_path, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
