"""One rank of the port's MoE expert-parallel tests (``test_torch_moe_ep.py``);
imports torch, numpy and the port only.

Launched through ``_torch_mesh_child.launch(..., script=this file)`` as
``python tests/_torch_moe_ep_child.py moe_ep <rank> <world> <store_file>
<out> <in_pickle>``: joins a gloo group of 4 CPU ranks, runs every case on
the parent's numpy inputs and, on rank 0, pickles what the parent holds
against the JAX package.

- ``moe_ffn_ep`` on ``MeshSpec(ep=4)`` and ``fsdp=2 x ep=2``, at an ample
  capacity factor and at one that drops choices: the output (gathered), the
  aux loss and the routing every rank saw (``route`` spied on), and the
  rows each rank sent and received by ``all_to_all_single`` (no dropped
  choice among them);
- ``MoE.forward`` on ``ep=4`` from the JAX weights;
- ``make_train_step(model=moe, mesh=)`` for three AdamW steps on ``ep=4``,
  ``fsdp=2 x ep=2`` and, through the GPipe and 1F1B pipelines, ``pp=2 x
  ep=2``: losses and the final whole values, and each rank's expert shards;
- ``materialize_module_torch`` on ``ep=4``: each rank's expert slice equal
  to a full materialize's.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_child import _adamw, _full_values, _mesh_run, _t, main  # noqa: E402

MESHES = {"ep4": {"ep": 4}, "fsdp2_ep2": {"fsdp": 2, "ep": 2}}


def _gathered(obj):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _ffn_case(spec, inputs, factor):
    """``moe_ffn_ep`` on each rank's block of the numpy inputs."""
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.spmd import SpmdContext

    cfg = dataclasses.replace(moe.moe_test(), capacity_factor=factor)
    mesh = make_mesh(MeshSpec(**spec), device_type="cpu")
    ctx = SpmdContext(mesh)
    h, router, eg, eu, ed = (_t(x) for x in inputs["ffn"])
    e_loc = cfg.n_experts // ctx.ep_size
    j = mesh.get_local_rank("ep")
    stacks = [w[j * e_loc:(j + 1) * e_loc] for w in (eg, eu, ed)]
    seen, sizes = [], {}
    route, exchange = moe.route, ctx.ep_exchange

    def spy_route(*a, **k):
        r = route(*a, **k)
        seen.append({n: getattr(r, n).numpy().copy() for n in ("experts", "pos", "keep")})
        return r

    def spy_exchange(x, send, recv):
        sizes.setdefault("send", list(send))
        sizes.setdefault("recv", list(recv))
        return exchange(x, send, recv)

    moe.route, ctx.ep_exchange = spy_route, spy_exchange
    try:
        out, aux = moe.moe_ffn_ep(ctx.shard_batch({"tokens": h})["tokens"], router.T.contiguous(),
                                  *stacks, cfg, ctx)
    finally:
        moe.route = route
    full = ctx.gather_tokens(out)
    ranks = _gathered({"routing": seen[0], "sizes": sizes, "aux": aux.item()})
    same = all(all(np.array_equal(r["routing"][n], ranks[0]["routing"][n]) for n in seen[0])
               for r in ranks)
    return {"out": full.detach().numpy(), "aux": aux.item(), "routing": seen[0],
            "routing_same_on_every_rank": same, "sizes": [r["sizes"] for r in ranks],
            "e_loc": e_loc}


def _forward_case(inputs):
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    from _torch_mesh_child import _load_shards

    mesh = make_mesh(MeshSpec(ep=4), device_type="cpu")
    init_fn, _ = make_train_step(moe.moe_test(), _adamw(inputs["adamw"]), model=moe,
                                 mesh=mesh)
    model = init_fn(0).model
    _load_shards(model, _full_values("moe", inputs["moe_params"]))
    with torch.no_grad():
        logits, aux = model(_t(inputs["forward_tokens"]), mesh=mesh, return_aux=True)
    return {"logits": whole(logits).numpy(), "aux": aux.item()}


def _expert_shards(state):
    """Each rank's expert stacks' local shapes and the elements it holds."""
    named = dict(state.model.named_parameters())
    local = {n: tuple(p.to_local().shape) for n, p in named.items()
             if n.split(".")[-1] in ("e_gate", "e_up", "e_down") and not p.is_meta}
    held = sum(p.to_local().numel() for p in named.values() if not p.is_meta)
    return _gathered({"local_shapes": local, "held_elements": held})


def _pp_case(inputs, schedule):
    """Three AdamW steps of ``pp=2 x ep=2`` (``moe_test``'s 2 layers, one a
    stage) from the JAX weights."""
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    from _torch_pipeline_child import _load_stage

    mesh = make_mesh(MeshSpec(pp=2, ep=2), device_type="cpu")
    init_fn, step_fn = make_train_step(moe.moe_test(), _adamw(inputs["adamw"]), model=moe,
                                       mesh=mesh, pp_axis="pp",
                                       n_microbatches=int(inputs["n_microbatches"]),
                                       pp_schedule=schedule)
    state = init_fn(0)
    _load_stage(state.model, _full_values("moe", inputs["moe_params"]))
    losses = []
    for i, batch in enumerate(inputs["batches"]):
        state, m = step_fn(state, {k: _t(v) for k, v in batch.items()})
        assert m["nonfinite"] is False and m["step"] == i + 1
        losses.append(m["loss"].item())
    params = {}
    for d in _gathered({n: whole(p).detach().numpy().copy()
                        for n, p in state.model.named_parameters() if not p.is_meta}):
        params.update(d)
    return {"losses": losses, "params": params, "shards": _expert_shards(state)}


def _materialize_case():
    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh

    cfg = moe.moe_test()
    mesh = make_mesh(MeshSpec(ep=4), device_type="cpu")
    staged = materialize_module_torch(deferred_init(moe.MoE, cfg, device="cpu"), mesh=mesh,
                                      plan=moe.param_specs(cfg), seed=5)
    full = materialize_module_torch(deferred_init(moe.MoE, cfg, device="cpu"), device="cpu",
                                    seed=5)
    j, e_loc = mesh.get_local_rank("ep"), cfg.n_experts // 4
    slices = {n: torch.equal(v.to_local(), full[n][j * e_loc:(j + 1) * e_loc])
              for n, v in staged.items() if n.split(".")[-1] in ("e_gate", "e_up", "e_down")}
    return _gathered({"slices_equal": slices,
                      "others_whole": all(torch.equal(v.to_local(), full[n])
                                          for n, v in staged.items() if n not in slices)})


def suite_moe_ep(rank, world, inputs):
    from torchdistx_tpu_torch.parallel import MeshSpec

    out = {}
    for name, spec in MESHES.items():
        for label, factor in inputs["factors"].items():
            out[f"ffn_{name}_{label}"] = _ffn_case(spec, inputs, factor)
    out["forward_ep4"] = _forward_case(inputs)
    for name, spec in MESHES.items():
        state, _, out[f"train_{name}"] = _mesh_run("moe", MeshSpec(**spec), inputs)
        out[f"train_{name}"]["shards"] = _expert_shards(state)
    for schedule in ("gpipe", "1f1b"):
        out[f"train_pp2_ep2_{schedule}"] = _pp_case(inputs, schedule)
    out["materialize"] = _materialize_case()
    return out


SUITES = {"moe_ep": suite_moe_ep}

if __name__ == "__main__":
    import _torch_mesh_child

    _torch_mesh_child.SUITES.update(SUITES)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
