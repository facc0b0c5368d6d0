"""One rank of the port's pipeline tests (``test_torch_pipeline.py``);
imports torch, numpy and the port only.

Launched through ``_torch_mesh_child.launch(..., script=this file)`` as
``python tests/_torch_pipeline_child.py <suite> <rank> <world> <store_file>
<out> <in_pickle>``: joins a gloo group of ``world`` CPU ranks, runs every
case of ``suite`` on the parent's numpy inputs and, on rank 0, pickles what
the parent holds against the JAX package.  Each rank's stage results are
gathered to rank 0 (``all_gather_object``), so rank 0 reports every layer.

Suite ``pipeline`` (4 ranks), from the JAX weights of each family at 4
layers (``llama_test``, ``gpt2_test``, ``moe_test``), ``M`` microbatches:

- on ``MeshSpec(pp=4)``, ``pp=2 x tp=2`` and ``pp=2 x fsdp=2``: the GPipe
  forward's logits, the GPipe loss and gradients (``loss`` +
  ``backward``), the 1F1B loss and gradients (``pp_value_and_grad``), each
  rank's stage computations and block calls, and the 1F1B accumulators
  (MoE on the first and last mesh only);
- on ``pp=2 x sp=2``, GPipe with the ring inside each stage: the forward's
  logits, the loss and gradients, and the ring's calls a stage;
- ``make_train_step(mesh=, pp_axis="pp")`` on ``pp=2 x tp=2``, both
  schedules, three SGD steps: losses and final parameters; a ``_tdx_nan``
  batch on one rank skips the step on every rank; the same GPipe steps with
  a custom ``loss_fn`` (``_torch_mesh_child.ce_z_loss``), and on ``pp=2 x
  sp=2`` with ``seq_axis="sp"``;
- the stage-only materialize of each family on ``pp=2 x fsdp=2``: the keys
  a rank holds and their values against a full ``materialize_module_torch``
  on the same seed.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_child import ce_z_loss, main  # noqa: E402

MESHES = {"pp4": {"pp": 4}, "pp2_tp2": {"pp": 2, "tp": 2}, "pp2_fsdp2": {"pp": 2, "fsdp": 2}}
FAMILY_MESHES = {"llama": list(MESHES), "gpt2": list(MESHES), "moe": ["pp4", "pp2_fsdp2"]}
SP_MESH = {"pp": 2, "sp": 2}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _family(name):
    from torchdistx_tpu_torch.models import convert, gpt2, llama, moe

    mod, cfg, from_jax = {"llama": (llama, llama.llama_test, convert.llama_from_jax_params),
                          "gpt2": (gpt2, gpt2.gpt2_test, convert.gpt2_from_jax_params),
                          "moe": (moe, moe.moe_test, convert.moe_from_jax_params)}[name]
    return mod, dataclasses.replace(cfg(), n_layers=4), from_jax


def _full_values(family, params_np):
    _, cfg, from_jax = _family(family)
    return {k: v.detach().clone() for k, v in
            from_jax(params_np, cfg, device="cpu").state_dict().items()}


def _load_stage(model, values):
    """Each parameter this rank holds (not ``meta``) set from the whole
    ``values``: its shard when it is a ``DTensor``."""
    from torchdistx_tpu_torch.materialize import _local_shard

    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.is_meta:
                continue
            if hasattr(p, "to_local"):
                p.to_local().copy_(_local_shard(values[name], p.device_mesh, p.placements))
            else:
                p.copy_(values[name])


def _whole_grads(grads):
    from torchdistx_tpu_torch.parallel.spmd import whole

    return {n: whole(g).detach().numpy().copy() for n, g in grads.items() if g is not None}


def _merged(local):
    """Every rank's dict merged (rank order) on every rank."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, local)
    out = {}
    for d in got:
        out.update(d)
    return out


def _stage_model(family, spec, values, **kw):
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    mod, cfg, _ = _family(family)
    mesh = make_mesh(MeshSpec(**spec), device_type="cpu")
    init_fn, step_fn = make_train_step(cfg, lambda ps: torch.optim.SGD(ps, lr=0.1), model=mod,
                                       mesh=mesh, pp_axis="pp", **kw)
    state = init_fn(0)
    _load_stage(state.model, values)
    return mod, mesh, state, step_fn


def _grads_case(family, spec, inputs, m_count):
    """GPipe forward, GPipe and 1F1B loss and gradients on one mesh."""
    from torchdistx_tpu_torch.parallel import pipeline
    from torchdistx_tpu_torch.parallel.spmd import whole

    values = _full_values(family, inputs[f"{family}_params"])
    mod, mesh, state, _ = _stage_model(family, spec, values)
    model = state.model
    tok, tgt = _t(inputs["tokens"]), _t(inputs["targets"])
    out = {}
    calls = {}
    blocks = [0]
    for blk in model.layers:
        blk.register_forward_pre_hook(lambda *a: blocks.__setitem__(0, blocks[0] + 1))
    with torch.no_grad():
        logits = model(tok, mesh=mesh, pp_axis="pp", n_microbatches=m_count)
    out["logits"] = whole(logits).numpy()
    calls["forward_only"] = dict(pipeline.last_stage_calls)
    blocks[0] = 0
    loss = model.loss(tok, tgt, mesh=mesh, pp_axis="pp", n_microbatches=m_count)
    loss.backward()
    calls["gpipe"] = dict(pipeline.last_stage_calls)
    calls["gpipe_block_calls"] = blocks[0]
    out["gpipe_loss"] = loss.item()
    out["gpipe_grads"] = _merged(_whole_grads({n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    blocks[0] = 0
    loss, grads = mod.pp_value_and_grad(model, tok, tgt, mesh=mesh, pp_axis="pp",
                                        n_microbatches=m_count)
    calls["1f1b"] = dict(pipeline.last_stage_calls)
    calls["1f1b_block_calls"] = blocks[0]
    out["1f1b_loss"] = loss.item()
    out["1f1b_grads"] = _merged(_whole_grads(grads))
    out["placed"] = all(list(grads[n].placements) == list(p.placements)
                        for n, p in model.named_parameters()
                        if n in grads and hasattr(p, "placements"))
    out["acc_shapes"] = _merged({dist.get_rank(): pipeline.last_grad_acc_shapes})
    out["stash_slots"], out["n_ticks"] = pipeline.last_stash_slots, pipeline.last_n_ticks
    out["calls"] = _merged({dist.get_rank(): calls})
    out["held"] = _merged({dist.get_rank(): sorted(n for n, p in model.named_parameters()
                                                   if not p.is_meta)})
    return out


def _sp_case(family, inputs, m_count):
    """GPipe on ``pp=2 x sp=2``: the forward's logits, the loss and the
    gradients, and the ring attention calls of this rank."""
    from torchdistx_tpu_torch.parallel import ring_attention
    from torchdistx_tpu_torch.parallel.spmd import whole

    values = _full_values(family, inputs[f"{family}_params"])
    _, mesh, state, _ = _stage_model(family, SP_MESH, values)
    model = state.model
    tok, tgt = _t(inputs["tokens"]), _t(inputs["targets"])
    kw = dict(mesh=mesh, pp_axis="pp", n_microbatches=m_count, seq_axis="sp")
    ring = ring_attention.ring_attention
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return ring(*a, **k)

    ring_attention.ring_attention = counted
    try:
        with torch.no_grad():
            logits = model(tok, **kw)
        forward_calls = calls[0]
        loss = model.loss(tok, tgt, **kw)
        loss.backward()
    finally:
        ring_attention.ring_attention = ring
    return {"logits": whole(logits).numpy(), "loss": loss.item(),
            "grads": _merged(_whole_grads({n: p.grad for n, p in model.named_parameters()})),
            "ring_calls": _merged({dist.get_rank(): (forward_calls, calls[0])})}


def _train_case(family, spec, inputs, m_count, schedule, **kw):
    from torchdistx_tpu_torch.parallel.spmd import whole

    values = _full_values(family, inputs[f"{family}_params"])
    _, _, state, step_fn = _stage_model(family, spec, values, n_microbatches=m_count,
                                        pp_schedule=schedule, **kw)
    batch = {"tokens": _t(inputs["tokens"]), "targets": _t(inputs["targets"])}
    losses = []
    for i in range(3):
        state, m = step_fn(state, batch)
        assert m["nonfinite"] is False and m["step"] == i + 1
        losses.append(m["loss"].item())
    params = _merged({n: whole(p).detach().numpy().copy()
                      for n, p in state.model.named_parameters() if not p.is_meta})
    nan_batch = dict(batch, _tdx_nan=dist.get_rank() == 1)
    before = _held(state.model)
    new, m = step_fn(state, nan_batch)
    skipped = (m["nonfinite"] is True and new.step == 3
               and all(torch.equal(a, b) for a, b in zip(before, _held(new.model))))
    return {"losses": losses, "params": params,
            "nan_skips_everywhere": all(_merged({dist.get_rank(): skipped}).values())}


def _held(model):
    """Copies of the local tensors this rank holds."""
    return [(p.to_local() if hasattr(p, "to_local") else p).detach().clone()
            for p in model.parameters() if not p.is_meta]


def _materialize_case(family, spec):
    """The stage-only materialize against a full one on the same seed."""
    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models import gpt2, llama, moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole

    mod, cfg, _ = _family(family)
    cls = {llama: llama.Llama, gpt2: gpt2.GPT2, moe: moe.MoE}[mod]
    mesh = make_mesh(MeshSpec(**spec), device_type="cpu")
    staged = materialize_module_torch(deferred_init(cls, cfg, device="cpu"), mesh=mesh,
                                      plan=mod.param_specs(cfg, pp="pp"), seed=5)
    full = materialize_module_torch(deferred_init(cls, cfg, device="cpu"), device="cpu",
                                    seed=5)
    equal = all(torch.equal(whole(v), full[k]) for k, v in staged.items())
    return _merged({dist.get_rank(): {"keys": sorted(staged), "equal": equal,
                                      "n_full": len(full)}})


def suite_pipeline(rank, world, inputs):
    m_count = int(inputs["n_microbatches"])
    out = {}
    for family, meshes in FAMILY_MESHES.items():
        for name in meshes:
            out[f"{family}_{name}"] = _grads_case(family, MESHES[name], inputs, m_count)
    for family in FAMILY_MESHES:
        out[f"{family}_pp2_sp2"] = _sp_case(family, inputs, m_count)
    for schedule in ("gpipe", "1f1b"):
        out[f"train_{schedule}"] = _train_case("llama", MESHES["pp2_tp2"], inputs, m_count,
                                               schedule)
    out["train_gpipe_custom_loss"] = _train_case("llama", MESHES["pp2_tp2"], inputs, m_count,
                                                 "gpipe", loss_fn=ce_z_loss)
    out["train_gpipe_sp"] = _train_case("llama", SP_MESH, inputs, m_count, "gpipe",
                                        seq_axis="sp")
    for family in FAMILY_MESHES:
        out[f"materialize_{family}"] = _materialize_case(family, MESHES["pp2_fsdp2"])
    return out


SUITES = {"pipeline": suite_pipeline}

if __name__ == "__main__":
    import _torch_mesh_child

    _torch_mesh_child.SUITES.update(SUITES)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
