"""One rank of the port's sharded-materialization tests
(``test_torch_materialize_dist.py``); imports torch, transformers and the
port only.

Launched as ``python tests/_torch_materialize_dist_child.py <case> <rank>
<world> <store_file> <out_json>``.  Joins a gloo group through a
``FileStore``, builds the case's mesh with ``make_mesh``, records the
case's model with ``deferred_init``, materializes it on the mesh with the
case's plan and unsharded on the CPU, and checks, for every parameter, that
this rank's local shard is bit-equal to its slice of the unsharded value
and that the gathered ``full_tensor()`` is the unsharded value (and that one
tensor materialized alone on the mesh is replicated and equal to it).  Writes
``{"mesh": [...], "params": {name: {"placements": [...], "local_shape":
[...]}}}`` to ``out_json`` for the parent to hold against JAX's specs.
"""

import json
import sys

SEED = 7


def _case(case):
    """(mesh axes, plan, model builder) of ``case``; the models are small."""
    from torchdistx_tpu_torch.models.llama import Llama, llama_test
    from torchdistx_tpu_torch.parallel import (
        MeshSpec,
        fsdp_over,
        fsdp_plan,
        tp_plan_gpt2,
        tp_plan_llama,
    )

    if case == "fsdp4":
        return (MeshSpec(fsdp=4), fsdp_plan(min_size=1),
                lambda: Llama(llama_test(), device="cpu"))
    if case == "fsdp2_tp2":
        from transformers import LlamaConfig, LlamaForCausalLM

        cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, max_position_embeddings=64)
        return (MeshSpec(fsdp=2, tp=2), fsdp_over(tp_plan_llama()),
                lambda: LlamaForCausalLM(cfg))
    if case == "tp2":
        from transformers import GPT2Config, GPT2LMHeadModel

        cfg = GPT2Config(n_layer=2, n_embd=64, n_head=4, vocab_size=128, n_positions=32)
        return MeshSpec(tp=2), tp_plan_gpt2(), lambda: GPT2LMHeadModel(cfg)
    raise ValueError(case)


def placement_names(placements):
    """``["S0", "R", ...]``: a placement per mesh dim."""
    from torch.distributed.tensor import Shard

    return [f"S{p.dim}" if isinstance(p, Shard) else "R" for p in placements]


def main() -> None:
    case, rank, world, store_file, out_json = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import (
        materialize_module_torch,
        materialize_tensor_torch,
    )
    from torchdistx_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        spec, plan, build = _case(case)
        try:
            make_mesh(_too_big(spec), device_type="cpu")
            raise AssertionError("a mesh larger than the world was built")
        except ValueError as e:
            assert f"got {world}" in str(e), e
        mesh = make_mesh(spec, device_type="cpu")
        assert tuple(mesh.mesh_dim_names) == tuple(n for n, _ in spec.axes())
        model = deferred_init(build)
        sharded = materialize_module_torch(model, mesh=mesh, plan=plan, seed=SEED)
        full = materialize_module_torch(model, seed=SEED, device="cpu")
        assert list(sharded) == list(full)
        report = {}
        for name, dt in sharded.items():
            local, want = dt.to_local(), full[name]
            assert dt.shape == want.shape and dt.device_mesh is mesh, name
            offsets = _offsets(dt)
            piece = want
            for d, (start, size) in enumerate(zip(offsets, local.shape)):
                piece = piece.narrow(d, start, size)
            assert torch.equal(local, piece), name
            assert torch.equal(dt.full_tensor(), want), name
            report[name] = {"placements": placement_names(dt.placements),
                            "local_shape": list(local.shape)}
        # One tensor on the mesh, replicated by default: every rank holds
        # the whole unsharded value.
        name, fake = next(iter(model.named_parameters()))
        one = materialize_tensor_torch(fake, mesh=mesh, seed=SEED)
        assert set(placement_names(one.placements)) == {"R"}, name
        assert torch.equal(one.to_local(), full[name]), name
        with open(out_json, "w") as f:
            json.dump({"mesh": list(mesh.mesh_dim_names), "params": report}, f)
    finally:
        dist.destroy_process_group()


def _too_big(spec):
    """``spec`` with its first axis twice as large."""
    import dataclasses

    name, size = spec.axes()[0]
    return dataclasses.replace(spec, **{name: 2 * size})


def _offsets(dt):
    """Where this rank's shard starts in every dim of the global tensor."""
    from torch.distributed.tensor import Shard

    mesh, coord = dt.device_mesh, dt.device_mesh.get_coordinate()
    offsets = [0] * dt.dim()
    for d in range(dt.dim()):
        dims = [i for i, p in enumerate(dt.placements) if isinstance(p, Shard) and p.dim == d]
        index, parts = 0, 1
        for i in dims:
            index = index * mesh.shape[i] + coord[i]
            parts *= mesh.shape[i]
        offsets[d] = index * (dt.shape[d] // parts)
    return offsets


if __name__ == "__main__":
    main()
