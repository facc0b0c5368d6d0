"""One rank of the port's mesh tests (``test_torch_attention_sharded.py``,
``test_torch_ring_attention.py``, ``test_torch_train_step_mesh.py``);
imports torch, numpy and the port only.

Launched as ``python tests/_torch_mesh_child.py <suite> <rank> <world>
<store_file> <out> <in_pickle>``.  Joins a gloo group of ``world`` CPU ranks
through a ``FileStore``, runs every case of ``suite`` on the inputs in
``<in_pickle>`` (numpy arrays made by the parent test) and, on rank 0,
pickles what the parent holds against the JAX package to ``<out>``; every
rank checks its own invariants and fails (exit code 1) when one breaks.

- ``attention``: ``flash_attention_sharded`` (the kernel's plain version on
  the CPU) on an ``fsdp=2, tp=2`` mesh, and ``attention(mesh=)`` and the
  kernel's ``on_blocks`` on shapes that ``tp`` does not divide: outputs and
  q/k/v gradients of the global arrays;
- ``ring``: ``ring_attention`` on ``dp=2, sp=2`` and ``sp=4`` meshes,
  contiguous (causal and full) and zigzag (permuted per call, and
  pre-permuted): outputs and gradients;
- ``train``: ``make_train_step(mesh=)`` from the JAX weights (Llama under
  ``fsdp x tp`` and ``dp x tp``, GPT-2 under ``fsdp x tp``, MoE under ``dp x
  fsdp``) for three AdamW steps; Llama on a mesh named ``("data",
  "model")`` with ``fsdp="data", tp="model"``, under ``fsdp x tp`` with
  ``tp=None``, and with a custom ``loss_fn`` (cross-entropy plus a z-loss,
  torch ops on the ``DTensor`` logits); Llama under ``fsdp x sp`` with the
  ring and with the zigzag layout against the unsharded step; placements of
  parameters, gradients and moments; a NaN on one rank; the dry-run
  stages ``train_dp_fsdp_tp``, ``flash_sharded`` and ``sp_ring``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def launch(suite, world, directory, inputs, script=None):
    """For the parent test: ``world`` ranks of ``suite`` started together on
    ``inputs`` (a dict of numpy arrays); rank 0 writes ``directory /
    out.pkl``.  ``script``: the child module to run (default this one; it
    takes the same arguments)."""
    # One thread a pool in each rank: the ranks share the host's cores with
    # the other test workers (OpenMP and MKL pools start at import).
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                             if p]))
    env.pop("LOCAL_WORLD_SIZE", None)
    with open(directory / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(script or __file__), suite, str(rank), str(world),
             str(directory / "store"), str(directory / "out.pkl"), str(directory / "in.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


def wait(procs, directory, what):
    """For the parent test: every rank's exit; fails with the output of a
    rank that did not exit 0, kills any rank left; rank 0's results."""
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {what} exited {p.returncode}:\n{out[-4000:]}"
    with open(directory / "out.pkl", "rb") as f:
        return pickle.load(f)


def _t(x, grad=False):
    t = torch.from_numpy(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _attend(fn, inputs):
    """``fn(q, k, v)`` of the global arrays and the gradients of ``sum(out *
    cot)``: ``{"out", "dq", "dk", "dv"}`` as numpy."""
    q, k, v = (_t(inputs[n], grad=True) for n in ("q", "k", "v"))
    out = fn(q, k, v)
    (out * _t(inputs["cot"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def suite_attention(rank, world, inputs):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchdistx_tpu_torch.ops.attention import attention
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    out = {}
    for causal in (True, False):
        out[f"sharded_causal{causal}"] = _attend(
            lambda q, k, v: fa.flash_attention_sharded(q, k, v, causal=causal, mesh=mesh),
            inputs["gqa"])
    # Shapes tp does not divide: attention(mesh=) takes the plain path on
    # the blocks that divide (the batch), heads whole; on CUDA tensors the
    # kernel runs on the same blocks (here its plain version, on the CPU).
    out["auto_indivisible"] = _attend(
        lambda q, k, v: attention(q, k, v, causal=True, mesh=mesh), inputs["odd"])
    odd_blocks = set()

    def flash_spy(a, b, c):
        odd_blocks.add((tuple(a.shape), tuple(b.shape)))
        return fa.flash_attention(a, b, c, causal=True)

    out["flash_indivisible"] = _attend(
        lambda q, k, v: fa.on_blocks(flash_spy, q, k, v, mesh=mesh), inputs["odd"])
    out["indivisible_block_shapes"] = sorted(odd_blocks)
    # DTensor in, DTensor out, placed (fsdp, -, tp, -): the kernel sees
    # this rank's rows and heads.
    q = inputs["gqa"]
    dq, dk, dv = (DTensor.from_local(_t(q[n]), mesh, [Replicate()] * 2, run_check=False)
                  for n in ("q", "k", "v"))
    seen = {}

    def spy(a, b, c):
        seen["q"], seen["k"] = tuple(a.shape), tuple(b.shape)
        return fa.flash_attention(a, b, c, causal=True)

    got = fa.on_blocks(spy, dq, dk, dv, mesh=mesh)
    assert isinstance(got, DTensor) and list(got.placements) == [Shard(0), Shard(2)], (
        got.placements)
    out["local_block_shapes"] = seen
    out["dtensor_out"] = got.full_tensor().numpy()
    return out


def suite_ring(rank, world, inputs):
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.ring_attention import _zigzag_perm, ring_attention

    out = {}
    for label, spec in (("dp2_sp2", MeshSpec(dp=2, sp=2)), ("sp4", MeshSpec(sp=4))):
        mesh = make_mesh(spec, device_type="cpu")
        n = spec.sp
        for case, kw in (("causal", {}), ("full", {"causal": False}),
                         ("zigzag", {"schedule": "zigzag"})):
            out[f"{label}_{case}"] = _attend(
                lambda q, k, v: ring_attention(q, k, v, mesh=mesh, **kw), inputs)
        perm, inv = _zigzag_perm(inputs["q"].shape[1], n)
        permuted = {name: np.asarray(inputs[name])[:, perm.numpy()]
                    for name in ("q", "k", "v", "cot")}
        got = _attend(lambda q, k, v: ring_attention(
            q, k, v, mesh=mesh, schedule="zigzag", pre_permuted=True), permuted)
        out[f"{label}_pre_permuted"] = {key: val[:, inv.numpy()] for key, val in got.items()}
    return out


# ---------------------------------------------------------------------------
# train


def _adamw(h):
    def tx(params):
        return torch.optim.AdamW(params, lr=h["learning_rate"], betas=(h["b1"], h["b2"]),
                                 eps=h["eps"], weight_decay=h["weight_decay"])

    return tx


def _family(name):
    from torchdistx_tpu_torch.models import convert, gpt2, llama, moe

    return {"llama": (llama, llama.llama_test, convert.llama_from_jax_params),
            "gpt2": (gpt2, gpt2.gpt2_test, convert.gpt2_from_jax_params),
            "moe": (moe, moe.moe_test, convert.moe_from_jax_params)}[name]


def _full_values(family, params_np):
    """The port's ``{name: tensor}`` of the JAX weights."""
    _, cfg, from_jax = _family(family)
    return {k: v.detach().clone() for k, v in
            from_jax(params_np, cfg(), device="cpu").state_dict().items()}


def _load_shards(model, values):
    """Each ``DTensor`` parameter's local shard set from the whole values."""
    from torch.distributed.tensor import distribute_tensor

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.to_local().copy_(distribute_tensor(values[name], p.device_mesh,
                                                 p.placements).to_local())


def _whole(model):
    return {n: p.full_tensor().detach().numpy().copy() for n, p in model.named_parameters()}


Z_LOSS = 1e-3


def ce_z_loss(model, tokens, targets, **kw):
    """A custom ``loss_fn``: mean cross-entropy plus ``Z_LOSS`` times the mean
    squared log-partition, torch ops on the model's logits (a ``DTensor`` on
    a mesh, the targets placed beside them)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    logits = model(tokens, **kw)
    if isinstance(logits, DTensor):
        targets = distribute_tensor(targets, logits.device_mesh, logits.placements,
                                    src_data_rank=None)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + Z_LOSS * (lse * lse).mean()


def _mesh_run(family, spec, inputs, *, steps=3, **kw):
    """``steps`` AdamW steps of ``make_train_step(mesh=)`` from the JAX
    weights on the inputs' batches: losses and the final whole values.
    ``spec``: a ``MeshSpec``, or ``make_mesh``'s ``axis_names`` / ``shape``
    as a dict."""
    from torchdistx_tpu_torch.parallel import make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    fam, cfg, _ = _family(family)
    mesh = (make_mesh(**spec, device_type="cpu") if isinstance(spec, dict)
            else make_mesh(spec, device_type="cpu"))
    init_fn, step_fn = make_train_step(cfg(), _adamw(inputs["adamw"]), model=fam, mesh=mesh,
                                       **kw)
    state = init_fn(0)
    _load_shards(state.model, _full_values(family, inputs[f"{family}_params"]))
    losses = []
    for i in range(steps):
        batch = {k: _t(v) for k, v in inputs["batches"][i].items()}
        state, m = step_fn(state, batch)
        assert m["nonfinite"] is False and m["step"] == i + 1
        losses.append(m["loss"].item())
    return state, mesh, {"losses": losses, "params": _whole(state.model)}


def _single_run(family, inputs, values, steps=3):
    """The same steps on one device (``mesh=None``) from ``values``."""
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    fam, cfg, _ = _family(family)
    init_fn, step_fn = make_train_step(cfg(), _adamw(inputs["adamw"]), model=fam,
                                       device="cpu")
    state = init_fn(0)
    state.model.load_state_dict(values)
    state = type(state)(state.model, _adamw(inputs["adamw"])(state.model.parameters()), 0)
    losses = []
    for i in range(steps):
        state, m = step_fn(state, {k: _t(v) for k, v in inputs["batches"][i].items()})
        losses.append(m["loss"].item())
    return {"losses": losses,
            "params": {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}}


def _placement_checks(state, mesh, family):
    """Parameters, gradients and moments placed by the plan, fitted to the
    mesh; each rank holds only its shards between steps."""
    from torchdistx_tpu_torch.parallel.sharding import fit_shardings
    from torchdistx_tpu_torch.parallel.spmd import whole

    fam, cfg, _ = _family(family)
    model, opt = state.model, state.optimizer
    named = dict(model.named_parameters())
    want = fit_shardings(fam.param_specs(cfg()), {n: tuple(p.shape) for n, p in named.items()},
                         mesh)
    params_placed = all(list(p.placements) == want[n] for n, p in named.items())
    moments_placed = all(
        list(opt.state[p][key].placements) == list(p.placements)
        for p in named.values() for key in ("exp_avg", "exp_avg_sq"))
    local = sum(p.to_local().numel() for p in named.values())
    expect = sum(p.numel() // _shard_count(p) for p in named.values())
    wq, wo = named["layers.0.wq.weight"], named["layers.0.wo.weight"]
    by_name = (wq.shape == wo.shape and list(wq.placements) != list(wo.placements)
               and list(opt.state[wq]["exp_avg"].placements) == list(wq.placements)
               and list(opt.state[wo]["exp_avg"].placements) == list(wo.placements))
    return {"params_placed": params_placed, "moments_placed": moments_placed,
            "local_elements": local, "expected_local_elements": expect,
            "moments_by_name": by_name, "no_grads_held": all(p.grad is None
                                                            for p in named.values()),
            "whole_is_full_tensor": all(torch.equal(whole(p), p.full_tensor())
                                        for p in named.values())}


def _shard_count(p):
    from torch.distributed.tensor import Shard

    n = 1
    for size, pl in zip(p.device_mesh.shape, p.placements):
        if isinstance(pl, Shard):
            n *= size
    return n


def _grad_placements(state, inputs):
    """One more backward (no step): every gradient placed as its
    parameter."""
    model = state.model
    batch = inputs["batches"][0]
    mesh = next(model.parameters()).device_mesh
    model.loss(_t(batch["tokens"]), _t(batch["targets"]), mesh=mesh).backward()
    ok = all(type(p.grad).__name__ == "DTensor" and list(p.grad.placements) == list(p.placements)
             for p in model.parameters())
    model.zero_grad(set_to_none=True)
    return ok


def _nan_on_one_rank(state, inputs, rank):
    """A ``_tdx_nan`` batch on rank 1 only: every rank skips, bit-identical."""
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    mesh = next(state.model.parameters()).device_mesh
    _, step_fn = make_train_step(_family("llama")[1](), _adamw(inputs["adamw"]), mesh=mesh)
    before = [p.to_local().clone() for p in state.model.parameters()]
    moments = [s["exp_avg"].to_local().clone() for s in state.optimizer.state.values()]
    batch = {k: _t(v) for k, v in inputs["batches"][0].items()}
    if rank == 1:
        batch["_tdx_nan"] = True
    new, m = step_fn(state, batch)
    same = (all(torch.equal(a, p.to_local()) for a, p in zip(before, new.model.parameters()))
            and all(torch.equal(a, s["exp_avg"].to_local())
                    for a, s in zip(moments, new.optimizer.state.values())))
    assert m["nonfinite"] is True and new.step == state.step and same, (m, same)
    return True


def _dryrun(inputs):
    """The JAX dry run's ``train_dp_fsdp_tp``, ``flash_sharded`` and
    ``sp_ring`` stages on 4 ranks (the JAX run's split of 4 devices: dp 2,
    fsdp 2, tp 1; sp 4)."""
    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.ops.cuda.flash_attention import flash_attention_sharded
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    cfg = llama_test()
    out = {}
    tx = _adamw({"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
                 "weight_decay": 1e-4})
    mesh = make_mesh(MeshSpec(dp=2, fsdp=2), device_type="cpu")
    tokens = _t(inputs["dry_tokens"])
    init_fn, step_fn = make_train_step(cfg, tx, mesh=mesh)
    _, m = step_fn(init_fn(0), {"tokens": tokens, "targets": tokens})
    out["train_dp_fsdp_tp"] = m["loss"].item()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(8, 32, cfg.n_heads, cfg.head_dim, generator=g, requires_grad=True)
    k = torch.randn(8, 32, cfg.n_kv_heads, cfg.head_dim, generator=g, requires_grad=True)
    v = torch.randn(8, 32, cfg.n_kv_heads, cfg.head_dim, generator=g, requires_grad=True)
    o = flash_attention_sharded(q, k, v, mesh=mesh)
    o.square().sum().backward()
    out["flash_sharded"] = float(o.sum() + q.grad.sum() + k.grad.sum() + v.grad.sum())
    mesh_sp = make_mesh(MeshSpec(sp=4), device_type="cpu")
    tokens = _t(inputs["dry_tokens_sp"])
    init_fn, step_fn = make_train_step(cfg, tx, mesh=mesh_sp, seq_axis="sp", attn_impl="ring")
    _, m = step_fn(init_fn(0), {"tokens": tokens, "targets": tokens})
    out["sp_ring"] = m["loss"].item()
    return out


def suite_eps(rank, world, inputs):
    """ROADMAP C4's measurement: for each AdamW eps of ``inputs["eps"]``,
    the mesh step (Llama under ``fsdp x tp``, MoE under ``dp x fsdp``) and
    the unsharded step (``_single_run``) from the same JAX weights, three
    steps each: losses and final whole values."""
    from torchdistx_tpu_torch.parallel import MeshSpec

    out = {}
    for eps in inputs["eps"]:
        kw = dict(inputs, adamw=dict(inputs["adamw"], eps=eps))
        for family, spec in (("llama", MeshSpec(fsdp=2, tp=2)), ("moe", MeshSpec(dp=2, fsdp=2))):
            _, _, out[f"{family}_mesh_{eps}"] = _mesh_run(family, spec, kw)
            out[f"{family}_single_{eps}"] = _single_run(
                family, kw, _full_values(family, inputs[f"{family}_params"]))
        # The bisection by axis: the batch split alone, tensor parallelism
        # alone (Llama).
        for name, axes in inputs.get("eps_bisect", {}).items():
            _, _, out[f"llama_{name}_{eps}"] = _mesh_run("llama", MeshSpec(**axes), kw)
    return out


def suite_train(rank, world, inputs):
    from torchdistx_tpu_torch.parallel import MeshSpec

    out = {}
    llama_values = _full_values("llama", inputs["llama_params"])
    state, mesh, out["llama_fsdp_tp"] = _mesh_run("llama", MeshSpec(fsdp=2, tp=2), inputs)
    out["placements"] = _placement_checks(state, mesh, "llama")
    out["grads_placed"] = _grad_placements(state, inputs)
    out["nan_skips_everywhere"] = _nan_on_one_rank(state, inputs, rank)
    del state
    out["llama_single"] = _single_run("llama", inputs, llama_values)
    _, _, out["llama_dp_tp"] = _mesh_run("llama", MeshSpec(dp=2, tp=2), inputs)
    _, _, out["llama_named_axes"] = _mesh_run(
        "llama", {"axis_names": ("data", "model"), "shape": (2, 2)}, inputs, fsdp="data",
        tp="model")
    _, _, out["llama_tp_none"] = _mesh_run("llama", MeshSpec(fsdp=2, tp=2), inputs, tp=None)
    _, _, out["llama_custom_loss"] = _mesh_run("llama", MeshSpec(fsdp=2, tp=2), inputs,
                                               loss_fn=ce_z_loss)
    for layout in ("contiguous", "zigzag"):
        _, _, out[f"llama_sp_{layout}"] = _mesh_run(
            "llama", MeshSpec(fsdp=2, sp=2), inputs, seq_axis="sp", seq_layout=layout)
    _, _, out["gpt2_fsdp_tp"] = _mesh_run("gpt2", MeshSpec(fsdp=2, tp=2), inputs)
    _, _, out["moe_dp_fsdp"] = _mesh_run("moe", MeshSpec(dp=2, fsdp=2), inputs)
    out["dryrun"] = _dryrun(inputs)
    if "eps" in inputs:
        out["eps"] = suite_eps(rank, world, inputs)
    return out


SUITES = {"attention": suite_attention, "ring": suite_ring, "train": suite_train,
          "eps": suite_eps}


def main(suite, rank, world, store, out_path, in_path):
    torch.set_num_threads(1)  # the ranks share the host's cores
    torch.set_num_interop_threads(1)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        out = SUITES[suite](rank, world, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
