"""The port's seeded materializer (``materialize_tensor_torch``,
``materialize_module_torch``) against the JAX package's
``materialize_tensor_jax`` / ``materialize_module_jax``, on the CPU.

Deterministic tapes (no random op) are held exactly against JAX: the same
recorded ops give the same values.  Random draws differ by design (threefry
in JAX, mt19937 or Philox here), so where values come from an RNG the tests
hold statistics and properties: order independence, reproducibility across
recordings, distinct streams.  The slice as a whole (``llama_test``
recorded, materialized by the port, forward and one SGD step) is held
against the JAX model on the same weights at 1e-5 (float32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import torchdistx_tpu.deferred_init as jdi
from torchdistx_tpu.materialize import materialize_module_jax, materialize_tensor_jax
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch import deferred_init as tdi
from torchdistx_tpu_torch.materialize import (
    materialize_module_torch,
    materialize_tensor_torch,
    stream_seed,
)
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import llama_to_jax_params

ATOL = 1e-5
CPU = dict(device="cpu")


def _both(build):
    """``build`` recorded once under each package's deferred-init context."""
    with jdi._deferred_init_context():
        j = build()
    with tdi._deferred_init_context():
        t = build()
    return j, t


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# -- deterministic tapes, exact against JAX ------------------------------------


def _fill_chain():
    t = torch.zeros(4, 4)
    t.add_(1)
    t.mul_(3)
    return t


def _view_and_inplace():
    base = torch.zeros(2, 4)
    row = base[1]
    row.fill_(7)
    base.mul_(2)
    return base


def _arange_transpose():
    t = torch.arange(12.0).view(3, 4)
    return nn.Parameter((t * 2).t().contiguous())


@pytest.mark.parametrize("build", [_fill_chain, _view_and_inplace, _arange_transpose])
def test_deterministic_tapes_match_jax(build):
    j, t = _both(build)
    want = np.asarray(materialize_tensor_jax(j))
    got = materialize_tensor_torch(t, **CPU)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)
    # The in-place replay of the same tape agrees too.
    np.testing.assert_array_equal(_np(tdi.materialize_tensor(t)), want)


class _Holder(nn.Module):
    pass


def _aliased(with_linear):
    def build():
        t = torch.zeros(4)
        u = t + 1
        t.add_(5)
        mod = _Holder()
        mod.t = nn.Parameter(t)
        mod.u = nn.Parameter(u)
        if with_linear:
            mod.lin = nn.Linear(4, 4)
        return mod
    return build


@pytest.mark.parametrize("with_linear", [False, True], ids=["aliasing", "aliasing_and_linear"])
def test_aliased_params_match_jax(with_linear):
    j, t = _both(_aliased(with_linear))
    want = materialize_module_jax(j)
    got = materialize_module_torch(t, **CPU)
    assert set(got) == set(want)
    assert list(got) == [n for n, _ in t.named_parameters()]  # parameters in naming order
    for name in ("t", "u"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]))
    np.testing.assert_array_equal(_np(got["t"]), np.full(4, 5.0))
    np.testing.assert_array_equal(_np(got["u"]), np.ones(4))
    if with_linear:
        assert got["lin.weight"].shape == tuple(want["lin.weight"].shape)


class _Ramp(nn.Module):
    """A module whose parameters come from deterministic ops only."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.arange(32.0).view(4, 8) / 7)
        self.b = nn.Parameter(torch.full((8,), 1.0 / 3))
        self.register_buffer("steps", torch.arange(5.0) * 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dtype_override_matches_jax(dtype):
    with jdi._deferred_init_context():
        j = _Ramp()
    with tdi._deferred_init_context():
        t = _Ramp()
    want = materialize_module_jax(j, dtype=dtype)
    got = materialize_module_torch(t, dtype=dtype, **CPU)
    assert list(got) == ["w", "b", "steps"] and set(want) == set(got)
    for name in got:
        assert got[name].dtype == dtype
        assert str(want[name].dtype) == str(dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name], np.float32))
    lin = tdi.deferred_init(nn.Linear, 32, 16)
    assert materialize_module_torch(lin, dtype=dtype, **CPU)["weight"].dtype == dtype


# -- random tapes: statistics and properties ----------------------------------


def test_linear_statistics():
    m = tdi.deferred_init(nn.Linear, 128, 64)
    out = materialize_module_torch(m, **CPU)
    assert list(out) == ["weight", "bias"]
    w = out["weight"]
    assert w.shape == (64, 128) and not w.requires_grad
    bound = (1 / 128) ** 0.5 * (3**0.5)
    assert w.abs().max().item() <= bound + 1e-6
    assert w.std().item() > 0.5 * bound / (3**0.5)
    assert all(tdi.is_deferred(p) for p in m.parameters())  # the module is untouched


def test_rng_order_independence():
    m = tdi.deferred_init(nn.Linear, 16, 8)
    both = materialize_module_torch(m, seed=3, **CPU)
    w_only = materialize_tensor_torch(m.weight, seed=3, **CPU)
    b_only = materialize_tensor_torch(m.bias, seed=3, **CPU)
    assert torch.equal(both["weight"], w_only) and torch.equal(both["bias"], b_only)
    # The reverse order gives the same values.
    assert torch.equal(materialize_tensor_torch(m.weight, seed=3, **CPU), w_only)


def test_guard_failure():
    ext = torch.ones(4)
    with tdi._deferred_init_context():
        t = torch.zeros(4)
        u = t + ext
    ext.add_(1)
    with pytest.raises(RuntimeError, match="mutated after recording"):
        materialize_tensor_torch(u, **CPU)


def test_cross_tape_module_is_distinct():
    m1 = tdi.deferred_init(nn.Linear, 4, 4)
    m2 = tdi.deferred_init(nn.Linear, 4, 4)
    out = materialize_module_torch(nn.Sequential(m1, m2), **CPU)
    assert list(out) == ["0.weight", "0.bias", "1.weight", "1.bias"]
    assert not torch.equal(out["0.weight"], out["1.weight"])


class _DeepModel(nn.Module):
    def __init__(self, depth=6, dim=32):
        super().__init__()
        self.emb = nn.Embedding(100, dim)
        self.blocks = nn.ModuleList([nn.Linear(dim, dim) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim)


def test_cross_tape_reproducibility_and_distinct_streams():
    a1 = materialize_module_torch(tdi.deferred_init(_DeepModel), seed=5, **CPU)
    a2 = materialize_module_torch(tdi.deferred_init(_DeepModel), seed=5, **CPU)
    assert list(a1) == list(a2)
    for k in a1:
        assert torch.equal(a1[k], a2[k]), k
    # Same-shaped parameters draw distinct streams; another seed differs.
    assert not torch.equal(a1["blocks.0.weight"], a1["blocks.1.weight"])
    a3 = materialize_module_torch(tdi.deferred_init(_DeepModel), seed=6, **CPU)
    assert not torch.equal(a1["blocks.0.weight"], a3["blocks.0.weight"])
    assert torch.equal(a1["norm.weight"], a3["norm.weight"])  # ones, no RNG


def test_stream_seed_keys_on_relative_numbers():
    seeds = {stream_seed(s, o, r) for s in (0, 1) for o in (0, 1) for r in range(50)}
    assert len(seeds) == 200 and all(0 <= x < 2**64 for x in seeds)
    assert stream_seed(-1, 0, 0) == stream_seed(2**64 - 1, 0, 0)


class _TwoNormals(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.empty(256, 256))
        self.b = nn.Parameter(torch.empty(256, 256))
        with torch.no_grad():
            nn.init.normal_(self.a, 0.0, 0.02)
            nn.init.normal_(self.b, 0.0, 1.0)


def test_fill_scalars_per_member():
    # Two same-shaped normal_ fills with different std keep their own.
    out = materialize_module_torch(tdi.deferred_init(_TwoNormals), **CPU)
    assert abs(out["a"].std().item() / 0.02 - 1) < 0.02
    assert abs(out["b"].std().item() - 1) < 0.02


def test_random_op_without_generator_raises():
    with tdi._deferred_init_context():
        z = torch.zeros(8)
        y = torch.ops.aten.native_dropout.default(z, 0.5, True)[0]
    with pytest.raises(NotImplementedError, match="native_dropout"):
        materialize_tensor_torch(y, **CPU)


def test_random_factories_take_generator_overloads():
    with tdi._deferred_init_context():
        made = [torch.randn(6), torch.rand(6), torch.randint(0, 9, (6,)), torch.randperm(6)]
    for t in made:
        a = materialize_tensor_torch(t, seed=2, **CPU)
        b = materialize_tensor_torch(t, seed=2, **CPU)
        assert torch.equal(a, b) and a.shape == (6,)
    assert sorted(materialize_tensor_torch(made[3], **CPU).tolist()) == list(range(6))


def test_calls_do_not_disturb_each_other():
    m = tdi.deferred_init(_DeepModel, depth=2, dim=16)
    first = materialize_module_torch(m, seed=1, **CPU)
    kept = {k: v.clone() for k, v in first.items()}
    other = materialize_module_torch(m, seed=2, dtype=torch.bfloat16, **CPU)
    again = materialize_module_torch(m, seed=1, **CPU)
    for k in kept:
        assert torch.equal(first[k], kept[k]) and torch.equal(again[k], kept[k]), k
        assert other[k].dtype == torch.bfloat16
    # The tape's own replay cache stays empty: materialize_module still works.
    assert not any(n.op.replayed for n in _nodes(m))
    tdi.materialize_module(m, device="cpu")
    assert not any(tdi.is_deferred(p) for p in m.parameters())


def _nodes(module):
    from torchdistx_tpu_torch import _tape

    out = []
    for p in module.parameters():
        out += _tape.build_call_stack(p._slots["deferred_init"].node)
    return out


def test_telemetry_spans_and_counter():
    telemetry.configure(collect=True)
    telemetry.reset()
    try:
        m = tdi.deferred_init(nn.Linear, 8, 4)
        materialize_module_torch(m, **CPU)
        materialize_tensor_torch(m.weight, **CPU)
        ext = torch.ones(2)
        with tdi._deferred_init_context():
            bad = _Holder()
            bad.p = nn.Parameter(torch.zeros(2) + ext)
        ext.add_(1)
        with pytest.raises(RuntimeError):
            materialize_module_torch(bad, **CPU)
        snap = telemetry.snapshot()
    finally:
        telemetry.configure(collect=False)
        telemetry.reset()
    assert snap["counters"]["materialize.calls"] == 2
    spans = [(s["name"], s.get("attrs", {})) for s in snap["spans"]]
    assert ("materialize.module", {"n_params": 2}) in spans
    assert ("materialize.module", {"error": "RuntimeError"}) in spans
    assert any(name == "materialize.tensor" for name, _ in spans)


def test_entry_points_refuse_what_they_cannot_take():
    with pytest.raises(ValueError, match="not a deferred fake tensor"):
        materialize_tensor_torch(torch.zeros(2), **CPU)
    assert materialize_module_torch(nn.Linear(2, 2), **CPU) == {}


# -- the slice as a whole -------------------------------------------------------


def test_llama_test_slice_matches_jax():
    # Record llama_test, materialize it with the port (seed 1, on the CPU),
    # load it by assignment, and hold its forward and one SGD step against
    # the JAX model on the same weights (float32, 1e-5).
    cfg = tllama.llama_test()
    model = tdi.deferred_init(tllama.Llama, cfg, device_="cuda")
    values = materialize_module_torch(model, seed=1, **CPU)
    assert set(values) == {n for n, _ in model.named_parameters()}
    model.load_state_dict(values, assign=True)
    assert all(isinstance(p, nn.Parameter) and p.requires_grad and not tdi.is_deferred(p)
               for p in model.parameters())
    assert model.embed.weight is not None and model.embed.weight.data_ptr() == \
        values["embed.weight"].data_ptr()  # assigned, not copied
    std = values["layers.0.wq.weight"].std().item()
    assert abs(std / 0.02 - 1) < 0.1
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    assert abs(values["layers.0.wo.weight"].std().item() / resid - 1) < 0.1

    params = jax.tree.map(jnp.asarray, llama_to_jax_params(model))
    jcfg = jllama.llama_test()
    rng = np.random.default_rng(3)
    tokens, targets = rng.integers(0, 256, (2, 16)), rng.integers(0, 256, (2, 16))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    want = jllama.forward(params, jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    lr = 0.1
    j_loss, j_grads = jax.value_and_grad(jllama.loss_fn)(
        params, jnp.asarray(tokens), jnp.asarray(targets), jcfg
    )
    j_params = jax.tree.map(lambda p, g: p - lr * g, params, j_grads)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    loss = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL, rtol=0)
    got = llama_to_jax_params(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(j_params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


def test_placements_follow_the_mesh_order():
    # Mesh dim i is Shard(d) when its axis is in spec entry d; a tuple entry
    # must list its axes in the mesh's order (else DTensor would need
    # strided sharding), which raises.
    from torch.distributed.tensor import Replicate, Shard

    from torchdistx_tpu_torch.parallel import MeshSpec, PartitionSpec
    from torchdistx_tpu_torch.parallel.sharding import spec_placements as _placements

    mesh = MeshSpec(dp=2, fsdp=2, tp=2)
    assert _placements(PartitionSpec("tp", "fsdp"), mesh, 2) == [Replicate(), Shard(1), Shard(0)]
    assert _placements(PartitionSpec(("fsdp", "tp")), mesh, 2) == [Replicate(), Shard(0), Shard(0)]
    assert _placements(PartitionSpec(), mesh, 2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        _placements(PartitionSpec(("tp", "fsdp")), mesh, 1)
