"""Deferred init in the port: the Llama built fake on a claimed ``cuda``
device on a host without CUDA, its materialization, its initialization
statistics, and cases of the JAX package's fake / deferred-init tests run
against the port's own copies."""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn

import torchdistx_tpu_torch.deferred_init as di
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu_torch import fake
from torchdistx_tpu_torch.deferred_init import (
    deferred_init,
    is_deferred,
    materialize_module,
    materialize_tensor,
)
from torchdistx_tpu_torch.models import llama as tllama

CFG = tllama.llama_test()


def _deferred_llama():
    return deferred_init(tllama.Llama, CFG, device_="cuda")


def test_llama_builds_fake_on_claimed_cuda():
    model = _deferred_llama()
    params = list(model.parameters())
    assert len(params) == 2 + 1 + CFG.n_layers * 9
    for p in params:
        assert is_deferred(p) and fake.is_fake(p)
        assert p.device.type == "cuda"
    assert sum(p.numel() for p in params) == tllama.num_params(CFG)


def test_materialize_on_cpu_gives_jax_shapes():
    model = materialize_module(_deferred_llama(), device="cpu")
    shapes = jllama._shapes(jllama.llama_test())
    lay = shapes["layers"]
    assert tuple(model.embed.weight.shape) == shapes["embed"]["weight"]
    assert tuple(model.norm.weight.shape) == shapes["norm"]["weight"]
    # nn.Linear keeps (out, in): the JAX (in, out) transposed.
    assert tuple(model.lm_head.weight.shape) == shapes["lm_head"]["weight"][::-1]
    for blk in model.layers:
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert tuple(getattr(blk, key).weight.shape) == lay[key][1:][::-1], key
        assert tuple(blk.attn_norm.weight.shape) == lay["attn_norm"][1:]
    for p in model.parameters():
        assert not fake.is_fake(p) and p.device.type == "cpu"
        assert isinstance(p, nn.Parameter)


def test_materialize_on_absent_cuda_raises():
    # A cuda claim replays on cuda: with no CUDA here it raises rather than
    # quietly landing on the CPU.
    with pytest.raises((RuntimeError, AssertionError)):
        materialize_module(_deferred_llama())


def _big_cfg():
    # Wide enough for tight statistics, small enough for the CPU.
    return tllama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, max_seq_len=64, dtype=torch.float32,
    )


def test_init_statistics():
    cfg = _big_cfg()
    torch.manual_seed(0)
    model = materialize_module(
        deferred_init(tllama.Llama, cfg, device_="cuda"), device="cpu"
    )
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    checks = [(model.embed.weight, 0.02), (model.lm_head.weight, 0.02)]
    for blk in model.layers:
        checks += [(getattr(blk, k).weight, 0.02)
                   for k in ("wq", "wk", "wv", "w_gate", "w_up")]
        checks += [(blk.wo.weight, resid), (blk.w_down.weight, resid)]
        for norm in (blk.attn_norm, blk.mlp_norm):
            assert torch.equal(norm.weight, torch.ones_like(norm.weight))
    assert torch.equal(model.norm.weight, torch.ones_like(model.norm.weight))
    for w, std in checks:
        assert abs(w.std().item() - std) < 0.1 * std
        assert abs(w.mean().item()) < 0.1 * std


def test_same_seed_same_values():
    def build(seed):
        torch.manual_seed(seed)
        return materialize_module(_deferred_llama(), device="cpu")

    a, b, c = build(5), build(5), build(6)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if "norm" not in name:
            assert not torch.equal(pa, pc), name


def test_materialized_llama_runs():
    torch.manual_seed(0)
    model = materialize_module(_deferred_llama(), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    with torch.no_grad():
        logits = model(tokens)
    assert logits.shape == (2, 9, 256) and torch.isfinite(logits).all()


# --- Cases of tests/test_fake.py and tests/test_deferred_init.py, run on the
# port's copies.


def _case_fake_cuda_without_cuda():
    with fake.fake_mode(fake_cuda=True):
        t = torch.ones([10], device="cuda")
    assert fake.is_fake(t) and t.device.type == "cuda"


def _case_ops_on_fake_outside_mode():
    with fake.fake_mode():
        t = torch.ones([4, 8])
    u = t @ t.t()
    assert fake.is_fake(u) and u.shape == (4, 4)


def _case_no_storage_allocation():
    with fake.fake_mode(device="cuda"):
        t = torch.empty([1 << 16, 1 << 16])  # 16 GiB if real
    assert fake.is_fake(t) and t.device.type == "cuda"
    with pytest.raises(RuntimeError, match="not allocated|invalid python storage"):
        t.untyped_storage().data_ptr()


def _case_mixed_devices_error():
    with fake.fake_mode():
        a = torch.ones(2)
        b = torch.ones(2, device="cuda")
    with pytest.raises(RuntimeError, match="mixed devices"):
        a + b


def _case_meta_like():
    with fake.fake_mode():
        t = torch.ones([3, 5])
    m = fake.meta_like(t)
    assert m.device.type == "meta" and m.shape == (3, 5)
    with pytest.raises(ValueError):
        fake.meta_like(torch.ones(2))


def _case_materialize_twice_same_object():
    m = deferred_init(nn.Linear, 5, 3)
    assert materialize_tensor(m.weight) is materialize_tensor(m.weight)


def _case_rng_replay_bitwise():
    torch.manual_seed(42)
    m1 = deferred_init(nn.Linear, 16, 8)
    torch.manual_seed(42)
    materialize_module(m1)
    torch.manual_seed(42)
    m2 = nn.Linear(16, 8)
    assert torch.equal(m1.weight, m2.weight) and torch.equal(m1.bias, m2.bias)


def _case_view_aliasing_mutation():
    with di._deferred_init_context():
        base = torch.zeros(2, 4)
        row = base[1]
        row.fill_(7)
        base.mul_(2)
    assert torch.equal(
        materialize_tensor(base), torch.tensor([[0.0] * 4, [14.0] * 4])
    )
    assert torch.equal(materialize_tensor(row), torch.tensor([14.0] * 4))


def _case_mutation_after_target():
    with di._deferred_init_context():
        t = torch.ones(3)
        t.view(3).add_(5)
    assert torch.equal(materialize_tensor(t), torch.full((3,), 6.0))


def _case_external_version_guard():
    ext = torch.ones(4)
    with di._deferred_init_context():
        u = torch.zeros(4) + ext
    ext.add_(1)
    with pytest.raises(RuntimeError, match="mutated after recording"):
        materialize_tensor(u)


def _case_terminal_op():
    with di._deferred_init_context():
        assert torch.full((1,), 3.0).item() == 3.0


def _case_claimed_cuda_replayed_on_cpu():
    m = deferred_init(nn.Linear, 8, 4, device_="cuda")
    assert m.weight.device.type == "cuda" and is_deferred(m.weight)
    materialize_module(m, device="cpu")
    assert m.weight.device.type == "cpu" and m.weight.shape == (4, 8)


def _case_buffers_only_and_check_fn():
    m = deferred_init(nn.BatchNorm1d, 10)
    materialize_module(m, buffers_only=True)
    assert not fake.is_fake(m.running_mean) and fake.is_fake(m.weight)
    seq = deferred_init(lambda: nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 4)))
    first = seq[0]
    materialize_module(seq, check_fn=lambda mod: mod is not first)
    assert fake.is_fake(seq[0].weight) and not fake.is_fake(seq[1].weight)


def _case_order_independent_aliasing():
    class M(nn.Module):
        pass

    with di._deferred_init_context():
        t = torch.zeros(4)
        u = t + 1
        t.add_(5)
        mod = M()
        mod.t = nn.Parameter(t)
        mod.u = nn.Parameter(u)
    materialize_module(mod)
    assert torch.equal(mod.t.detach(), torch.full((4,), 5.0))
    assert torch.equal(mod.u.detach(), torch.ones(4))


def _case_fake_created_outside_rejected():
    with fake.fake_mode():
        t = torch.ones(3)
    with di._deferred_init_context():
        with pytest.raises(RuntimeError, match="outside of a deferred-init"):
            t.add_(1)


_CASES = {
    name[len("_case_"):]: fn
    for name, fn in list(globals().items())
    if name.startswith("_case_")
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ported_fake_and_deferred_cases(case):
    _CASES[case]()
