"""The port's MoE against the JAX MoE on ``moe_test`` (2 layers, dim 64, 4/2
heads, 4 experts, top-2, float32): weights and inputs made with numpy (or
the JAX ``init_params`` weights through numpy).

Tolerance: ``moe_ffn``'s output atol 1e-5 and its aux loss 1e-6; logits,
aux, loss, gradients and parameters after three optimizer steps 1e-5
(float32, the same arithmetic summed in different orders).  Routing is
integer bookkeeping and exact: the experts each token picks (ties to the
lower expert, as ``jax.lax.top_k``), each choice's buffer position and
which choices are dropped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import moe as jmoe
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.models import moe as tmoe
from torchdistx_tpu_torch.models.convert import (
    copy_jax_params_,
    moe_from_jax_params,
    moe_to_jax_params,
)
from torchdistx_tpu_torch.parallel.train_step import make_train_step

ATOL = 1e-5
AUX_ATOL = 1e-6
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _cfgs(**changes):
    return (dataclasses.replace(jmoe.moe_test(), **changes),
            dataclasses.replace(tmoe.moe_test(), **changes))


def _ffn_inputs(cfg, seed, zero_router=False):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    h = rng.standard_normal((2, 8, d)).astype(np.float32)
    router = np.zeros((d, e), np.float32) if zero_router else rand(d, e)
    return h, router, rand(e, d, f), rand(e, d, f), rand(e, f, d)


def _jax_routing(h, router, cfg):
    """The JAX moe_ffn's routing, step for step: (experts, pos, keep)."""
    t, k, e = h.shape[0] * h.shape[1], cfg.experts_per_token, cfg.n_experts
    probs = jax.nn.softmax((jnp.asarray(h).reshape(t, -1) @ router).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1)
    keep = pos < jmoe._capacity(cfg, t)
    return np.asarray(idx), np.asarray(pos).reshape(t, k), np.asarray(keep).reshape(t, k)


def _port_ffn(inputs, cfg):
    h, router, eg, eu, ed = (torch.from_numpy(x) for x in inputs)
    return tmoe.moe_ffn(h, router.T, eg, eu, ed, cfg)


@pytest.mark.parametrize("factor, drops", [(4.0, False), (0.5, True)],
                         ids=["ample", "dropping"])
def test_moe_ffn_matches_jax(factor, drops):
    jcfg, tcfg = _cfgs(capacity_factor=factor)
    inputs = _ffn_inputs(jcfg, seed=1)
    want, want_aux = jmoe.moe_ffn(*(jnp.asarray(x) for x in inputs), jcfg)
    got, aux = _port_ffn(inputs, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=AUX_ATOL, rtol=0)

    h, router = inputs[:2]
    experts, pos, keep = _jax_routing(h, router, jcfg)
    r = tmoe.route(torch.from_numpy(h), torch.from_numpy(router).T, tcfg)
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == jmoe._capacity(jcfg, 16)
    assert bool((~keep).any()) == drops


def test_zero_router_ties_pick_the_lower_experts():
    # Uniform probabilities: jax.lax.top_k returns experts 0..k-1 for every
    # token (torch.topk does not promise that order); the port must too.
    jcfg, tcfg = _cfgs(capacity_factor=0.75)
    inputs = _ffn_inputs(jcfg, seed=2, zero_router=True)
    experts, pos, keep = _jax_routing(*inputs[:2], jcfg)
    assert (experts == np.arange(jcfg.experts_per_token)).all()
    r = tmoe.route(torch.from_numpy(inputs[0]), torch.from_numpy(inputs[1]).T, tcfg)
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert int((~r.keep).sum()) == int((~keep).sum()) > 0
    want, want_aux = jmoe.moe_ffn(*(jnp.asarray(x) for x in inputs), jcfg)
    got, aux = _port_ffn(inputs, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=AUX_ATOL, rtol=0)


def test_fully_dropped_tokens_get_zero_output():
    # A choice over capacity contributes nothing: a token whose every
    # choice was dropped leaves the FFN as zeros.
    _, tcfg = _cfgs(capacity_factor=0.5)
    inputs = [torch.from_numpy(x) for x in _ffn_inputs(tcfg, seed=3)]
    h = inputs[0]
    out, _ = tmoe.moe_ffn(h, inputs[1].T, *inputs[2:], tcfg)
    r = tmoe.route(h, inputs[1].T, tcfg)
    dropped = (~r.keep).all(dim=1).reshape(h.shape[:2])
    assert bool(dropped.any())
    torch.testing.assert_close(out[dropped], torch.zeros_like(out[dropped]), atol=0, rtol=0)


@pytest.fixture(scope="module")
def pair():
    cfg = jmoe.moe_test()
    params = jmoe.init_params(jax.random.PRNGKey(0), cfg)
    model = moe_from_jax_params(jax.tree.map(np.asarray, params), tmoe.moe_test(),
                                device="cpu")
    return cfg, params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def test_config_sizes_and_specs_match():
    j, t = jmoe.moe_test(), tmoe.moe_test()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
              "n_experts", "experts_per_token", "capacity_factor", "router_aux_coef",
              "remat"):
        assert getattr(j, f) == getattr(t, f), f
    for jc, tc in ((j, t), (jmoe.MoEConfig(), tmoe.MoEConfig()),
                   (jmoe.MoEConfig(n_layers=4), tmoe.MoEConfig(n_layers=4))):
        assert tmoe.num_params(tc) == jmoe.num_params(jc)
    assert tmoe.num_params(tmoe.MoEConfig(n_layers=4)) == 4_859_269_120
    model = tmoe.MoE(t, device="meta")
    assert sum(p.numel() for p in model.parameters()) == tmoe.num_params(t)
    # The JAX specs, stacked layer entry dropped; nn.Linear weights (all but
    # the experts, which keep the JAX layout) with their matrix dims swapped.
    jspecs = jmoe.param_specs(j)
    expected = {"embed.weight": tuple(jspecs["embed"]["weight"]),
                "norm.weight": tuple(jspecs["norm"]["weight"]),
                "lm_head.weight": tuple(jspecs["lm_head"]["weight"])[::-1]}
    for i in range(t.n_layers):
        for key, spec in jspecs["layers"].items():
            entries = list(spec)[1:]
            if key.startswith("e_"):
                expected[f"layers.{i}.{key}"] = tuple(entries)
            else:
                expected[f"layers.{i}.{key}.weight"] = tuple(entries[::-1])
    tspecs = tmoe.param_specs(t)
    assert set(tspecs) == set(expected) == {n for n, _ in model.named_parameters()}
    for name, spec in tspecs.items():
        assert tuple(spec) == expected[name], name


def test_forward_with_aux_matches_jax(pair):
    cfg, params, model = pair
    tokens = _tokens((2, 24), seed=1)
    want, want_aux = jmoe.forward(params, jnp.asarray(tokens), cfg, attn_impl="jnp",
                                  return_aux=True)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens), return_aux=True)
        plain = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=AUX_ATOL, rtol=0)
    assert torch.equal(plain, got)


def test_loss_and_grads_match_jax(pair):
    cfg, params, _ = pair
    model = moe_from_jax_params(jax.tree.map(np.asarray, params), tmoe.moe_test(),
                                device="cpu")
    tokens, targets = _tokens((2, 16), seed=2), _tokens((2, 16), seed=3)
    j_loss, j_grads = jax.value_and_grad(jmoe.loss_fn)(
        params, jnp.asarray(tokens), jnp.asarray(targets), cfg, attn_impl="jnp")
    loss = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL, rtol=0)
    loss.backward()
    got = moe_to_jax_params(model, grads=True)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    for (path, g), w in zip(flat_got, jax.tree.leaves(j_grads), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_gradients(pair, monkeypatch):
    # See tests/test_torch_llama.py: with the JAX package imported,
    # torch.utils.checkpoint must be pinned to the CPU.
    monkeypatch.setattr(torch.utils.checkpoint.DefaultDeviceType, "_default_device_type",
                        "cpu")
    _, params, _ = pair
    tokens, targets = (torch.from_numpy(_tokens((2, 16), seed=s)) for s in (4, 5))
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tmoe.moe_test(), remat=remat)
        model = moe_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
        model.loss(tokens, targets).backward()
        grads.append([p.grad for p in model.parameters()])
    for off, on in zip(*grads):
        assert torch.equal(off, on)


def test_three_adamw_steps_match_jax_make_train_step():
    cfg = jmoe.moe_test()
    mesh = jax_make_mesh(JaxMeshSpec(), devices=jax.devices()[:1])
    j_init, j_step = jts.make_train_step(cfg, mesh, optax.adamw(**ADAMW), model=jmoe)
    j_state = j_init(jax.random.PRNGKey(0))
    h = ADAMW
    t_init, t_step = make_train_step(
        tmoe.moe_test(),
        lambda ps: torch.optim.AdamW(ps, lr=h["learning_rate"], betas=(h["b1"], h["b2"]),
                                     eps=h["eps"], weight_decay=h["weight_decay"]),
        model=tmoe, device="cpu")
    t_state = t_init(0)
    assert isinstance(t_state.model, tmoe.MoE)
    copy_jax_params_(t_state.model, jax.tree.map(np.asarray, j_state.params))
    sharding = jts.batch_sharding(mesh)
    for i in range(3):
        tokens, targets = _tokens((2, 16), 10 + i), _tokens((2, 16), 20 + i)
        j_state, j_m = j_step(j_state, {"tokens": jax.device_put(tokens, sharding),
                                        "targets": jax.device_put(targets, sharding)})
        t_state, t_m = t_step(t_state, {"tokens": torch.from_numpy(tokens),
                                        "targets": torch.from_numpy(targets)})
        np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]), atol=ATOL, rtol=0,
                                   err_msg=f"step {i + 1}")
        assert t_m["step"] == int(j_m["step"]) == i + 1
    got = moe_to_jax_params(t_state.model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(j_state.params), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
