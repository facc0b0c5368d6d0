"""The port's GPT-2 against the JAX GPT-2 on ``gpt2_test`` (2 layers, dim 64,
4 heads, float32): the JAX ``init_params`` weights go through numpy into
:func:`gpt2_from_jax_params`, token ids are made with numpy.

Tolerance: atol 1e-5 on float32 logits, losses, gradients and parameters
after three optimizer steps (the same arithmetic summed in different
orders); greedy ``generate`` token-identical; ``num_params`` and the
partition specs equal.  Random init is held by its moments (threefry and
Philox draw different values), seeded materialization by reproducibility.
The SlowMo step over GPT-2 runs on 2 gloo ranks in subprocesses
(``_torch_slowmo_child.py``, suite ``step``) against JAX's on a ``dp=2``
mesh of virtual CPU devices, 1e-5, replicas bit-equal after averaging only.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models.generate import generate as jax_generate
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu.parallel.slowmo import SlowMomentumOptimizer as JaxSlowMo
from torchdistx_tpu_torch import deferred_init as tdi
from torchdistx_tpu_torch.materialize import materialize_module_torch
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models.convert import (
    copy_jax_params_,
    gpt2_from_jax_params,
    gpt2_to_jax_params,
)
from torchdistx_tpu_torch.models.generate import generate
from torchdistx_tpu_torch.parallel.train_step import make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_slowmo_child import _flat, launch, wait  # noqa: E402

ATOL = 1e-5
NEW = 16
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


@pytest.fixture(scope="module")
def pair():
    cfg = jgpt2.gpt2_test()
    params = jgpt2.init_params(jax.random.PRNGKey(0), cfg)
    model = gpt2_from_jax_params(jax.tree.map(np.asarray, params), tgpt2.gpt2_test(),
                                 device="cpu")
    return cfg, params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _assert_trees_close(got, want, atol=ATOL):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_config_fields_and_sizes_match():
    j, t = jgpt2.gpt2_test(), tgpt2.gpt2_test()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "max_seq_len", "norm_eps",
              "head_dim", "ffn_dim", "remat"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.float32
    for name in ("gpt2_test", "gpt2_small", "gpt2_xl"):
        jc, tc = getattr(jgpt2, name)(), getattr(tgpt2, name)()
        assert tgpt2.num_params(tc) == jgpt2.num_params(jc), name
        assert (tc.dim, tc.n_layers, tc.n_heads, tc.remat) == \
            (jc.dim, jc.n_layers, jc.n_heads, jc.remat), name
    assert tgpt2.num_params(tgpt2.gpt2_xl()) == 1_557_611_200
    assert tgpt2.gpt2_xl().dtype == torch.bfloat16 and tgpt2.gpt2_xl().head_dim == 64
    model = tgpt2.GPT2(tgpt2.gpt2_test(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == tgpt2.num_params(tgpt2.gpt2_test())


def test_param_specs_match_jax_leaf_by_leaf():
    # JAX leaves are stacked (L, in, out): drop the layer entry and swap the
    # matrix dims of the weights that nn.Linear stores (out, in).
    cfg = tgpt2.gpt2_test()
    jspecs = jgpt2.param_specs(jgpt2.gpt2_test())
    tspecs = tgpt2.param_specs(cfg)
    expected = {"wte.weight": tuple(jspecs["wte"]["weight"]),
                "wpe.weight": tuple(jspecs["wpe"]["weight"]),
                "ln_f.weight": tuple(jspecs["ln_f"]["scale"]),
                "ln_f.bias": tuple(jspecs["ln_f"]["bias"])}
    for i in range(cfg.n_layers):
        for key, leaves in jspecs["layers"].items():
            for leaf, spec in leaves.items():
                entries = list(spec)[1:]
                if leaf == "weight":
                    entries = entries[::-1]
                name = "weight" if leaf == "scale" else leaf
                expected[f"layers.{i}.{key}.{name}"] = tuple(entries)
    model = tgpt2.GPT2(cfg, device="meta")
    assert set(tspecs) == set(expected) == {n for n, _ in model.named_parameters()}
    for name, spec in tspecs.items():
        assert tuple(spec) == expected[name], name


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
def test_forward_matches_jax(pair, jax_impl):
    cfg, params, model = pair
    tokens = _tokens((2, 24), seed=1)
    want = np.asarray(jgpt2.forward(params, jnp.asarray(tokens), cfg, attn_impl=jax_impl))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_loss_and_grads_match_jax(pair):
    cfg, params, _ = pair
    model = gpt2_from_jax_params(jax.tree.map(np.asarray, params), tgpt2.gpt2_test(),
                                 device="cpu")
    tokens, targets = _tokens((2, 16), seed=2), _tokens((2, 16), seed=3)
    j_loss, j_grads = jax.value_and_grad(jgpt2.loss_fn)(
        params, jnp.asarray(tokens), jnp.asarray(targets), cfg, attn_impl="jnp")
    loss = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL, rtol=0)
    loss.backward()
    _assert_trees_close(gpt2_to_jax_params(model, grads=True), j_grads)


def test_remat_gives_the_same_gradients(pair, monkeypatch):
    # See tests/test_torch_llama.py: with the JAX package imported,
    # torch.utils.checkpoint must be pinned to the CPU.
    monkeypatch.setattr(torch.utils.checkpoint.DefaultDeviceType, "_default_device_type",
                        "cpu")
    _, params, _ = pair
    tokens, targets = (torch.from_numpy(_tokens((2, 16), seed=s)) for s in (6, 7))
    grads = []
    for remat in (False, True):
        cfg = tgpt2.GPT2Config(**{**tgpt2.gpt2_test().__dict__, "remat": remat})
        model = gpt2_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
        model.loss(tokens, targets).backward()
        grads.append([p.grad for p in model.parameters()])
    for off, on in zip(*grads):
        assert torch.equal(off, on)


def test_forward_cached_prefill_and_decode_match_jax(pair):
    cfg, params, model = pair
    tokens = _tokens((2, 12), seed=4)
    j_cache = jgpt2.init_cache(cfg, 2, 16)
    t_cache = model.init_cache(2, 16)
    j_logits, j_cache = jgpt2.forward_cached(params, jnp.asarray(tokens[:, :8]), cfg,
                                             j_cache, 0)
    with torch.no_grad():
        t_logits, t_cache = model.forward_cached(torch.from_numpy(tokens[:, :8]), t_cache, 0)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    weights = model.prep_decode()
    for pos in range(8, 12):
        j_logits, j_cache = jgpt2.forward_cached(
            params, jnp.asarray(tokens[:, pos:pos + 1]), cfg, j_cache, pos)
        with torch.no_grad():
            t_logits, t_cache = model.forward_cached(
                torch.from_numpy(tokens[:, pos:pos + 1]), t_cache, pos, weights)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(j_cache[key]),
                                   atol=ATOL, rtol=0)


def test_forward_cached_matches_forward(pair):
    _, _, model = pair
    tokens = torch.from_numpy(_tokens((2, 10), seed=5))
    with torch.no_grad():
        full = model(tokens)
        cached, _ = model.forward_cached(tokens, model.init_cache(2, 10), 0)
    torch.testing.assert_close(cached, full, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        model.forward_cached(tokens[:, :1], model.init_cache(2, 200), 128)


def _generate_both(pair, eos_id):
    cfg, params, model = pair
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    want = np.asarray(jax_generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0),
                                   model=jgpt2, cfg=cfg, max_new_tokens=NEW, eos_id=eos_id))
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=NEW, eos_id=eos_id)
    return got.numpy(), want


def test_greedy_generate_token_identical(pair):
    got, want = _generate_both(pair, None)
    assert got.shape == (2, NEW)
    np.testing.assert_array_equal(got, want)
    eos = int(want[0, 3])  # a token that fires in row 0
    got, want = _generate_both(pair, eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == eos).all()


def test_three_adamw_steps_match_jax_make_train_step():
    cfg = jgpt2.gpt2_test()
    mesh = jax_make_mesh(JaxMeshSpec(), devices=jax.devices()[:1])
    j_init, j_step = jts.make_train_step(cfg, mesh, optax.adamw(**ADAMW), model=jgpt2)
    j_state = j_init(jax.random.PRNGKey(0))
    h = ADAMW
    t_init, t_step = make_train_step(
        tgpt2.gpt2_test(),
        lambda ps: torch.optim.AdamW(ps, lr=h["learning_rate"], betas=(h["b1"], h["b2"]),
                                     eps=h["eps"], weight_decay=h["weight_decay"]),
        model=tgpt2, device="cpu")
    t_state = t_init(0)
    assert isinstance(t_state.model, tgpt2.GPT2)
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
    _assert_trees_close(gpt2_to_jax_params(t_state.model), j_state.params)


def test_init_statistics():
    # Moments of the init at a width with enough samples: N(0, 0.02), the
    # residual projections 0.02 / sqrt(2 L), zero biases, unit scales.
    cfg = tgpt2.GPT2Config(vocab_size=2048, dim=256, n_layers=4, n_heads=4, max_seq_len=512,
                           dtype=torch.float32)
    torch.manual_seed(0)
    model = tgpt2.GPT2(cfg, device="cpu")
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert bool((p == 0).all()), name
        elif "ln_" in name:
            assert bool((p == 1).all()), name
        else:
            std = resid if ("attn_proj" in name or "mlp_proj" in name) else 0.02
            assert abs(p.mean().item()) < 0.05 * std, name
            assert abs(p.std().item() / std - 1) < 0.03, name


def test_deferred_init_and_seeded_materialize():
    # Recording allocates nothing (every parameter is fake); a seeded
    # materialize is reproducible, names every parameter once (no head),
    # and loads by assignment into a model that matches JAX on its weights.
    cfg = tgpt2.gpt2_test()
    model = tdi.deferred_init(tgpt2.GPT2, cfg, device_="cuda")
    assert all(tdi.is_deferred(p) for p in model.parameters())
    first = materialize_module_torch(model, seed=1, device="cpu")
    again = materialize_module_torch(tdi.deferred_init(tgpt2.GPT2, cfg, device_="cuda"),
                                     seed=1, device="cpu")
    other = materialize_module_torch(model, seed=2, device="cpu")
    assert list(first) == list(again) and all(torch.equal(first[k], again[k]) for k in first)
    assert not torch.equal(first["wte.weight"], other["wte.weight"])
    assert set(first) == {n for n, _ in model.named_parameters()} == \
        set(tgpt2.param_specs(cfg))
    model.load_state_dict(first, assign=True)
    assert model.head_weight.data_ptr() == first["wte.weight"].data_ptr()
    tokens = _tokens((2, 16), seed=8)
    params = jax.tree.map(jnp.asarray, gpt2_to_jax_params(model))
    want = jgpt2.forward(params, jnp.asarray(tokens), jgpt2.gpt2_test(), attn_impl="jnp")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("how", ["materialize_module", "materialize_module_torch"])
def test_head_and_embedding_are_one_parameter(how):
    # GPT-2 ties its logits to the token embedding: after either
    # materialization the head reads wte's own Parameter, the model owns
    # num_params values, and the head's gradient lands in wte.
    cfg = tgpt2.gpt2_test()
    model = tdi.deferred_init(tgpt2.GPT2, cfg, device_="cuda")
    if how == "materialize_module":
        tdi.materialize_module(model, device="cpu")
    else:
        model.load_state_dict(materialize_module_torch(model, seed=0, device="cpu"),
                              assign=True)
    assert isinstance(model.wte.weight, nn.Parameter)
    assert model.head_weight is model.wte.weight
    assert sum(p.numel() for p in model.parameters()) == tgpt2.num_params(cfg)
    x = torch.randn(2, 3, cfg.dim)
    head = model._head(x)
    torch.testing.assert_close(head, model.ln_f(x) @ model.wte.weight.T, atol=0, rtol=0)
    head.sum().backward()
    assert model.wte.weight.grad is not None and bool(model.wte.weight.grad.any())


@pytest.fixture(scope="module")
def slowmo_runs(tmp_path_factory):
    """The JAX SlowMo step over GPT-2 (2 stacked replicas on a dp=2, tp=4
    mesh) and the port's 2 gloo ranks on the same weights and batch."""
    d = tmp_path_factory.mktemp("slowmo_gpt2")
    cfg = jgpt2.gpt2_test()
    mesh = jax_make_mesh(JaxMeshSpec(dp=2, tp=4))
    opt = JaxSlowMo(optax.sgd(0.1), base_lr=0.1, slowmo_freq=2)
    init_fn, step_fn = jts.make_slowmo_train_step(cfg, mesh, opt, model=jgpt2)
    state = init_fn(jax.random.PRNGKey(0))
    replica0 = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 4, 32)).astype(np.int64)
    targets = np.roll(tokens, -1, axis=-1)
    np.savez(d / "in.npz", tokens=tokens, targets=targets, family="gpt2",
             **{f"param/{k}": v for k, v in _flat(replica0).items()})
    procs = launch("step", 2, d, d / "in.npz")
    try:
        bs = jts.slowmo_batch_sharding(mesh)
        batch = {"tokens": jax.device_put(jnp.asarray(tokens), bs),
                 "targets": jax.device_put(jnp.asarray(targets), bs)}
        want = {}
        for i in range(1, 5):
            state, metrics = step_fn(state, batch)
            want[f"loss/{i}"] = float(metrics["loss"])
            want[f"params/{i}"] = jax.tree.map(np.asarray, state.params)
    finally:
        wait(procs, "the GPT-2 step suite")
    return want, [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("step", range(1, 5))
def test_slowmo_step_over_gpt2_matches_jax(slowmo_runs, step):
    want, ranks = slowmo_runs
    assert ranks[0][f"loss/{step}"] == ranks[1][f"loss/{step}"]
    np.testing.assert_allclose(ranks[0][f"loss/{step}"][0], want[f"loss/{step}"], atol=ATOL,
                               rtol=0)
    for rank, rep in enumerate(ranks):
        for key, value in _flat(want[f"params/{step}"]).items():
            np.testing.assert_allclose(rep[f"params/{step}/{key}"], value[rank], atol=ATOL,
                                       rtol=0, err_msg=f"rank {rank} step {step} {key}")
    keys = [k for k in ranks[0] if k.startswith(f"params/{step}/")]
    assert keys
    equal = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in keys)
    assert equal == (step % 2 == 0)
