"""The port's pipeline parallelism (``parallel/pipeline.py``, the families'
``pp_axis`` / ``pp_value_and_grad``, ``make_train_step(pp_axis=)``) against
the JAX package's on the same numpy weights and batch.

The port side is 4 gloo ranks in subprocesses (``_torch_pipeline_child.py``,
suite ``pipeline``) on ``MeshSpec(pp=4)``, ``pp=2 x tp=2`` and ``pp=2 x
fsdp=2``, each family at 4 layers from the JAX ``init_params``; the JAX
side runs on virtual CPU devices, pipelined on ``pp=4`` (the values do not
depend on the mesh) and unpipelined.  Tolerance: atol 1e-5 on losses,
logits and gradients (float32; the same arithmetic in other orders).  MoE
routes per microbatch under a pipeline, in JAX and here, so it is held
against JAX's pipelined values only.

- the GPipe forward against the unpipelined forward and JAX's pipelined
  one; GPipe and 1F1B losses and gradients against JAX's pipelined
  (``loss_fn`` under ``jax.grad``; ``pp_value_and_grad``) and, for Llama
  and GPT-2, unpipelined ones, on every mesh;
- ``make_train_step``'s 1F1B step against its GPipe step and against the
  JAX 1F1B step (three SGD steps on ``tp=2 x pp=2``);
- sequence parallelism inside a GPipe stage (``pp=2 x sp=2``, the ring on
  each stage's ``sp`` group where JAX pins XLA's full attention): each
  family's forward, loss and gradients against JAX's pipelined ones (and,
  for Llama and GPT-2, unpipelined ones), and three SGD steps of
  ``make_train_step(seq_axis="sp", pp_axis="pp")`` against JAX's;
- a custom ``loss_fn`` under GPipe (cross-entropy plus a z-loss on the
  model's pipelined logits) against JAX's step, which calls its loss
  unpipelined (three SGD steps on ``tp=2 x pp=2``);
- GPT-2's tied ``wte``: one vocab-sized f32 accumulator, as in JAX;
- the stash depth and tick count against JAX's, the tick tables against
  the JAX schedule's counters for P in 1..8 and M in 1..16 (no ranks);
- invalid ticks do no stage compute, and 1F1B's stage computations are
  GPipe's forwards (but the last stage's) plus its transposes;
- stage-only materialize equal to a full materialize's values, each rank
  holding only its stage's layers; a NaN on one rank skips every rank;
- the rejections (JAX's messages where JAX has them).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.models import moe as jmoe
from torchdistx_tpu.parallel import pipeline as jpipeline
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models import moe as tmoe
from torchdistx_tpu_torch.models.convert import (
    gpt2_from_jax_params,
    llama_from_jax_params,
    moe_from_jax_params,
    to_jax_params,
)
from torchdistx_tpu_torch.parallel import pipeline as tpipeline
from torchdistx_tpu_torch.parallel import train_step as tts
from torchdistx_tpu_torch.parallel.sharding import StageSpec, stage_of

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from _torch_mesh_child import launch, wait  # noqa: E402
from _torch_pipeline_child import FAMILY_MESHES, SP_MESH  # noqa: E402

ATOL = 1e-5
M = 4
B, S = 8, 16
N_LAYERS = 4
FAMILIES = {  # family -> (JAX module, JAX config, port from JAX params, port config)
    "llama": (jllama, jllama.llama_test, llama_from_jax_params, tllama.llama_test),
    "gpt2": (jgpt2, jgpt2.gpt2_test, gpt2_from_jax_params, tgpt2.gpt2_test),
    "moe": (jmoe, jmoe.moe_test, moe_from_jax_params, tmoe.moe_test),
}
CASES = [(f, m) for f, meshes in FAMILY_MESHES.items() for m in meshes]


def _jcfg(family):
    return dataclasses.replace(FAMILIES[family][1](), n_layers=N_LAYERS)


def _tcfg(family):
    return dataclasses.replace(FAMILIES[family][3](), n_layers=N_LAYERS)


def _jax_refs(family, params, tokens, targets):
    jmod = FAMILIES[family][0]
    cfg = _jcfg(family)
    mesh = jax_make_mesh(axis_names=("pp",), shape=(4,), devices=jax.devices()[:4])
    pp = dict(mesh=mesh, pp_axis="pp", n_microbatches=M, attn_impl="jnp")
    t, g = jnp.asarray(tokens), jnp.asarray(targets)
    out = {}
    out["logits"] = np.asarray(jmod.forward(params, t, cfg))
    out["loss"], grads = jax.value_and_grad(jmod.loss_fn)(params, t, g, cfg)
    out["grads"] = jax.tree.map(np.asarray, grads)
    out["pp_logits"] = np.asarray(jax.jit(lambda p: jmod.forward(p, t, cfg, **pp))(params))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(p, t, g, cfg, **pp)))(params)
    out["gpipe_loss"], out["gpipe_grads"] = float(loss), jax.tree.map(np.asarray, grads)
    loss, grads = jax.jit(lambda p: jmod.pp_value_and_grad(p, t, g, cfg, **pp))(params)
    out["1f1b_loss"], out["1f1b_grads"] = float(loss), jax.tree.map(np.asarray, grads)
    out["acc_shapes"] = jpipeline.last_grad_acc_shapes
    out["stash_slots"], out["n_ticks"] = jpipeline.last_stash_slots, jpipeline.last_n_ticks
    return out


Z_LOSS = 1e-3


def _jax_ce_z_loss(params, tokens, targets):
    """The port child's ``ce_z_loss`` in ``jnp`` on the unpipelined logits
    (JAX calls a custom loss outside the pipeline)."""
    logits = jllama.forward(params, tokens, _jcfg("llama"), attn_impl="jnp")
    lse = jax.nn.logsumexp(logits, axis=-1)
    nll = lse - jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return nll.mean() + Z_LOSS * (lse * lse).mean()


def _jax_train(params, tokens, targets, schedule, axes=("tp", "pp"), **kw):
    cfg = _jcfg("llama")
    mesh = jax_make_mesh(axis_names=axes, shape=(2, 2), devices=jax.devices()[:4])
    init_fn, step_fn = jts.make_train_step(
        cfg, mesh, optax.sgd(0.1), pp_axis="pp", n_microbatches=M, pp_schedule=schedule,
        attn_impl="jnp", nonfinite_guard=False, **kw)
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(
        lambda x, a: jax.device_put(a, x.sharding), state.params, params))
    bs = jts.batch_sharding(mesh)
    batch = {"tokens": jax.device_put(jnp.asarray(tokens), bs),
             "targets": jax.device_put(jnp.asarray(targets), bs)}
    losses = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port, params)``: the JAX references and rank 0's report."""
    d = tmp_path_factory.mktemp("pipeline")
    params = {f: jax.tree.map(np.asarray, FAMILIES[f][0].init_params(
        jax.random.PRNGKey(0), _jcfg(f))) for f in FAMILIES}
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (B, S))
    targets = rng.integers(0, 256, (B, S))
    inputs = {"n_microbatches": M, "tokens": tokens, "targets": targets,
              **{f"{f}_params": p for f, p in params.items()}}
    procs = launch("pipeline", 4, d, inputs, script=os.path.join(HERE, "_torch_pipeline_child.py"))
    try:
        want = {f: _jax_refs(f, params[f], tokens, targets) for f in FAMILIES}
        want["train"] = _jax_train(params["llama"], tokens, targets, "1f1b")
        want["train_custom_loss"] = _jax_train(params["llama"], tokens, targets, "gpipe",
                                               loss_fn=_jax_ce_z_loss)
        want["train_sp"] = _jax_train(params["llama"], tokens, targets, "gpipe",
                                      axes=("pp", "sp"), seq_axis="sp")
    finally:
        port = wait(procs, d, "the pipeline suite")
    return want, port, params


def _tree(family, values, params_np):
    """The port's ``{name: array}`` in the JAX layout (through a CPU model
    built from the JAX weights, so every leaf exists)."""
    model = FAMILIES[family][2](params_np, _tcfg(family), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in values.items()},
                          strict=True)
    return to_jax_params(model)


def _assert_trees(got, want, atol, what):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("family,mesh", CASES)
def test_gpipe_forward_matches(runs, family, mesh):
    want, port, _ = runs
    got = port[f"{family}_{mesh}"]["logits"]
    np.testing.assert_allclose(got, want[family]["pp_logits"], atol=ATOL, rtol=0)
    if family != "moe":  # MoE routes per microbatch under a pipeline
        np.testing.assert_allclose(got, want[family]["logits"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("family,mesh", CASES)
def test_gradients_match_jax(runs, family, mesh, schedule):
    want, port, params = runs
    got = port[f"{family}_{mesh}"]
    assert abs(got[f"{schedule}_loss"] - want[family][f"{schedule}_loss"]) <= ATOL
    tree = _tree(family, got[f"{schedule}_grads"], params[family])
    _assert_trees(tree, want[family][f"{schedule}_grads"], ATOL, f"{family} {mesh} {schedule}")
    if family != "moe":
        assert abs(got[f"{schedule}_loss"] - float(want[family]["loss"])) <= ATOL
        _assert_trees(tree, want[family]["grads"], ATOL, f"{family} {mesh} unpipelined")
    assert got["placed"] is True


def test_1f1b_train_step_matches_gpipe_and_jax(runs):
    want, port, params = runs
    gpipe, onefb = port["train_gpipe"], port["train_1f1b"]
    np.testing.assert_allclose(onefb["losses"], gpipe["losses"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(onefb["losses"], want["train"]["losses"], atol=ATOL, rtol=0)
    assert onefb["losses"][-1] < onefb["losses"][0]
    for key, value in gpipe["params"].items():
        np.testing.assert_allclose(onefb["params"][key], value, atol=ATOL, rtol=0, err_msg=key)
    _assert_trees(_tree("llama", onefb["params"], params["llama"]), want["train"]["params"],
                  ATOL, "1f1b train")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sp_inside_gpipe_stages_matches_jax(runs, family):
    """``pp=2 x sp=2``: the ring inside each stage gives JAX's full-attention
    values (pipelined; and unpipelined for Llama and GPT-2)."""
    want, port, params = runs
    got = port[f"{family}_pp2_sp2"]
    np.testing.assert_allclose(got["logits"], want[family]["pp_logits"], atol=ATOL, rtol=0)
    assert abs(got["loss"] - want[family]["gpipe_loss"]) <= ATOL
    tree = _tree(family, got["grads"], params[family])
    _assert_trees(tree, want[family]["gpipe_grads"], ATOL, f"{family} pp2_sp2")
    if family != "moe":
        np.testing.assert_allclose(got["logits"], want[family]["logits"], atol=ATOL, rtol=0)
        _assert_trees(tree, want[family]["grads"], ATOL, f"{family} pp2_sp2 unpipelined")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sp_inside_gpipe_stages_runs_the_ring(runs, family):
    """Each rank's stage runs its layers' attention as the ring: once a
    layer a microbatch in the forward, and again in the backward's
    recompute."""
    _, port, _ = runs
    per_stage = N_LAYERS // SP_MESH["pp"]
    for rank, (forward, total) in port[f"{family}_pp2_sp2"]["ring_calls"].items():
        assert forward == M * per_stage, rank
        assert total == 3 * M * per_stage, rank


@pytest.mark.parametrize("name", ["train_custom_loss", "train_sp"])
def test_gpipe_train_step_matches_jax(runs, name):
    """Three SGD steps of ``make_train_step(pp_axis=)`` with a custom
    ``loss_fn`` (``tp=2 x pp=2``) and with ``seq_axis`` (``pp=2 x sp=2``)
    against JAX's step with the same arguments."""
    want, port, params = runs
    got = port[{"train_custom_loss": "train_gpipe_custom_loss",
                "train_sp": "train_gpipe_sp"}[name]]
    np.testing.assert_allclose(got["losses"], want[name]["losses"], atol=ATOL, rtol=0)
    assert got["losses"][-1] < got["losses"][0]
    _assert_trees(_tree("llama", got["params"], params["llama"]), want[name]["params"],
                  ATOL, name)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_nan_on_one_rank_skips_every_rank(runs, schedule):
    _, port, _ = runs
    assert port[f"train_{schedule}"]["nan_skips_everywhere"] is True


def _vocab_f32(shapes, vocab):
    """The vocab-sized f32 accumulators outside the layers (a layer's
    ``(out, in)`` weight can have the vocabulary's rows at test widths)."""
    return [(name, shape) for name, shape, dtype in shapes
            if name != "g_lp" and shape[:1] == (vocab,) and dtype == "float32"]


def test_gpt2_tied_embedding_has_one_accumulator(runs):
    """The tied (V, D) ``wte`` is carried once (``g_sp``) on every stage, as
    in JAX, and each accumulator group holds as many f32 elements as
    JAX's (JAX's layer leaves are one stage's stacked layers)."""
    want, port, _ = runs
    vocab = _tcfg("gpt2").vocab_size
    jax_vocab = _vocab_f32(want["gpt2"]["acc_shapes"], vocab)
    assert jax_vocab == [("g_sp", (vocab, _tcfg("gpt2").dim))]
    for rank, shapes in port["gpt2_pp4"]["acc_shapes"].items():
        assert _vocab_f32(shapes, vocab) == jax_vocab, rank
        for group in ("g_ep", "g_lp", "g_hp", "g_sp"):
            count = sum(int(np.prod(s)) for n, s, _ in shapes if n == group)
            jax_count = sum(int(np.prod(s)) for n, s, _ in want["gpt2"]["acc_shapes"]
                            if n == group)
            assert count == jax_count, (rank, group)


def test_moe_pytree_activations_match_gpipe(runs):
    _, port, _ = runs
    for mesh in FAMILY_MESHES["moe"]:
        got = port[f"moe_{mesh}"]
        assert abs(got["1f1b_loss"] - got["gpipe_loss"]) <= ATOL
        for key, value in got["gpipe_grads"].items():
            np.testing.assert_allclose(got["1f1b_grads"][key], value, atol=ATOL, rtol=0,
                                       err_msg=f"{mesh} {key}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stash_and_ticks_equal_jax(runs, family):
    want, port, _ = runs
    got = port[f"{family}_pp4"]
    p = 4
    assert got["stash_slots"] == want[family]["stash_slots"] == 3 * p // 2 + 1
    assert got["n_ticks"] == want[family]["n_ticks"] == 2 * M + 2 * p - 3


@pytest.mark.parametrize("family,mesh", CASES)
def test_invalid_ticks_do_no_stage_compute(runs, family, mesh):
    """Each rank runs its stage once per microbatch in the forward and once
    per microbatch in the backward (a recompute and its transpose), not on
    the M + P - 1 ticks; each stage computation runs its L / P blocks."""
    _, port, _ = runs
    n_stages = {"pp4": 4}.get(mesh, 2)
    per_stage = N_LAYERS // n_stages
    for rank, calls in port[f"{family}_{mesh}"]["calls"].items():
        assert calls["forward_only"] == {"forward": M, "backward": 0}, rank
        assert calls["gpipe"] == {"forward": M, "backward": M}, rank
        assert calls["gpipe_block_calls"] == 2 * M * per_stage, rank


@pytest.mark.parametrize("family,mesh", CASES)
def test_1f1b_computations_are_gpipes_forwards_and_transposes(runs, family, mesh):
    """1F1B's backward slots are GPipe's transposes (M a stage); its
    forward slots are GPipe's forwards on every stage but the last, whose
    backward slot runs the stage (so 1F1B never does more than GPipe)."""
    _, port, _ = runs
    n_stages = {"pp4": 4}.get(mesh, 2)
    per_stage = N_LAYERS // n_stages
    ranks_per_stage = 4 // n_stages
    for rank, calls in port[f"{family}_{mesh}"]["calls"].items():
        last = rank // ranks_per_stage == n_stages - 1  # pp is the mesh's outer dim
        gpipe, onefb = calls["gpipe"], calls["1f1b"]
        assert onefb["backward"] == gpipe["backward"] == M, rank
        assert onefb["forward"] == (0 if last else gpipe["forward"]), rank
        assert calls["1f1b_block_calls"] == (onefb["forward"] + onefb["backward"]) * per_stage


def test_each_rank_holds_only_its_stage(runs):
    _, port, _ = runs
    held = port["llama_pp4"]["held"]
    for rank, names in held.items():
        layers = {int(n.split(".")[1]) for n in names if n.startswith("layers.")}
        assert layers == {rank}, (rank, layers)
        assert {"embed.weight", "norm.weight", "lm_head.weight"} <= set(names)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stage_only_materialize_equals_full(runs, family):
    _, port, _ = runs
    got = port[f"materialize_{family}"]
    union = set()
    for rank, r in got.items():
        assert r["equal"] is True, rank
        stage = rank // 2  # pp=2 x fsdp=2: pp is the outer dim
        for name in r["keys"]:
            if name.startswith("layers."):
                assert stage_of(int(name.split(".")[1]), N_LAYERS, 2) == stage, (rank, name)
        union |= set(r["keys"])
    assert len(union) == got[0]["n_full"]


# ---------------------------------------------------------------------------
# No ranks


def _jax_tick_table(n_stages, m_count, p):
    """The JAX 1F1B scan's counters, tick by tick (``pipeline.py`` tick())."""
    fc = bc = 0
    rows = []
    for t in range(2 * m_count + 2 * n_stages - 3):
        do_fwd = (t == max(fc + p, 2 * fc + 2 * p - n_stages + 1)) and fc < m_count
        do_bwd = (t == 2 * n_stages - 2 - p + 2 * bc) and bc < m_count
        rows.append((t, fc if do_fwd else None, bc if do_bwd else None))
        fc += int(do_fwd)
        bc += int(do_bwd)
    return rows


@pytest.mark.parametrize("n_stages", range(1, 9))
def test_tick_tables_equal_jax_schedule(n_stages):
    """The port's tick tables are the JAX counters' exactly; every
    microbatch's forward and backward happen once a stage, a stage's
    forward after the stage below's (it hops up), its backward after the
    stage above's, and the ring buffer of 3P//2 + 1 slots never overwrites
    a live activation."""
    n_slots = (3 * n_stages) // 2 + 1
    for m_count in range(1, 17):
        tables = [tpipeline.schedule_1f1b(n_stages, m_count, p) for p in range(n_stages)]
        for p, table in enumerate(tables):
            assert table == _jax_tick_table(n_stages, m_count, p), (n_stages, m_count, p)
            assert len(table) == 2 * m_count + 2 * n_stages - 3
        fwd = [{m: t for t, m, _ in table if m is not None} for table in tables]
        bwd = [{m: t for t, _, m in table if m is not None} for table in tables]
        for p in range(n_stages):
            assert sorted(fwd[p]) == sorted(bwd[p]) == list(range(m_count))
            for m in range(m_count):
                assert fwd[p][m] <= bwd[p][m]
                if p > 0:
                    assert fwd[p][m] > fwd[p - 1][m]
                if p < n_stages - 1:
                    assert bwd[p][m] > bwd[p + 1][m]
                    # live from its arrival (or embedding) to its backward
                    write = fwd[p - 1][m] + 1 if p > 0 else fwd[p][m]
                    later = m + n_slots
                    if later < m_count:
                        later_write = fwd[p - 1][later] + 1 if p > 0 else fwd[p][later]
                        assert later_write > bwd[p][m], (n_stages, m_count, p, m)
                    assert write <= fwd[p][m]


class _Mesh:
    """What the pipeline and ``make_train_step`` read of a mesh before any
    collective."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.device_type = "cpu"

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def _tx(ps):
    return torch.optim.SGD(ps, lr=0.1)


class _NoPP:
    """A family module with no ``pp_value_and_grad``."""

    __name__ = "nopp"
    param_specs = staticmethod(tllama.param_specs)


@pytest.mark.parametrize("kwargs,match", [
    ({"pp_schedule": "1f1b", "mesh": _Mesh(fsdp=2, tp=2)}, "requires pp_axis="),
    ({"pp_schedule": "1f1b", "pp_axis": "pp", "loss_fn": lambda *a: 0.0}, "custom loss_fn"),
    ({"pp_schedule": "1f1b", "pp_axis": "pp", "seq_axis": "sp"}, "does not compose"),
    ({"pp_axis": "pp", "mesh": _Mesh(fsdp=2, tp=2)}, "mesh has no axis 'pp'"),
    ({"pp_axis": "pp", "mesh": None}, "pass mesh="),
], ids=["1f1b_without_pp_axis", "1f1b_custom_loss", "1f1b_seq_axis", "missing_pp_axis",
        "pp_axis_without_mesh"])
def test_make_train_step_rejections(kwargs, match):
    kw = {"mesh": _Mesh(pp=2, tp=2), **kwargs}
    with pytest.raises(ValueError, match=match):
        tts.make_train_step(tllama.llama_test(), _tx, device="cpu", **kw)


def test_1f1b_requires_pp_value_and_grad(monkeypatch):
    nopp = _NoPP()
    monkeypatch.setitem(tts._FAMILIES, nopp, tllama.Llama)
    with pytest.raises(ValueError, match="pp_value_and_grad"):
        tts.make_train_step(tllama.llama_test(), _tx, model=nopp, mesh=_Mesh(pp=2),
                            pp_axis="pp", pp_schedule="1f1b", device="cpu")


def test_pipeline_shape_rejections():
    mesh = _Mesh(pp=4)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        tpipeline.pipeline_forward(torch.zeros(8, 2), [], lambda h, l: h, mesh=mesh,
                                   n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        tpipeline.microbatch_rows(torch.zeros(8, 2), 3, None)
    with pytest.raises(ValueError, match="do not split into 4 pipeline stages"):
        tpipeline.stage_blocks([0] * 6, mesh)
    with pytest.raises(ValueError, match="mesh has no axis 'pp'"):
        tpipeline.stage_blocks([0] * 4, _Mesh(tp=4))
    with pytest.raises(ValueError, match="do not split into 3 pipeline stages"):
        stage_of(0, 4, 3)


def test_forward_rejections():
    model = tllama.Llama(tllama.llama_test(), device="cpu")
    tok = torch.zeros(4, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="does not compose with pp"):
        model(tok, mesh=_Mesh(pp=1), pp_axis="pp", seq_layout="zigzag")
    with pytest.raises(ValueError, match="mesh has no axis 'sp'"):
        model.loss(tok, tok, mesh=_Mesh(pp=1), seq_axis="sp", pp_axis="pp")


def test_stage_specs_carry_ownership():
    specs = tllama.param_specs(_tcfg("llama"), pp="pp")
    plain = tllama.param_specs(_tcfg("llama"))
    for name, spec in specs.items():
        assert tuple(spec) == tuple(plain[name])
        if name.startswith("layers."):
            assert isinstance(spec, StageSpec) and spec.pp == "pp"
            assert (spec.layer, spec.n_layers) == (int(name.split(".")[1]), N_LAYERS)
        else:
            assert not isinstance(spec, StageSpec)
    assert [stage_of(i, 4, 2) for i in range(4)] == [0, 0, 1, 1]
