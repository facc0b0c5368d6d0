"""The flash kernels' mesh wrapper (``flash_attention_sharded``,
``shardable``) and the attention dispatcher's choice (``_select_impl``)
against the JAX package's.

``shardable`` and ``_select_impl`` are compared exactly on a grid of meshes
and shapes (the JAX ``_on_tpu()`` set to each value, the port's ``cuda``
flag to the same; the port's ``"flash"``/``"plain"`` are JAX's
``"pallas"``/``"jnp"``), but for one designed difference: under a mesh
whose shapes do not divide, JAX takes XLA's attention and the port the
kernel on the block that divides; and ``resolve_stage_attn_impl``
against JAX's, whose pin of ``"auto"`` inside a pipeline stage to XLA's
attention the port does not share on CUDA tensors, nor with a sequence
axis (GPipe's sp x pp), where the port runs the ring on the stage's ``sp``
group.  Values: 4 gloo ranks in subprocesses
(``_torch_mesh_child.py``, suite ``attention``) on ``MeshSpec(fsdp=2,
tp=2)``, where the wrapper runs the kernel's plain version on each rank's
block (this host has no card), against the JAX ``flash_attention_sharded``
(the Pallas kernel in interpret mode) on the same mesh shape of virtual CPU
devices: output and q/k/v gradients at atol 1e-5 (float32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchdistx_tpu.ops import attention as jattn
from torchdistx_tpu.ops.pallas import flash_attention as jfa
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.ops import attention as tattn
from torchdistx_tpu_torch.ops.cuda import flash_attention as tfa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_child import launch, wait  # noqa: E402

ATOL = 1e-5


def _arrays(rng, b, s, hq, hkv, d):
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"q": f(b, s, hq, d), "k": f(b, s, hkv, d), "v": f(b, s, hkv, d),
            "cot": f(b, s, hq, d)}


def _inputs():
    rng = np.random.default_rng(3)
    return {"gqa": _arrays(rng, 4, 16, 4, 2, 8), "odd": _arrays(rng, 2, 12, 3, 3, 8)}


def _jax_attend(fn, inputs):
    def run(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        dq, dk, dv = vjp(cot)
        return {"out": out, "dq": dq, "dk": dk, "dv": dv}

    got = jax.jit(run)(*(jnp.asarray(inputs[n]) for n in ("q", "k", "v", "cot")))
    return jax.tree.map(np.asarray, got)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("attention_sharded")
    inputs = _inputs()
    procs = launch("attention", 4, d, inputs)
    try:
        mesh = jax_make_mesh(JaxMeshSpec(fsdp=2, tp=2), devices=jax.devices()[:4])
        want = {f"sharded_causal{c}": _jax_attend(
            lambda q, k, v, c=c: jfa.flash_attention_sharded(q, k, v, causal=c, mesh=mesh),
            inputs["gqa"]) for c in (True, False)}
        want["auto_indivisible"] = _jax_attend(
            lambda q, k, v: jattn.attention(q, k, v, causal=True, mesh=mesh), inputs["odd"])
        want["flash_indivisible"] = want["auto_indivisible"]
    finally:
        port = wait(procs, d, "the attention suite")
    return want, port


@pytest.mark.parametrize("case", ["sharded_causalTrue", "sharded_causalFalse",
                                  "auto_indivisible", "flash_indivisible"])
def test_values_and_grads_match_jax(runs, case):
    want, port = runs
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(port[case][name], want[case][name], atol=ATOL, rtol=0,
                                   err_msg=f"{case} {name}")


def test_kernel_runs_on_the_local_block(runs):
    # fsdp=2 halves the batch (4 -> 2), tp=2 the heads (4/2 -> 2/1).
    want, port = runs
    assert port["local_block_shapes"] == {"q": (2, 16, 2, 8), "k": (2, 16, 1, 8)}
    np.testing.assert_allclose(port["dtensor_out"], want["sharded_causalTrue"]["out"],
                               atol=ATOL, rtol=0)


def test_kernel_runs_on_the_block_that_divides(runs):
    # 3 heads over tp=2 do not divide: the kernel takes half the batch (2
    # -> 1 over fsdp=2) and every head, on each rank.
    _, port = runs
    assert port["indivisible_block_shapes"] == [((1, 12, 3, 8), (1, 12, 3, 8))]


class _JaxMesh:
    """What the JAX predicates read of a mesh: ``shape`` by name."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


class _TorchMesh:
    """What the port's predicates read of a ``DeviceMesh``."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


MESHES = [
    {"dp": 1}, {"dp": 2}, {"fsdp": 4}, {"tp": 2}, {"dp": 2, "fsdp": 2},
    {"fsdp": 2, "tp": 2}, {"dp": 2, "tp": 4}, {"tp": 8}, {"fsdp": 2, "ep": 2},
    {"pp": 2, "tp": 2}, {"data": 2}, {"data": 1, "tp": 2}, {"dp": 2, "sp": 2},
]
SHAPES = [((4, 16, 8, 64), (4, 16, 8, 64)), ((2, 16, 8, 64), (2, 16, 2, 64)),
          ((3, 16, 4, 64), (3, 16, 4, 64)), ((8, 16, 32, 128), (8, 16, 8, 128)),
          ((4, 16, 6, 64), (4, 16, 3, 64)), ((1, 16, 2, 64), (1, 16, 1, 64))]


@pytest.mark.parametrize("axes", MESHES, ids=lambda m: "_".join(f"{k}{v}" for k, v in m.items()))
def test_shardable_equals_jax(axes):
    for q_shape, kv_shape in SHAPES:
        assert (tfa.shardable(_TorchMesh(axes), q_shape, kv_shape)
                == jfa.shardable(_JaxMesh(axes), q_shape, kv_shape)), (axes, q_shape, kv_shape)


_NAMES = {"jnp": "plain", "pallas": "flash", "ring": "ring", "ring_zigzag": "ring_zigzag"}


@pytest.mark.parametrize("accelerator", [True, False], ids=["cuda", "cpu"])
@pytest.mark.parametrize("impl", ["auto", "jnp", "pallas", "ring"])
def test_select_impl_equals_jax(monkeypatch, accelerator, impl):
    monkeypatch.setattr(jattn, "_on_tpu", lambda: accelerator)
    port_impl = _NAMES.get(impl, impl)
    for axes in [None] + MESHES:
        for seq_axis in (None, "sp"):
            for q_shape, kv_shape in SHAPES:
                want = jattn._select_impl(impl, None if axes is None else _JaxMesh(axes),
                                          seq_axis, q_shape, kv_shape)
                want = _NAMES.get(want, want)
                if impl == "auto" and accelerator and axes is not None and want == "plain":
                    # Where JAX takes XLA's attention under a mesh (shapes
                    # that do not divide, an axis it does not know), the
                    # port runs the kernel on the block that divides: CUDA
                    # tensors never take the plain version.
                    want = "flash"
                got = tattn._select_impl(port_impl, seq_axis, cuda=accelerator)
                assert got == want, (axes, seq_axis, q_shape, kv_shape)


@pytest.mark.parametrize("accelerator", [True, False], ids=["cuda", "cpu"])
@pytest.mark.parametrize("impl", ["auto", "jnp", "pallas"])
def test_resolve_stage_attn_impl_against_jax(accelerator, impl):
    """Inside a pipeline stage JAX pins "auto" to XLA's attention and refuses
    its Pallas kernel (the kernel's shard_map cannot nest in the
    pipeline's); the port's stage is the rank's own computation, so "auto"
    is the kernel on CUDA tensors and an explicit "flash" stands.  Off
    CUDA both take the plain attention.  With a sequence axis (sp x pp
    under GPipe) JAX pins "auto" to XLA's full attention all the same; the
    port's "auto" is the ring over the stage's sequence axis (the same
    values), and an explicit impl stands."""
    port_impl = _NAMES.get(impl, impl)
    if impl == "pallas":
        with pytest.raises(ValueError, match="cannot run inside a pipeline stage"):
            jattn.resolve_stage_attn_impl(impl)
        assert tattn.resolve_stage_attn_impl(port_impl, cuda=accelerator) == "flash"
        assert tattn.resolve_stage_attn_impl(port_impl, cuda=accelerator,
                                             seq_axis="sp") == "flash"
        return
    want = _NAMES.get(jattn.resolve_stage_attn_impl(impl), impl)
    with_sp = want
    if impl == "auto":
        with_sp = "ring"  # the designed difference (ROADMAP "not faults")
        if accelerator:
            want = "flash"  # the designed difference (ROADMAP "not faults")
    assert tattn.resolve_stage_attn_impl(port_impl, cuda=accelerator) == want
    assert tattn.resolve_stage_attn_impl(port_impl, cuda=accelerator,
                                         seq_axis="sp") == with_sp


def test_resolve_stage_attn_impl_refuses_the_ring():
    with pytest.raises(ValueError, match="cannot run inside a pipeline stage"):
        tattn.resolve_stage_attn_impl("ring", cuda=False)
    with pytest.raises(ValueError, match="cannot run inside a pipeline stage"):
        tattn.resolve_stage_attn_impl("ring_zigzag", cuda=False, seq_axis="sp")
    assert tattn.resolve_stage_attn_impl("ring", cuda=True, seq_axis="sp") == "ring"


def test_sharded_rejects_indivisible_shapes():
    mesh = _TorchMesh({"fsdp": 2, "tp": 2})
    import torch

    q = torch.zeros(3, 8, 4, 8)
    with pytest.raises(ValueError, match="not divisible over mesh"):
        tfa.flash_attention_sharded(q, q, q, mesh=mesh)
