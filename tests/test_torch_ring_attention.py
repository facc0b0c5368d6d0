"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's ``ring_attention``.

The port side is 4 gloo ranks in subprocesses (``_torch_mesh_child.py``,
suite ``ring``) on ``MeshSpec(dp=2, sp=2)`` and ``MeshSpec(sp=4)``; the JAX
side is the same mesh shapes of virtual CPU devices.  Both get the same
numpy q (2, 16, 4, 8) and k, v (2, 16, 2, 8) (GQA) and the same output
cotangent.  Tolerance: atol 1e-5 on the output and on the q, k and v
gradients (float32; the port's backward is its own transposed ring, the
JAX one autodiff through ``scan`` and ``ppermute``).  ``_zigzag_perm`` is
exact, and the validation errors are JAX's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.parallel import ring_attention as jring
from torchdistx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchdistx_tpu_torch.parallel import ring_attention as tring

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_child import launch, wait  # noqa: E402

ATOL = 1e-5
MESHES = {"dp2_sp2": JaxMeshSpec(dp=2, sp=2), "sp4": JaxMeshSpec(sp=4)}
CASES = {"causal": {}, "full": {"causal": False}, "zigzag": {"schedule": "zigzag"},
         "pre_permuted": {"schedule": "zigzag"}}


def _inputs():
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"q": f(2, 16, 4, 8), "k": f(2, 16, 2, 8), "v": f(2, 16, 2, 8),
            "cot": f(2, 16, 4, 8)}


def _jax_attend(fn, inputs):
    """``fn``'s output and its q/k/v gradients of ``sum(out * cot)``, in one
    jitted program."""

    def run(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        dq, dk, dv = vjp(cot)
        return {"out": out, "dq": dq, "dk": dk, "dv": dv}

    return jax.jit(run)(*(jnp.asarray(inputs[n]) for n in ("q", "k", "v", "cot")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port)``: each mesh and case's output and gradients."""
    d = tmp_path_factory.mktemp("ring")
    inputs = _inputs()
    procs = launch("ring", 4, d, inputs)
    try:
        want = {}
        for label, spec in MESHES.items():
            mesh = jax_make_mesh(spec, devices=jax.devices()[:4])
            for case, kw in CASES.items():
                if case == "pre_permuted":  # the port's case; the same function
                    want[f"{label}_{case}"] = want[f"{label}_zigzag"]
                    continue
                got = _jax_attend(lambda q, k, v: jring.ring_attention(q, k, v, mesh=mesh, **kw),
                                  inputs)
                want[f"{label}_{case}"] = jax.tree.map(np.asarray, got)
    finally:
        port = wait(procs, d, "the ring suite")
    return want, port


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_values_and_grads_match_jax(runs, mesh, case):
    want, port = runs
    key = f"{mesh}_{case}"
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(port[key][name], want[key][name], atol=ATOL, rtol=0,
                                   err_msg=f"{key} {name}")


def test_ring_equals_plain_attention(runs):
    # The causal ring is the plain causal attention of the whole sequence.
    from torchdistx_tpu_torch.ops.attention import mha_reference

    _, port = runs
    inputs = _inputs()
    want = mha_reference(*(torch.from_numpy(inputs[n]) for n in ("q", "k", "v")), causal=True)
    np.testing.assert_allclose(port["sp4_causal"]["out"], want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s, n", [(16, 2), (16, 4), (24, 3), (8, 1), (64, 8)])
def test_zigzag_perm_is_exact(s, n):
    j_perm, j_inv = jring._zigzag_perm(s, n)
    t_perm, t_inv = tring._zigzag_perm(s, n)
    assert t_perm.dtype == torch.int64
    np.testing.assert_array_equal(t_perm.numpy(), j_perm)
    np.testing.assert_array_equal(t_inv.numpy(), j_inv)


class _Mesh:
    """What ``ring_attention`` reads of a mesh before any collective."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.ndim = len(axes)


@pytest.mark.parametrize("kwargs, s", [
    ({"axis": "seq"}, 16),
    ({"schedule": "zigzag", "causal": False}, 16),
    ({"schedule": "zigzag"}, 12),
    ({"schedule": "nope"}, 16),
    ({"pre_permuted": True}, 16),
], ids=["no_axis", "zigzag_full", "zigzag_indivisible", "schedule", "pre_permuted"])
def test_validation_errors_match_jax(kwargs, s):
    jmesh = jax_make_mesh(JaxMeshSpec(sp=4), devices=jax.devices()[:4])
    x = np.zeros((1, s, 2, 4), np.float32)
    with pytest.raises(ValueError) as jerr:
        jring.ring_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), mesh=jmesh,
                             **kwargs)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError) as terr:
        tring.ring_attention(t, t, t, mesh=_Mesh(sp=4), **kwargs)
    want = str(jerr.value)
    if kwargs.get("axis") == "seq":  # the mesh's axes print as each package's type
        want = want.split(" (axes")[0]
    assert str(terr.value).startswith(want), (str(terr.value), want)
