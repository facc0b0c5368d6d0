"""``Tensor.data`` under the port's deferred init (the reference's
``tests/test_data_interception.py`` on the port): in-place writes through
``.data`` (the Hugging Face ``_init_weights`` pattern), ``param.data =``
a recorded tensor, an external real tensor, a new shape, and a read
through ``.data`` feeding another parameter.

Each module is materialized three ways, in place (``materialize_module``),
seeded (``materialize_module_torch``) and by the JAX package's
``materialize_module_jax`` on its own recording of the same module, and
every value is held exactly against the eager module's (these tapes draw
from no random stream but the linear layers' initial values, which the
writes replace).  The external tensor's version guard fires in both of
the port's replays when the tensor is mutated after recording.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import torchdistx_tpu.deferred_init as jdi
from torchdistx_tpu.materialize import materialize_module_jax
from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred, materialize_module
from torchdistx_tpu_torch.materialize import materialize_module_torch


class DataMutatingInit(nn.Module):
    """In-place ops through ``.data``."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)
        self.lin.weight.data.fill_(3.0)
        self.lin.bias.data.zero_()


class DataAssignInit(nn.Module):
    """``param.data = <recorded tensor>``."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)
        self.lin.weight.data = torch.full((4, 4), 7.0)
        self.lin.bias.data.fill_(-1.0)


EXT = torch.arange(9.0).reshape(3, 3)


class DataAssignExternal(nn.Module):
    """``param.data = <a real tensor from outside the recording>``."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(3, 3)
        self.lin.weight.data = EXT
        self.lin.bias.data.zero_()


class DataShapeChange(nn.Module):
    """``param.data =`` a tensor of another shape."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(2, 2)
        self.lin.weight.data = torch.zeros(5, 2)
        self.lin.bias.data.fill_(0.5)


class DataReadFeedsCompute(nn.Module):
    """A read through ``.data`` feeding a new parameter."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)
        self.lin.weight.data.fill_(1.0)
        self.lin.bias.data.zero_()
        self.scaled = nn.Parameter(self.lin.weight.data * 2)


MODULES = [DataMutatingInit, DataAssignInit, DataAssignExternal, DataShapeChange,
           DataReadFeedsCompute]


def _eager(cls):
    m = cls()
    return {k: v.detach() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("cls", MODULES, ids=lambda c: c.__name__)
def test_in_place_materialize_equals_eager(cls):
    m = deferred_init(cls)
    assert all(is_deferred(p) for p in m.parameters())
    materialize_module(m, device="cpu")
    want = _eager(cls)
    got = m.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("cls", MODULES, ids=lambda c: c.__name__)
def test_seeded_materialize_equals_eager_and_jax(cls):
    ours = materialize_module_torch(deferred_init(cls), device="cpu", seed=3)
    theirs = materialize_module_jax(jdi.deferred_init(cls))
    want = _eager(cls)
    assert sorted(ours) == sorted(theirs) == sorted(want)
    for k in want:
        assert torch.equal(ours[k], want[k]), k
        np.testing.assert_array_equal(np.asarray(theirs[k]), want[k].numpy(), err_msg=k)


def test_set_data_keeps_the_record():
    m = deferred_init(DataAssignInit)
    assert is_deferred(m.lin.weight)
    assert tuple(deferred_init(DataShapeChange).lin.weight.shape) == (5, 2)


@pytest.mark.parametrize("replay", ["in_place", "seeded"])
def test_external_tensor_guard_fires(replay):
    ext = torch.ones(3, 3)

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(3, 3)
            self.lin.weight.data = ext

    m = deferred_init(M)
    ext.add_(1)  # mutated after recording
    with pytest.raises(RuntimeError, match="mutated after recording"):
        if replay == "in_place":
            materialize_module(m, device="cpu")
        else:
            materialize_module_torch(m, device="cpu")


def test_set_data_outside_context_raises():
    m = deferred_init(nn.Linear, 4, 4)
    with pytest.raises(RuntimeError, match="outside of a deferred-init"):
        m.weight.data = torch.zeros(4, 4)
