"""BASELINE config 2 on the port: ``deferred_init`` ResNet-50
(``models/resnet_torch.py``, the port's copy of the JAX package's), then
materialize it.

The reference's ``tests/test_resnet.py`` cases on the port: the fake
construction (every parameter and float buffer fake, the int64
``num_batches_tracked`` real), ``materialize_module`` in place and a
forward.  Then the seeded ``materialize_module_torch``: its bytes those of
the parameters and buffers, the same seed the same values, and each value
against eager torch's and ``materialize_module_jax``'s on the JAX package's
own recording of the same model (a ResNet of one block a stage, whose
tape has every op of ResNet-50's, so that the JAX side compiles little):
the deterministic tensors (batch norms) exactly, the random ones
(kaiming-uniform convolutions, the uniform head) by statistics and by
their bounds.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torchdistx_tpu.deferred_init as jdi
from torchdistx_tpu.materialize import materialize_module_jax
from torchdistx_tpu.models import resnet_torch as jresnet
from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred, materialize_module
from torchdistx_tpu_torch.fake import FakeTensor
from torchdistx_tpu_torch.materialize import materialize_module_torch
from torchdistx_tpu_torch.models.resnet_torch import ResNet, resnet50

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_deferred_helpers import assert_like, is_random, recorded  # noqa: E402

SMALL = ([1, 1, 1, 1], 10)  # layers a stage, classes


@pytest.fixture(scope="module")
def fake_resnet():
    return deferred_init(resnet50)


def test_resnet_constructs_fake(fake_resnet):
    m = fake_resnet
    n_params = sum(p.numel() for p in m.parameters())
    assert 25e6 < n_params < 26e6  # ResNet-50 is ~25.6M params
    assert all(isinstance(p, FakeTensor) for p in m.parameters())
    for name, b in m.named_buffers():
        if "num_batches_tracked" in name:
            assert not isinstance(b, FakeTensor)
        else:
            assert isinstance(b, FakeTensor), name


def test_resnet_materialize_and_forward():
    m = deferred_init(resnet50, num_classes=10)
    materialize_module(m, device="cpu")
    assert not any(is_deferred(t) for t in list(m.parameters()) + list(m.buffers()))
    m.eval()
    with torch.no_grad():
        y = m(torch.randn(2, 3, 64, 64))
    assert y.shape == (2, 10)
    assert torch.isfinite(y).all()


def test_resnet50_seeded_materialize_bytes_and_seed(fake_resnet):
    values = materialize_module_torch(fake_resnet, device="cpu", seed=0)
    fakes = recorded(fake_resnet)
    assert sorted(values) == sorted(fakes)
    nbytes = sum(v.untyped_storage().nbytes() for v in values.values())
    assert nbytes == sum(f.numel() * f.element_size() for f in fakes.values())
    again = materialize_module_torch(fake_resnet, device="cpu", seed=0)
    assert all(torch.equal(values[k], again[k]) for k in values)
    other = materialize_module_torch(fake_resnet, device="cpu", seed=1)
    assert not torch.equal(values["conv1.weight"], other["conv1.weight"])
    assert torch.equal(values["bn1.weight"], other["bn1.weight"])


def test_resnet_values_against_eager_and_jax():
    torch.manual_seed(0)
    eager = ResNet(*SMALL)
    m = deferred_init(ResNet, *SMALL)
    ours = materialize_module_torch(m, device="cpu", seed=0)
    jax_values = materialize_module_jax(jdi.deferred_init(jresnet.ResNet, *SMALL))
    want = dict(eager.named_parameters())
    want.update(eager.named_buffers())
    fakes = recorded(m)
    assert sorted(ours) == sorted(jax_values) == sorted(fakes)
    for name, fake in fakes.items():
        random = is_random(fake)
        assert_like(ours[name], want[name], random, name)
        theirs = torch.from_numpy(np.array(jax_values[name]))
        assert_like(theirs, want[name], random, f"jax {name}")
        if random:  # kaiming_uniform(a=sqrt 5) / the head's uniform: |x| <= 1/sqrt(fan_in)
            fan_in = want[name][0].numel() if want[name].dim() > 1 else eager.fc.in_features
            bound = fan_in ** -0.5
            assert ours[name].abs().max().item() <= bound + 1e-6, name
    assert sum(is_random(f) for f in fakes.values()) == sum(
        1 for n in fakes if n.endswith("conv1.weight") or n.endswith("conv2.weight")
        or n.endswith("conv3.weight") or ".downsample.0." in n or n.startswith("fc."))


def test_resnet_on_a_claimed_card_records_every_buffer():
    """Under ``device_="cuda"`` the BatchNorms' ``num_batches_tracked``
    literals (``torch.tensor(0)``) are recorded like every other tensor, so
    recording allocates nothing on the card (and runs on a host without
    one); materialized on the CPU they are 0, and two such recordings give
    the same values.  (The two recorded ops a literal takes shift the
    random streams of the ops after it, so these values are not those of a
    recording without the claim.)"""
    m = deferred_init(resnet50, device_="cuda")
    tensors = list(m.parameters()) + list(m.buffers())
    assert all(is_deferred(t) and t.device.type == "cuda" for t in tensors)
    counters = {k: v for k, v in m.named_buffers() if k.endswith("num_batches_tracked")}
    assert len(counters) == 53 and all(c.dtype == torch.int64 for c in counters.values())
    values = materialize_module_torch(m, device="cpu", seed=0)
    assert len(values) == len(tensors)
    assert all(torch.equal(values[k], torch.tensor(0)) for k in counters)
    again = materialize_module_torch(deferred_init(resnet50, device_="cuda"), device="cpu",
                                     seed=0)
    assert all(torch.equal(again[k], values[k]) for k in values)
