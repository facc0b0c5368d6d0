"""What the port's serving engine leaves for ROADMAP A7 (the shadow auditor
and the ops plane) raises, naming it, and ``Engine`` follows the port's
device rule.  No JAX here."""

import pytest
import torch

from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.serving import Engine

KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return tllama.Llama(tllama.llama_test(), device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(audit_sample=0.5),
    dict(ops_port=0),
    dict(ops_config=object()),
], ids=["audit_sample", "ops_port", "ops_config"])
def test_constructor_arguments_raise_naming_a7(model, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Engine(model, **KW, **kwargs)


@pytest.mark.parametrize("var, value", [("TDX_AUDIT_SAMPLE", "0.25"), ("TDX_OPS_PORT", "0")])
def test_environment_switches_raise_naming_a7(model, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Engine(model, **KW)


def test_zero_audit_sample_is_off(model, monkeypatch):
    monkeypatch.setenv("TDX_AUDIT_SAMPLE", "0")
    Engine(model, **KW, audit_sample=0.0).close()
    Engine(model, **KW).close()


def test_engine_without_cuda_raises_unless_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(model)
    Engine(model, device="cpu").close()


def test_engine_refuses_a_model_on_another_device(model):
    with pytest.raises(ValueError, match="parameters are on cpu"):
        Engine(model, device="meta")
