"""``Engine`` follows the port's device rule, and a zero audit sample
leaves the auditor off.  No JAX here.  (The shadow auditor and the ops
plane are tested in ``tests/test_torch_audit.py`` and
``tests/test_torch_ops.py``.)"""

import pytest
import torch

from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.serving import Engine

KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return tllama.Llama(tllama.llama_test(), device="cpu")


def test_zero_audit_sample_is_off(model, monkeypatch):
    monkeypatch.setenv("TDX_AUDIT_SAMPLE", "0")
    for eng in (Engine(model, **KW, audit_sample=0.0), Engine(model, **KW)):
        assert eng._auditor is None
        eng.close()


def test_engine_without_cuda_raises_unless_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(model)
    Engine(model, device="cpu").close()


def test_engine_refuses_a_model_on_another_device(model):
    with pytest.raises(ValueError, match="parameters are on cpu"):
        Engine(model, device="meta")
