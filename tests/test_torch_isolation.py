"""The port stands alone: importing every module of ``torchdistx_tpu_torch``
and ``chip_smoke`` brings in neither ``jax`` nor ``torchdistx_tpu``; and an
entry point given no device on a host without CUDA raises instead of
running on the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torchdistx_tpu_torch
from torchdistx_tpu_torch import resolve_device
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.materialize import (
    materialize_module_torch,
    materialize_tensor_torch,
)
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models import moe as tmoe
from torchdistx_tpu_torch.models.convert import gpt2_from_jax_params, llama_from_jax_params
from torchdistx_tpu_torch.parallel.distributed import initialize, make_hybrid_mesh
from torchdistx_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import torchdistx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    torchdistx_tpu_torch.__path__, "torchdistx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "torchdistx_tpu" or m.startswith("torchdistx_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30


def test_walk_finds_every_module():
    names = {m.name for m in pkgutil.walk_packages(
        torchdistx_tpu_torch.__path__, "torchdistx_tpu_torch.")}
    for want in ("_device", "_tape", "fake", "deferred_init", "ops.attention",
                 "ops.cuda._build", "ops.cuda.flash_attention", "models.llama",
                 "models.convert", "models.generate", "parallel.train_step",
                 "resilience.guard", "telemetry", "telemetry._core",
                 "resilience.retry", "resilience.faults", "resilience.preemption",
                 "parallel.distributed", "parallel.fit", "utils.checkpoint",
                 "materialize", "parallel.sharding", "parallel.mesh", "parallel.slowmo",
                 "models.gpt2", "models.moe", "parallel.ring_attention", "parallel.spmd",
                 "parallel.pipeline"):
        assert "torchdistx_tpu_torch." + want in names


def _slowmo(params):
    return SlowMomentumOptimizer(torch.optim.SGD(params, lr=0.1), base_lr=0.1)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to it")


@pytest.mark.parametrize(
    "entry",
    [
        lambda: resolve_device(None),
        lambda: tllama.Llama(tllama.llama_test()),
        lambda: llama_from_jax_params({}, tllama.llama_test()),
        lambda: tgpt2.GPT2(tgpt2.gpt2_test()),
        lambda: tmoe.MoE(tmoe.moe_test()),
        lambda: gpt2_from_jax_params({}, tgpt2.gpt2_test()),
        lambda: make_train_step(tllama.llama_test(), torch.optim.SGD),
        lambda: make_train_step(tmoe.moe_test(), torch.optim.SGD, model=tmoe),
        lambda: materialize_module_torch(deferred_init(torch.nn.Linear, 4, 4)),
        lambda: materialize_tensor_torch(deferred_init(torch.nn.Linear, 4, 4).weight),
        lambda: make_mesh(),
        lambda: initialize(),
        lambda: make_hybrid_mesh(MeshSpec(tp=2), MeshSpec(dp=2)),
        lambda: make_slowmo_train_step(tllama.llama_test(), None, _slowmo)[0](0),
    ],
    ids=["resolve_device", "Llama", "llama_from_jax_params", "GPT2", "MoE",
         "gpt2_from_jax_params", "make_train_step", "make_train_step_moe",
         "materialize_module_torch", "materialize_tensor_torch", "make_mesh", "initialize",
         "make_hybrid_mesh", "make_slowmo_train_step_init_fn"],
)
def test_device_none_raises_without_cuda(entry):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_explicit_cpu_is_honoured():
    assert resolve_device("cpu") == torch.device("cpu")
    model = tllama.Llama(tllama.llama_test(), device="cpu")
    assert model.embed.weight.device.type == "cpu"
