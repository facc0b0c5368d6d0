"""``scripts/torch_f32_ab.py`` lines up the f32 instances of two checkouts."""

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_f32_ab", Path(__file__).resolve().parents[1] / "scripts" / "torch_f32_ab.py")
ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab)


@pytest.mark.parametrize("before, after, name", [
    ("void (anonymous namespace)::flash_fwd_f32<64>(float const*, float const*, float const*, "
     "float*, float*, int, int, int, float, int)",
     "void (anonymous namespace)::flash_fwd_f32<float, 64>(float const*, float const*, "
     "float const*, float*, float*, int, int, int, float, int)", "flash_fwd_f32<64>"),
    ("void tdx_bwd::(anonymous namespace)::bwd_kv_f32<128, true>(tdx_bwd::BwdArgs)",
     "void tdx_bwd::(anonymous namespace)::bwd_kv_f32<float, 128, true>(tdx_bwd::BwdArgs)",
     "bwd_kv_f32<128, true>"),
    ("void tdx_bwd::(anonymous namespace)::bwd_dq_f32<64>(tdx_bwd::BwdArgs)",
     "void tdx_bwd::(anonymous namespace)::bwd_dq_f32<float, 64>(tdx_bwd::BwdArgs)",
     "bwd_dq_f32<64>"),
], ids=["fwd", "kv", "dq"])
def test_instance_names_match_with_and_without_storage_type(before, after, name):
    assert ab._instance(before) == ab._instance(after) == name


@pytest.mark.parametrize("demangled", [
    "void (anonymous namespace)::flash_fwd_f32<__nv_bfloat16, 256>(__nv_bfloat16 const*)",
    "void (anonymous namespace)::flash_fwd_bf16_wgmma<128>(CUtensorMap_st)",
], ids=["bf16-instance", "wgmma"])
def test_bf16_and_wgmma_kernels_are_not_f32_instances(demangled):
    assert ab._instance(demangled) is None
