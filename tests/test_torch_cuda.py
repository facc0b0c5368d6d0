"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips with a reason on a host without CUDA.
Imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

# (out, lse) tolerances against the plain version: bf16 rounds out and p
# to bf16 (p against a running max in the kernel, the row max in the plain
# version); float32 differs by summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s, hq, hkv", [(1, 4, 4), (77, 8, 2), (300, 4, 1)])
def test_flash_fwd_matches_plain(cuda, dtype, d, causal, s, hq, hkv):
    g = torch.Generator(device=cuda).manual_seed(s * d)
    q = torch.randn((2, s, hq, d), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, s, hkv, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, s, hkv, d), generator=g, device=cuda, dtype=dtype)
    n0 = fa.launches
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    tol_out, tol_lse = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse


def test_flash_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)


def test_flash_backward_raises(cuda):
    q = torch.randn((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()
