"""Shared checks of the port's deferred-init breadth tests
(``test_torch_resnet.py``, ``test_torch_hf_breadth.py``,
``test_torch_data_interception.py``, ``test_torch_tape_fuzz.py``); imports
torch and the port only.

A recorded tensor is *random* when an op of its call stack draws from a
generator (tagged ``nondeterministic_seeded``): its value depends on the
stream, so it is held to another materialization by statistics; every
other tensor is held exactly."""

import math

import torch

from torchdistx_tpu_torch._tape import build_call_stack
from torchdistx_tpu_torch.deferred_init import _get_record, is_deferred


def is_random(fake) -> bool:
    """Whether ``fake``'s value depends on a random stream."""
    record = _get_record(fake)
    return any(torch.Tag.nondeterministic_seeded in node.op.func.tags
               for node in build_call_stack(record.node))


def recorded(module):
    """``{name: fake}`` of the deferred parameters and buffers of
    ``module``."""
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    return {n: t for n, t in named.items() if is_deferred(t)}


def assert_like(got, want, random: bool, what: str) -> None:
    """``got`` equal to ``want`` (a deterministic tensor), or (random) of
    its shape and dtype with its statistics: for at least 64 elements two
    samples of one distribution, their means and standard deviations within
    5 standard errors of the difference (sigma sqrt(2 / n) for the means,
    sigma / sqrt(n) for the deviations), otherwise the largest magnitude
    within 1.5 times ``want``'s."""
    got, want = got.detach().cpu(), want.detach().cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not random:
        assert torch.equal(got, want), what
        return
    assert torch.isfinite(got).all(), what
    g, w = got.double().flatten(), want.double().flatten()
    if g.numel() >= 64:
        se = w.std().item() / math.sqrt(w.numel())
        assert abs(g.mean().item() - w.mean().item()) <= 5 * math.sqrt(2) * se + 1e-6, (
            what, g.mean(), w.mean())
        assert abs(g.std().item() - w.std().item()) <= 5 * se + 1e-12, (what, g.std(), w.std())
    else:
        assert g.abs().max().item() <= 1.5 * w.abs().max().item() + 1e-12, what
