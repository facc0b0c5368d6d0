"""Randomized differential test of the port's tape (the reference's
``tests/test_tape_fuzz.py`` on the port, in the fast lane).

Bounded random programs of views (slice, narrow, transpose, reshape),
in-place ops (add_, mul_, fill_, zero_, copy_, tril_, ...) and aliased
writes, from the reference's own generator (``test_tape_fuzz._Gen``), run
on eager torch (the ground truth) and recorded under the port's deferred
init; each target is materialized from a fresh recording by the port's
in-place replay (``materialize_tensor``) and by its seeded functional
replay (``materialize_tensor_torch``), both bit-equal to eager torch, for
50 programs.  The reference holds ``materialize_tensor_jax`` to eager torch
on the same programs (slow lane: an XLA compile a program); here three of
them run through it too, bit-equal to the port's values.  Eager replay
compiles nothing, so the port's half runs in tier-1.

Programs whose bases are random (``randn``, ``uniform_``) are held by
statistics against eager torch, bit-equal to themselves under one seed and
different under another.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torchdistx_tpu.deferred_init import _deferred_init_context as jax_context
from torchdistx_tpu.materialize import materialize_tensor_jax
from torchdistx_tpu_torch.deferred_init import _deferred_init_context, materialize_tensor
from torchdistx_tpu_torch.materialize import materialize_tensor_torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_deferred_helpers import assert_like  # noqa: E402
from test_tape_fuzz import _Gen  # noqa: E402

SEEDS = range(50)
JAX_SEEDS = range(3)


def _recorded(prog):
    with _deferred_init_context():
        return prog.execute()


@pytest.mark.parametrize("seed", SEEDS)
def test_replays_equal_eager(seed):
    prog = _Gen(seed)
    eager = prog.execute()
    for t in prog.targets:
        # A fresh recording a target and a replay: materializing a target
        # replays the writers of its storage up to its own horizon.
        got = materialize_tensor(_recorded(prog)[t])
        assert torch.equal(got, eager[t]), (seed, t, prog.steps)
        got = materialize_tensor_torch(_recorded(prog)[t], device="cpu", seed=seed)
        assert torch.equal(got, eager[t]), (seed, t, prog.steps)


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_seeded_replay_equals_jax(seed):
    prog = _Gen(seed)
    for t in prog.targets:
        ours = materialize_tensor_torch(_recorded(prog)[t], device="cpu", seed=0)
        with jax_context():
            fakes = prog.execute()
        np.testing.assert_array_equal(np.asarray(materialize_tensor_jax(fakes[t])),
                                      ours.numpy(), err_msg=f"seed {seed} target {t}")


def _random_program(env_seed):
    """Two random 48 x 48 bases (a normal draw, a uniform fill), then views
    and in-place writes through them, read through the bases."""
    torch.manual_seed(env_seed)
    a = torch.randn(48, 48)
    b = torch.empty(48, 48).uniform_(-1.0, 1.0)
    a[:24].mul_(2.0)
    a.narrow(1, 8, 16).add_(b.narrow(1, 8, 16))
    b.t()[::2].zero_()
    c = a * 0.5 + b
    return {"a": a, "b": b, "c": c}


@pytest.mark.parametrize("target", ["a", "b", "c"])
def test_random_program_by_statistics_and_seed(target):
    eager = _random_program(0)[target]
    with _deferred_init_context():
        fakes = _random_program(0)
    got = materialize_tensor_torch(fakes[target], device="cpu", seed=5)
    assert_like(got, eager, True, target)
    with _deferred_init_context():
        again = materialize_tensor_torch(_random_program(0)[target], device="cpu", seed=5)
    assert torch.equal(got, again)
    with _deferred_init_context():
        other = materialize_tensor_torch(_random_program(0)[target], device="cpu", seed=6)
    assert not torch.equal(got, other)
