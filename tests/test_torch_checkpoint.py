"""The port's checkpointing (``torchdistx_tpu_torch.utils.checkpoint``).

Against the JAX package: the same saves under the same ``max_to_keep``
leave the same committed step directories, and ``latest_step`` reads the
same step.  On the port alone: a restore is bit-identical to what was
saved and lands in the target in place; a failed save commits nothing; the
``ckpt.save`` fault site and the ``ckpt.retries`` counter behave as in the
reference; an async save holds the values from before a mutation made
right after it returned.  Exact throughout (bookkeeping and stored bits).
"""

import os

import jax.numpy as jnp
import pytest
import torch

from torchdistx_tpu.resilience import faults as jfaults
from torchdistx_tpu.utils import checkpoint as jckpt
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.models.llama import llama_test
from torchdistx_tpu_torch.parallel.train_step import TrainState, make_train_step
from torchdistx_tpu_torch.resilience import InjectedFault, RetryPolicy, faults
from torchdistx_tpu_torch.utils import checkpoint as ck


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset(None if os.environ.get("TDX_FAULT") else "")
    jfaults.reset(None if os.environ.get("TDX_FAULT") else "")


def _trained_state(steps=2, seed=0):
    init_fn, step_fn = make_train_step(
        llama_test(), lambda ps: torch.optim.AdamW(ps, lr=1e-3), device="cpu")
    state = init_fn(seed)
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        t = torch.randint(0, 256, (2, 16), generator=g)
        state, _ = step_fn(state, {"tokens": t, "targets": t})
    return state, init_fn


def _flat(state):
    """name -> tensor of a TrainState's model and optimizer state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for pid, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"opt.{pid}.{k}"] = torch.as_tensor(v)
    return out


def _assert_equal_states(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step


def _dirs(path):
    return sorted(n for n in os.listdir(path) if not n.startswith("."))


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_committed_steps_match_the_reference(tmp_path, max_to_keep):
    steps = [1, 2, 3, 5, 8]
    jc = jckpt.Checkpointer(tmp_path / "jax", max_to_keep=max_to_keep)
    tc = ck.Checkpointer(tmp_path / "port", max_to_keep=max_to_keep)
    for step in steps:
        jc.save(step, {"w": jnp.full((3,), float(step))})
        tc.save(step, {"w": torch.full((3,), float(step))})
    jc.wait_until_finished()
    assert _dirs(tmp_path / "port") == _dirs(tmp_path / "jax")
    assert _dirs(tmp_path / "port") == [str(s) for s in steps[-max_to_keep:]]
    assert tc.latest_step() == jc.latest_step() == 8
    assert ck.latest_step(tmp_path / "port") == jckpt.latest_step(tmp_path / "jax") == 8
    step, tree = tc.restore_latest()
    assert step == 8 and torch.equal(tree["w"], torch.full((3,), 8.0))


def test_latest_step_is_a_pure_read(tmp_path):
    missing = tmp_path / "never"
    assert ck.latest_step(missing) is None
    assert not missing.exists()
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "7.tmp").mkdir()  # a save that never committed
    assert ck.latest_step(tmp_path / "run") is None


def test_trainstate_round_trip_is_bit_identical_and_in_place(tmp_path):
    state, init_fn = _trained_state()
    c = ck.Checkpointer(tmp_path / "run")
    c.save(2, state)
    target = init_fn(5)  # other weights, empty optimizer state
    params = list(target.model.parameters())
    step, restored = c.restore_latest(target=target)
    assert step == 2 and isinstance(restored, TrainState)
    assert restored.model is target.model and restored.optimizer is target.optimizer
    assert all(p is q for p, q in zip(params, restored.model.parameters()))
    _assert_equal_states(restored, state)
    # Stored as plain state dicts: readable with weights_only=True alone.
    tree = torch.load(tmp_path / "run" / "2" / "state.pt", weights_only=True)
    assert set(tree) == {"model", "optimizer", "step"} and tree["step"] == 2


def test_save_state_and_restore_state(tmp_path):
    state, init_fn = _trained_state(steps=1)
    ck.save_state(tmp_path / "one", state)
    with pytest.raises(FileExistsError):
        ck.save_state(tmp_path / "one", state)
    ck.save_state(tmp_path / "one", state, force=True)
    _assert_equal_states(ck.restore_state(tmp_path / "one", target=init_fn(3)), state)
    assert ck.restore_state(tmp_path / "one")["step"] == 1
    with pytest.raises(TypeError):
        ck.restore_state(tmp_path / "one", target={"w": 1})


def test_saving_a_committed_step_again_does_nothing(tmp_path):
    c = ck.Checkpointer(tmp_path / "run")
    c.save(1, {"w": torch.zeros(2)})
    c.save(1, {"w": torch.ones(2)})
    assert torch.equal(c.restore_latest()[1]["w"], torch.zeros(2))


def test_failed_write_commits_nothing(tmp_path, monkeypatch):
    def torn(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", torn)
    c = ck.Checkpointer(tmp_path / "run")
    with pytest.raises(OSError, match="disk full"):
        c.save(3, {"w": torch.zeros(2)})
    assert c.latest_step() is None and ck.latest_step(tmp_path / "run") is None


def test_async_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(obj, f):
        raise OSError("disk gone")

    monkeypatch.setattr(ck.torch, "save", broken)
    c = ck.Checkpointer(tmp_path / "run")
    c.save(4, {"w": torch.zeros(2)}, wait=False)
    with pytest.raises(OSError, match="disk gone"):
        c.wait_until_finished()
    c.wait_until_finished()  # raised once
    assert c.latest_step() is None


def test_ckpt_save_fault_is_retried_and_counted(tmp_path):
    counter = telemetry.counter("ckpt.retries")
    before = counter.value
    faults.reset("ckpt.save:2:io")
    c = ck.Checkpointer(tmp_path / "run", retry=RetryPolicy(max_attempts=3, base_delay_s=0.001))
    c.save(2, {"w": torch.zeros(2)})
    assert counter.value - before == 1
    assert c.latest_step() == 2


def test_ckpt_save_fault_without_retry_is_fatal(tmp_path):
    faults.reset("ckpt.save:2:io")
    c = ck.Checkpointer(tmp_path / "run")
    with pytest.raises(InjectedFault):
        c.save(2, {"w": torch.zeros(2)})
    assert c.latest_step() is None


def test_async_save_holds_the_values_from_before_a_mutation(tmp_path):
    state, init_fn = _trained_state()
    before = {k: v.clone() for k, v in _flat(state).items()}
    c = ck.Checkpointer(tmp_path / "run")
    c.save(2, state, wait=False)
    with torch.no_grad():  # what the next step_fn does: update in place
        for p in state.model.parameters():
            p.add_(1.0)
        for s in state.optimizer.state.values():
            s["exp_avg"].mul_(-3.0)
    c.wait_until_finished()
    _, restored = c.restore_latest(target=init_fn(0))
    got = _flat(restored)
    for k, v in before.items():
        assert torch.equal(got[k], v), k
