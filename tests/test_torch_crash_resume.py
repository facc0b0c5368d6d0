"""The port's crash/preemption -> resume, in real subprocesses
(counterpart of ``tests/test_crash_resume.py``; the child,
``_torch_resilience_child.py``, imports torch and the port only).

A ``fit()`` run killed at step 3 — by a hard crash (``os._exit``, as
SIGKILL or power loss would) or by a real SIGTERM through the installed
handler — resumes from its checkpoint and ends at step 5 with parameters
bit-identical to a straight run (the CPU is deterministic), with no
optimizer step executed twice.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from torchdistx_tpu_torch.resilience import CRASH_EXIT_CODE
from torchdistx_tpu_torch.utils.checkpoint import latest_step

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_resilience_child.py")
N_STEPS = 5


def _run_child(ckpt_dir, steps_log, params_out, *, fault=None, trace=None):
    env = dict(os.environ)
    env.pop("TDX_FAULT", None)
    env.pop("TDX_TELEMETRY", None)
    if fault:
        env["TDX_FAULT"] = fault
    if trace:
        env["TDX_TELEMETRY"] = str(trace)
    return subprocess.run(
        [sys.executable, CHILD, str(ckpt_dir), str(N_STEPS), str(steps_log), str(params_out)],
        env=env, capture_output=True, text=True, timeout=120,
    )


def _executed_steps(steps_log):
    if not os.path.exists(steps_log):
        return []
    with open(steps_log) as f:
        return [int(line) for line in f if line.strip()]


def _result(proc):
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")


def _child_module():
    sys.path.insert(0, os.path.dirname(CHILD))
    try:
        import _torch_resilience_child
    finally:
        sys.path.pop(0)
    return _torch_resilience_child


@pytest.fixture(scope="module")
def straight():
    """An uninterrupted run's final parameters: the same code as the
    children's, run here (imported, not respawned)."""
    state, _ = _child_module().run_training(None, N_STEPS)
    assert state.step == N_STEPS
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _assert_resumed_matches(tmp_path, first_executed, straight, trace=None):
    ckpt, steps_log, params = tmp_path / "ckpt", tmp_path / "steps.log", tmp_path / "params.pt"
    resume_point = latest_step(ckpt)
    proc = _run_child(ckpt, steps_log, params, trace=trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _result(proc)["final_step"] == N_STEPS
    got = torch.load(params, weights_only=True)
    assert got.keys() == straight.keys()
    for name in straight:
        assert torch.equal(got[name], straight[name]), name
    executed = _executed_steps(steps_log)
    # The resumed run continued right after the checkpoint, and the union
    # covers every step exactly once.
    assert executed[len(first_executed)] == resume_point + 1
    assert sorted(executed) == list(range(1, N_STEPS + 1))


def test_crash_resume(tmp_path, straight):
    """Hard kill (os._exit: no finally blocks, no atexit) at step 3."""
    proc = _run_child(tmp_path / "ckpt", tmp_path / "steps.log", tmp_path / "params.pt",
                      fault="step.exec:3:crash")
    assert proc.returncode == CRASH_EXIT_CODE == 13
    # Steps 1 and 2 ran; the synchronous save at step 2 committed.
    assert _executed_steps(tmp_path / "steps.log") == [1, 2]
    assert latest_step(tmp_path / "ckpt") == 2
    assert not os.path.exists(tmp_path / "params.pt")
    _assert_resumed_matches(tmp_path, [1, 2], straight)


def test_sigterm_resume(tmp_path, straight):
    """A real SIGTERM delivered as step 3 is about to run: that step still
    executes, the next boundary checkpoints step 3, and fit returns
    resumably with rc 0."""
    trace = tmp_path / "trace.jsonl"
    proc = _run_child(tmp_path / "ckpt", tmp_path / "steps.log", tmp_path / "params.pt",
                      fault="step.exec:3:sigterm", trace=trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = _result(proc)
    assert result["preempted"] is True and result["final_step"] == 3
    executed = _executed_steps(tmp_path / "steps.log")
    assert executed == [1, 2, 3]
    assert latest_step(tmp_path / "ckpt") == 3
    # The preemption is in the exported telemetry trace.
    counters = {}
    with open(trace) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "counters":
                counters = rec["values"]
    assert counters.get("train.preemptions", 0) == 1
    assert counters.get("preempt.signals", 0) == 1
    _assert_resumed_matches(tmp_path, executed, straight)
