"""The port's resilience package: ``TDX_FAULT`` parsing held against the JAX
package's on one corpus (the same specs, or the same rejection with the
same message: exact), and the reference's retry, fault, preemption,
SkipTracker, pure-read and flag-agreement cases run on the port.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from torchdistx_tpu.resilience import faults as jfaults
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.parallel.distributed import any_flag, any_flags
from torchdistx_tpu_torch.resilience import (
    CRASH_EXIT_CODE,
    InjectedFault,
    NonFiniteError,
    RetriesExhausted,
    RetryPolicy,
    SkipTracker,
    faults,
    parse_faults,
    preemption,
)
from torchdistx_tpu_torch.resilience.faults import FatalInjectedFault
from torchdistx_tpu_torch.resilience.retry import DEFAULT_RETRYABLE_NAMES

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    """Every test starts with an empty fault registry and a clear
    preemption flag, and leaves no handlers behind."""
    faults.reset("")
    preemption.clear()
    yield
    faults.reset(None if os.environ.get("TDX_FAULT") else "")
    preemption.clear()
    preemption.uninstall()


# ---------------------------------------------------------------------------
# TDX_FAULT parsing against the reference

FAULT_CORPUS = [
    # valid (the reference's tests/test_resilience.py cases first)
    "ckpt.save:2:io, step.exec:3:nan",
    "data.next:1:fatal",
    "step.exec:4:sigterm",
    "step.exec:3:crash",
    "serve.step:6:corrupt",
    " ckpt.save : 2 : io ",
    "ckpt.save:2:io,,",
    "",
    ",",
    "journal.fsync:10:io,serve.swap:1:nan",
    "step.exec:007:crash",
    "step.exec:+3:nan",
    "step.exec:1_0:nan",
    "serve.materialize:2:crash,journal.recover:3:io,serve.migrate_in:1:nan",
    "data.next:2:io,data.next:2:io",
    # invalid
    "ckpt.save:2",
    "nowhere:2:io",
    "ckpt.save:2:explode",
    "ckpt.save:x:io",
    "ckpt.save:0:io",
    "ckpt.save:-1:io",
    "ckpt.save:2:io:extra",
    "ckpt.save:2.5:io",
    ":2:io",
    "ckpt.save::io",
    "CKPT.SAVE:2:io",
    "ckpt.save:2:IO",
    "step.exec:1:nan,bad",
    "ckpt.save:1e3:io",
    "ckpt.save 2 io",
]


def _parse(parse, text):
    try:
        return "ok", [(s.site, s.step, s.kind, s.fired) for s in parse(text)]
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("text", FAULT_CORPUS)
def test_parse_faults_matches_the_reference(text):
    assert _parse(parse_faults, text) == _parse(jfaults.parse_faults, text)


def test_fault_vocabulary_matches_the_reference():
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS
    assert faults.ENV_VAR == jfaults.ENV_VAR == "TDX_FAULT"
    assert CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE == 13


def test_parse_corpus_has_both_outcomes():
    outcomes = {_parse(parse_faults, t)[0] for t in FAULT_CORPUS}
    assert outcomes == {"ok", "error"}


# ---------------------------------------------------------------------------
# RetryPolicy (the reference's TestRetryPolicy)


class TestRetryPolicy:
    def test_succeeds_after_transient_failures(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        c = telemetry.counter("test.retries")
        before = c.value
        p = RetryPolicy(max_attempts=5, base_delay_s=0.001)
        assert p.call(flaky, counter=c) == "ok"
        assert len(calls) == 3
        assert c.value - before == 2  # two granted retries

    def test_exhausted_raises_with_cause(self):
        p = RetryPolicy(max_attempts=2, base_delay_s=0.001)

        def always():
            raise OSError("persistent")

        with pytest.raises(RetriesExhausted) as ei:
            p.call(always)
        assert isinstance(ei.value.__cause__, OSError)

    def test_non_retryable_propagates_immediately(self):
        calls = []

        def fatal():
            calls.append(1)
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=5, base_delay_s=0.001).call(fatal)
        assert len(calls) == 1

    def test_retryable_by_name(self):
        class Unavailable(Exception):  # grpc-style transport error
            pass

        p = RetryPolicy(max_attempts=2, base_delay_s=0.001)
        assert p.is_retryable(Unavailable())
        assert not p.is_retryable(KeyError())

    def test_explicit_retryable_attribute_is_authoritative(self):
        p = RetryPolicy(max_attempts=2, base_delay_s=0.001)

        class TransientThing(Exception):  # not an OSError, unknown name
            retryable = True

        class FatalIO(OSError):  # isinstance says retry; raiser says no
            retryable = False

        class WeirdAttr(OSError):  # a non-boolean attribute is ignored
            retryable = "yes"

        assert p.is_retryable(TransientThing())
        assert not p.is_retryable(FatalIO())
        assert p.is_retryable(WeirdAttr())

    def test_retryable_attribute_beats_a_name_collision(self):
        # A serving DeadlineExceeded (retryable=False) is NOT retried although
        # its name is a transient grpc status.
        class DeadlineExceeded(Exception):
            retryable = False

        p = RetryPolicy(max_attempts=2, base_delay_s=0.001)
        assert not p.is_retryable(DeadlineExceeded("too late"))
        assert "DeadlineExceeded" in DEFAULT_RETRYABLE_NAMES  # the trap

    def test_retryable_attribute_drives_call(self):
        p = RetryPolicy(max_attempts=3, base_delay_s=0.001)

        class Transient(Exception):
            retryable = True

        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise Transient("hiccup")
            return "ok"

        assert p.call(flaky) == "ok"
        assert len(calls) == 2

        class Fatal(OSError):
            retryable = False

        fatal_calls = []

        def fatal():
            fatal_calls.append(1)
            raise Fatal("corrupt")

        with pytest.raises(Fatal):
            p.call(fatal)
        assert len(fatal_calls) == 1

    def test_delay_backoff_bounds(self):
        p = RetryPolicy(base_delay_s=0.1, max_delay_s=1.0, jitter=0.5)
        for k, cap in [(0, 0.1), (1, 0.2), (2, 0.4), (10, 1.0)]:
            for _ in range(8):
                d = p.delay(k)
                assert cap * 0.5 <= d <= cap

    def test_deadline_bounds_total_time(self):
        p = RetryPolicy(max_attempts=100, base_delay_s=10.0, deadline_s=0.01)

        def always():
            raise OSError("x")

        # The first retry's sleep would cross the deadline: no 10s nap.
        with pytest.raises(RetriesExhausted):
            p.call(always)

    def test_validation(self):
        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            RetryPolicy(jitter=1.5)


# ---------------------------------------------------------------------------
# Fault injection (the reference's TestFaults)


class TestFaults:
    def test_fire_once_then_clean(self):
        faults.reset("data.next:4:io")
        assert faults.fire("data.next", 3) is None  # wrong step
        assert faults.fire("ckpt.save", 4) is None  # wrong site
        with pytest.raises(InjectedFault):
            faults.fire("data.next", 4)
        # Consumed: the retry's second attempt succeeds.
        assert faults.fire("data.next", 4) is None

    def test_nan_kind_is_returned_not_raised(self):
        faults.reset("step.exec:1:nan")
        assert faults.fire("step.exec", 1) == "nan"

    def test_fatal_kind_is_not_retryable(self):
        faults.reset("ckpt.save:1:fatal")
        with pytest.raises(FatalInjectedFault):
            faults.fire("ckpt.save", 1)
        assert not RetryPolicy().is_retryable(FatalInjectedFault("x"))
        assert RetryPolicy().is_retryable(InjectedFault("x"))

    def test_fired_counter_and_event(self):
        c = telemetry.counter("faults.fired")
        before = c.value
        prev = telemetry.configure(collect=True)
        try:
            faults.reset("data.next:1:nan")
            faults.fire("data.next", 1)
            events = [r for r in telemetry.drain() if r.get("name") == "fault.fired"]
        finally:
            telemetry.configure(**prev)
        assert c.value - before == 1
        assert events[-1]["attrs"] == {"site": "data.next", "step": 1, "kind": "nan"}

    def test_env_seeds_the_registry(self, monkeypatch):
        monkeypatch.setenv("TDX_FAULT", "step.exec:2:nan")
        faults.reset(None)
        assert faults.active()
        assert faults.fire("step.exec", 2) == "nan"

    def test_sigterm_kind_sends_a_real_signal(self):
        assert preemption.install()
        faults.reset("step.exec:2:sigterm")
        assert faults.fire("step.exec", 2) is None
        for _ in range(1000):
            if preemption.requested():
                break
        assert preemption.requested()

    def test_crash_kind_exits_with_the_reserved_code(self):
        code = ("from torchdistx_tpu_torch.resilience import faults\n"
                "faults.reset('step.exec:1:crash')\n"
                "faults.fire('step.exec', 1)\n"
                "print('survived')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                              text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        assert proc.returncode == CRASH_EXIT_CODE == 13
        assert "survived" not in proc.stdout


# ---------------------------------------------------------------------------
# Preemption flag (the reference's TestPreemption)


class TestPreemption:
    def test_request_and_clear(self):
        assert not preemption.requested()
        preemption.request()
        assert preemption.requested()
        preemption.clear()
        assert not preemption.requested()

    def test_real_sigterm_sets_flag(self):
        assert preemption.install()
        assert preemption.installed()
        c = telemetry.counter("preempt.signals")
        before = c.value
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):
            if preemption.requested():
                break
        assert preemption.requested()
        assert c.value - before == 1

    def test_second_signal_escalates_to_previous_handler(self):
        hits = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
        try:
            assert preemption.install()
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):
                if preemption.requested():
                    break
            assert hits == []  # first signal: flag only
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):
                if hits:
                    break
            assert hits == [signal.SIGTERM]  # second: chained
        finally:
            preemption.uninstall()
            signal.signal(signal.SIGTERM, prev)

    def test_uninstall_restores(self):
        prev = signal.getsignal(signal.SIGTERM)
        preemption.install()
        preemption.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev
        assert not preemption.installed()


# ---------------------------------------------------------------------------
# Non-finite guard, host side (the reference's TestSkipTracker)


class TestSkipTracker:
    def test_escalates_after_consecutive(self):
        t = SkipTracker(max_consecutive=3)
        t.observe(True, 1)
        t.observe(True, 2)
        t.observe(False, 3)  # finite step resets the streak
        t.observe(True, 4)
        t.observe(True, 5)
        with pytest.raises(NonFiniteError) as ei:
            t.observe(True, 6)
        assert ei.value.step == 6
        assert ei.value.consecutive == 3
        assert t.total == 5

    def test_disabled_escalation_still_counts(self):
        c = telemetry.counter("train.skipped_steps")
        before = c.value
        t = SkipTracker(max_consecutive=0)
        for s in range(1, 20):
            t.observe(True, s)
        assert c.value - before == 19


# ---------------------------------------------------------------------------
# Pure reads and flag agreement (the reference's TestPureReads, TestAnyFlag)


class TestPureReads:
    def test_latest_step_does_not_create_directory(self, tmp_path):
        from torchdistx_tpu_torch.utils.checkpoint import latest_step

        missing = tmp_path / "never-checkpointed"
        assert latest_step(missing) is None
        assert not missing.exists()


class TestAnyFlag:
    def test_single_process_is_local(self):
        assert any_flag(True) is True
        assert any_flag(False) is False
        assert any_flags([1, 0, True]) == (True, False, True)

    def test_two_processes_agree_over_gloo(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        code = (
            "import sys, torch.distributed as dist\n"
            "from torchdistx_tpu_torch.parallel.distributed import any_flag, any_flags\n"
            "rank = int(sys.argv[1])\n"
            "dist.init_process_group('gloo', init_method='tcp://127.0.0.1:' + sys.argv[2],"
            " world_size=2, rank=rank)\n"
            "print(any_flags((rank == 0, rank == 1, False)), any_flag(rank == 1))\n"
            "dist.destroy_process_group()\n"
        )
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port)], cwd=ROOT,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                assert p.returncode == 0, err
                outs.append(out.strip())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert outs == ["(True, True, False) True"] * 2
