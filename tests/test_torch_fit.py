"""The port's ``fit`` against the JAX package's ``fit`` on ``llama_test``
(float32), and the reference's ``TestFitResilience`` cases on the port.

Both sides train with SGD(0.1) on the same numpy batches; the port's
``init_fn`` loads the JAX init through ``models/convert.py``.  Tolerances:
losses at each step within 1e-5 (float32, the same arithmetic summed in
different orders); committed steps and the resume step exact; a run
interrupted by a real SIGTERM and resumed matches a straight run within
rtol 2e-5 and atol 2e-6 (the reference's own tolerance,
``tests/test_checkpoint.py``).
"""

import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.parallel import train_step as jts
from torchdistx_tpu.parallel.fit import fit as jfit
from torchdistx_tpu.parallel.mesh import MeshSpec, make_mesh
from torchdistx_tpu.resilience import faults as jfaults
from torchdistx_tpu.resilience import preemption as jpreemption
from torchdistx_tpu.utils.checkpoint import latest_step as jlatest_step
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import copy_jax_params_, llama_to_jax_params
from torchdistx_tpu_torch.parallel.fit import fit
from torchdistx_tpu_torch.parallel.train_step import make_train_step
from torchdistx_tpu_torch.resilience import (
    InjectedFault,
    NonFiniteError,
    RetriesExhausted,
    RetryPolicy,
    faults,
    preemption,
)
from torchdistx_tpu_torch.utils.checkpoint import latest_step

ATOL = 1e-5
N_STEPS = 5
BATCH = (2, 16)


@pytest.fixture(autouse=True)
def _clean_state():
    for f, p in ((faults, preemption), (jfaults, jpreemption)):
        f.reset("")
        p.clear()
    yield
    for f, p in ((faults, preemption), (jfaults, jpreemption)):
        f.reset(None if os.environ.get("TDX_FAULT") else "")
        p.clear()
        p.uninstall()


@pytest.fixture(scope="module")
def rig():
    """(JAX init/step/batches, port init/step/batches) on the same start."""
    cfg = jllama.llama_test()
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    j_init, j_step = jts.make_train_step(cfg, mesh, optax.sgd(0.1))
    sharding = jts.batch_sharding(mesh)
    j_params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)).params)
    t_init0, t_step = make_train_step(
        tllama.llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu")

    def t_init(seed):
        state = t_init0(seed)
        copy_jax_params_(state.model, j_params)
        return state

    def numpy_batches(n=None):
        rng = np.random.default_rng(42)
        i = 0
        while n is None or i < n:
            t = rng.integers(0, 256, BATCH)
            yield t
            i += 1

    def j_batches(n=None):
        for t in numpy_batches(n):
            t = jax.device_put(t, sharding)
            yield {"tokens": t, "targets": t}

    def t_batches(n=None):
        for t in numpy_batches(n):
            t = torch.from_numpy(t)
            yield {"tokens": t, "targets": t}

    return (j_init, j_step, j_batches), (t_init, t_step, t_batches)


def _run_jax(rig, n_steps, **kw):
    j_init, j_step, j_batches = rig[0]
    losses = {}
    state, _ = jfit(j_init, j_step, j_batches(), key=jax.random.PRNGKey(0), n_steps=n_steps,
                    on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])), **kw)
    return state, losses


def _run_port(rig, n_steps, batches=None, **kw):
    t_init, t_step, t_batches = rig[1]
    losses = {}
    state, metrics = fit(t_init, t_step, t_batches() if batches is None else batches,
                         seed=0, n_steps=n_steps,
                         on_metrics=lambda s, m: losses.__setitem__(s, m["loss"].item()), **kw)
    return state, losses, metrics


def _step_dirs(path):
    return sorted(int(n) for n in os.listdir(path) if n.isdigit())


def test_losses_match_jax_fit(rig):
    j_state, j_losses = _run_jax(rig, N_STEPS)
    t_state, t_losses, metrics = _run_port(rig, N_STEPS)
    assert list(t_losses) == list(j_losses) == list(range(1, N_STEPS + 1))
    for s in j_losses:
        np.testing.assert_allclose(t_losses[s], j_losses[s], atol=ATOL, rtol=0, err_msg=str(s))
    assert t_state.step == int(j_state.step) == N_STEPS
    want = jax.tree.leaves(j_state.params)
    for got, w in zip(jax.tree.leaves(llama_to_jax_params(t_state.model)), want):
        np.testing.assert_allclose(got, np.asarray(w), atol=ATOL, rtol=0)
    assert {"steps_per_s", "tokens_per_s"} <= set(metrics)


def test_interrupted_run_resumes_like_jax_fit(rig, tmp_path):
    """A real SIGTERM as step 3 is about to run: step 3 still executes, the
    next boundary saves it and fit returns; the second fit resumes there."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(checkpoint_every=2)
    faults.reset("step.exec:3:sigterm")
    jfaults.reset("step.exec:3:sigterm")
    j_first, _ = _run_jax(rig, N_STEPS, checkpoint_dir=jdir, **kw)
    t_first, t_first_losses, _ = _run_port(rig, N_STEPS, checkpoint_dir=tdir, **kw)
    assert t_first.step == int(j_first.step) == 3
    assert _step_dirs(tdir) == _step_dirs(jdir) == [2, 3]
    assert latest_step(tdir) == jlatest_step(jdir) == 3
    assert not preemption.requested()

    j_state, j_losses = _run_jax(rig, N_STEPS, checkpoint_dir=jdir, **kw)
    t_state, t_losses, _ = _run_port(rig, N_STEPS, checkpoint_dir=tdir, **kw)
    assert list(t_losses) == list(j_losses) == [4, 5]  # resumed at 3 on both
    for s in j_losses:
        np.testing.assert_allclose(t_losses[s], j_losses[s], atol=ATOL, rtol=0)
    assert t_state.step == int(j_state.step) == N_STEPS
    assert _step_dirs(tdir) == _step_dirs(jdir) == [3, 4, 5]

    straight, _, _ = _run_port(rig, N_STEPS, handle_preemption=False)
    for a, b in zip(straight.model.parameters(), t_state.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-5, atol=2e-6)
    for got, w in zip(jax.tree.leaves(llama_to_jax_params(t_state.model)),
                      jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(got, np.asarray(w), atol=ATOL, rtol=0)


def test_resume_past_a_short_stream_raises(rig, tmp_path):
    run = str(tmp_path / "run")
    _run_port(rig, 3, checkpoint_dir=run, checkpoint_every=2)
    _, _, t_batches = rig[1]
    with pytest.raises(ValueError, match="exhausted"):
        _run_port(rig, 5, batches=t_batches(2), checkpoint_dir=run)


# ---------------------------------------------------------------------------
# The reference's TestFitResilience (tests/test_resilience.py), on the port


class TestFitResilience:
    def test_ckpt_save_fault_is_retried(self, rig, tmp_path):
        c = telemetry.counter("ckpt.retries")
        before = c.value
        faults.reset("ckpt.save:2:io")
        _run_port(rig, 3, checkpoint_dir=str(tmp_path / "run"), checkpoint_every=2,
                  retry=RetryPolicy(max_attempts=3, base_delay_s=0.01))
        assert c.value - before >= 1
        assert latest_step(tmp_path / "run") == 3

    def test_ckpt_fault_without_retry_is_fatal(self, rig, tmp_path):
        faults.reset("ckpt.save:2:io")
        with pytest.raises(InjectedFault):
            _run_port(rig, 3, checkpoint_dir=str(tmp_path / "run"), checkpoint_every=2,
                      retry=None)

    def test_data_fault_is_retried(self, rig):
        c = telemetry.counter("data.retries")
        before = c.value
        faults.reset("data.next:2:io")
        state, _, _ = _run_port(rig, 3, retry=RetryPolicy(max_attempts=3, base_delay_s=0.01))
        assert c.value - before >= 1
        assert state.step == 3

    def test_final_step_saved_when_batches_exhaust(self, rig, tmp_path):
        _, _, t_batches = rig[1]
        # 3 batches, n_steps=10, checkpoint_every=100: without the final-save
        # path the run would leave NO checkpoint at all.
        _run_port(rig, 10, batches=t_batches(3), checkpoint_dir=str(tmp_path / "run"),
                  checkpoint_every=100)
        assert latest_step(tmp_path / "run") == 3

    def test_nonfinite_step_skipped_and_counted(self, rig):
        c = telemetry.counter("train.skipped_steps")
        before = c.value
        faults.reset("step.exec:2:nan")
        state, _, _ = _run_port(rig, 4)
        assert c.value - before == 1
        # 4 batches consumed, 3 optimizer steps applied (one skipped).
        assert state.step == 3

    def test_nonfinite_escalation_raises(self, rig):
        faults.reset("step.exec:1:nan,step.exec:2:nan,step.exec:3:nan")
        with pytest.raises(NonFiniteError) as ei:
            _run_port(rig, 6, max_consecutive_nonfinite=3)
        # The lagged read escalates at the third poisoned step, as in JAX.
        assert ei.value.step == 3

    def test_preemption_saves_current_step_and_resumes(self, rig, tmp_path):
        c = telemetry.counter("train.preemptions")
        before = c.value
        run = str(tmp_path / "run")

        def preempt_at_2(step, metrics):
            if step == 2:
                preemption.request()

        t_init, t_step, t_batches = rig[1]
        fit(t_init, t_step, t_batches(), seed=0, n_steps=10, checkpoint_dir=run,
            checkpoint_every=100, on_metrics=preempt_at_2)
        # Stopped at the boundary after step 2 and saved THAT step.
        assert latest_step(run) == 2
        assert c.value - before == 1
        assert not preemption.requested()

        resumed, _, _ = _run_port(rig, 5, checkpoint_dir=run, checkpoint_every=100)
        ref, _, _ = _run_port(rig, 5, handle_preemption=False)
        assert resumed.step == 5
        for a, b in zip(ref.model.parameters(), resumed.model.parameters()):
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                       rtol=2e-5, atol=2e-6)

    def test_preemption_before_any_step_is_resumable_noop(self, rig, tmp_path):
        preemption.request()
        state, _, metrics = _run_port(rig, 5, checkpoint_dir=str(tmp_path / "run"))
        assert metrics is None  # no step ran
        assert state.step == 0
        assert latest_step(tmp_path / "run") is None  # nothing to save

    def test_fit_restores_signal_handlers_on_exit(self, rig):
        prev_term = signal.getsignal(signal.SIGTERM)
        prev_int = signal.getsignal(signal.SIGINT)
        _run_port(rig, 1)
        assert signal.getsignal(signal.SIGTERM) is prev_term
        assert signal.getsignal(signal.SIGINT) is prev_int

    def test_transient_error_from_generator_fails_loudly(self, rig):
        _, _, t_batches = rig[1]

        def flaky_batches():
            inner = t_batches()
            yield next(inner)
            raise OSError("transient read error inside the generator")

        with pytest.raises(RetriesExhausted) as ei:
            _run_port(rig, 5, batches=flaky_batches(),
                      retry=RetryPolicy(max_attempts=3, base_delay_s=0.01))
        assert isinstance(ei.value.__cause__, OSError)

    def test_throughput_gauges_and_mfu(self, rig):
        state, _, metrics = _run_port(rig, 3, flops_per_step=1e6, peak_flops=1e9)
        gauges = telemetry.gauges()
        assert metrics["mfu"] == pytest.approx(1e6 * metrics["steps_per_s"] / 1e9)
        assert metrics["tokens_per_s"] == pytest.approx(BATCH[0] * BATCH[1]
                                                        * metrics["steps_per_s"])
        assert gauges["train.mfu"] == metrics["mfu"]
