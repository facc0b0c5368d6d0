"""Worker for the port's crash/preemption-resume test
(``test_torch_crash_resume.py``); imports torch and the port only.

Launched as ``python tests/_torch_resilience_child.py <ckpt_dir> <n_steps>
<steps_log> <params_out>`` with ``TDX_FAULT`` optionally set.  Runs the
port's ``fit()`` on ``llama_test`` on the CPU (SGD, a fixed data stream,
synchronous checkpoints every 2 steps); appends one line per EXECUTED
optimizer step to ``steps_log`` (flushed, so a hard ``os._exit`` cannot
hide steps); on an orderly exit saves the final model's state dict to
``params_out`` and prints one ``RESULT {...}`` JSON line.

:func:`run_training` is also imported by the parent test for the
uninterrupted reference run, so the computation lives in one place.
"""

import json
import os
import sys


def run_training(ckpt_dir, n_steps, on_step=None):
    """``fit()`` of ``llama_test`` on the CPU on one thread, SGD(0.1), a fixed
    data stream; returns ``(state, metrics)``."""
    import torch

    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.parallel.fit import fit
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    init_fn, step_fn = make_train_step(
        llama_test(), lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu")

    def batches():
        g = torch.Generator().manual_seed(42)
        while True:
            t = torch.randint(0, 256, (4, 16), generator=g)
            yield {"tokens": t, "targets": t}

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fit(init_fn, step_fn, batches(), seed=0, n_steps=n_steps,
                   checkpoint_dir=ckpt_dir, checkpoint_every=2,
                   # Synchronous saves: a `crash` fault must not race a
                   # background write.
                   checkpoint_sync=True, on_metrics=on_step)
    finally:
        torch.set_num_threads(threads)


def main() -> None:
    import torch

    from torchdistx_tpu_torch import telemetry

    ckpt_dir, n_steps, steps_log, params_out = sys.argv[1:5]
    log = open(steps_log, "a", buffering=1)

    def on_step(step, metrics):
        log.write(f"{step}\n")
        log.flush()
        os.fsync(log.fileno())

    state, _ = run_training(ckpt_dir, int(n_steps), on_step)
    log.close()
    torch.save(state.model.state_dict(), params_out)
    print("RESULT " + json.dumps({
        "final_step": state.step,
        "preempted": telemetry.counters().get("train.preemptions", 0) > 0,
    }), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
