"""Serving crash child for the port's journal kill -9 test
(``tests/test_torch_journal.py``), after ``tests/_serving_crash_child.py``.
Torch only: it imports nothing of JAX.

``argv = journal_dir temperature``: build ``llama_test`` on the CPU from
``torch.manual_seed(0)``, serve ``N_REQ`` requests through a journaled
engine (``fsync="tick"``), print ``PROGRESS`` once every stream has
committed tokens (the tick's fsync has landed), then keep stepping slowly
until the parent's SIGKILL arrives: no ``finally``, no ``atexit``, the
journal unclosed and the owner lock left behind.  ``FINISHED`` if it never
comes.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_REQ = 4
MAX_NEW = 24
ENGINE_KW = dict(num_slots=4, block_size=8, num_blocks=41, max_model_len=64, decode_chunk=4,
                 max_prefills_per_tick=4, handle_preemption=False)


def build(temperature, journal=None):
    """The engine of both sides: ``llama_test`` from seed 0 on the CPU."""
    import torch

    from torchdistx_tpu_torch.models.llama import Llama, llama_test
    from torchdistx_tpu_torch.serving import Engine

    torch.manual_seed(0)
    model = Llama(llama_test(), device="cpu")
    return Engine(model, device="cpu", temperature=temperature,
                  top_k=8 if temperature else None, journal=journal, **ENGINE_KW)


def prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=6).astype(np.int32) for _ in range(N_REQ)]


def main() -> int:
    from torchdistx_tpu_torch.serving import RequestJournal

    jdir, temperature = sys.argv[1], float(sys.argv[2])
    eng = build(temperature, journal=RequestJournal(jdir, fsync="tick"))
    hs = [eng.submit(p, max_new_tokens=MAX_NEW, key=i)
          for i, p in enumerate(prompts(eng.cfg.vocab_size))]
    while not all(h._tokens for h in hs):
        eng.step()
    print("PROGRESS", flush=True)
    while not all(h.done for h in hs):
        time.sleep(0.2)
        eng.step()
    print("FINISHED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
