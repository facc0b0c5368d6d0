"""Shared helpers of the port's serving-plane tests
(``tests/test_torch_{serving_qos,serving_forks,modelpool,journal,migration}.py``):
the JAX engine and the port's engine on the same weights, and lock-step
runners that record what each engine did tick by tick."""

import jax
import numpy as np
import torch

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import gpt2_from_jax_params, llama_from_jax_params
from torchdistx_tpu_torch.models.generate import generate
from torchdistx_tpu_torch.serving import Engine

FAMILIES = {
    "llama": (jllama, jllama.llama_test, tllama.llama_test, llama_from_jax_params),
    "gpt2": (jgpt2, jgpt2.gpt2_test, tgpt2.gpt2_test, gpt2_from_jax_params),
}
SAMPLED = dict(temperature=0.8, top_k=20)


def load(name, seed=0):
    """``(jax module, jax cfg, jax params, port model)`` of ``name``'s
    ``*_test`` config (f32), the port's weights carried from JAX's."""
    jmod, jcfg_fn, tcfg_fn, convert = FAMILIES[name]
    cfg = jcfg_fn()
    params = jmod.init_params(jax.random.PRNGKey(seed), cfg)
    return jmod, cfg, params, convert(jax.tree.map(np.asarray, params), tcfg_fn(), device="cpu")


def engines(fam, **kw):
    """The JAX engine and the port's on the same weights and knobs."""
    jmod, cfg, params, model = fam
    kw = dict(handle_preemption=False, **kw)
    return (JaxEngine(params, model=jmod, cfg=cfg, **kw),
            Engine(model, device="cpu", **kw))


def prompt_of(n, base=1):
    return np.arange(base, base + n, dtype=np.int32)


def accounting(eng):
    """The page accounting JAX and the port must agree on, tick by tick."""
    a = eng.allocator
    return (a.num_in_use, a.num_free, a.num_swapped,
            len(eng.prefix) if eng.prefix is not None else 0)


def slots(eng):
    """Which request holds each slot (None when idle)."""
    return tuple(None if r is None else r.rid for r in eng._slot_req)


def run_script(eng, script, max_ticks=400):
    """Drive ``eng`` through ``script`` (``[("submit", kwargs) | ("step",)
    | ("cancel", i)]``), then until idle; returns ``(handles, trace)``,
    the trace one ``(accounting, slots)`` a tick."""
    handles, trace = [], []

    def tick():
        eng.step()
        trace.append((accounting(eng), slots(eng)))

    for op in script:
        if op[0] == "submit":
            handles.append(eng.submit(**op[1]))
        elif op[0] == "cancel":
            handles[op[1]].cancel()
        else:
            tick()
    for _ in range(max_ticks):
        if not (len(eng.scheduler) or eng._n_running()):
            break
        tick()
    return handles, trace


def solo(model, prompt, key, max_new, *, eos=None, **sample):
    """The port's solo generate, truncated at the first EOS (inclusive)."""
    out = generate(model, torch.as_tensor(np.asarray(prompt, np.int64))[None],
                   max_new_tokens=max_new, eos_id=eos, key=key, **sample)
    toks = out[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[: toks.index(eos) + 1]
    return toks
