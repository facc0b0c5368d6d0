"""Autoregressive generation: prefill, then a decode loop over the KV cache.

Counterpart of ``torchdistx_tpu/models/generate.py``.  The cache is
allocated at ``prompt_len + max_new_tokens`` up front and updated in place;
the decode weights are fused once per call.  Greedy decoding
(``temperature=0``) is token-identical to the JAX version.

Sampling takes one of two sources.  ``key=`` (an int seed or two 32-bit
words, as the JAX ``generate`` takes a key) samples step ``n`` by
:func:`sample_keyed`: Gumbel-max over the masked logits, its uniforms a
counter-based hash of ``(key, n, column)``, so a step's draw depends on
the key and the step alone, never on the batch, the row's slot or the
generator state.  The serving engine samples the same way, so its streams
equal ``generate(key=k)`` on the same device.  JAX's values are not
matched: threefry's ``fold_in(key, n)`` is not reproduced.  Without a key,
``generator`` is drawn from (PyTorch's default one when ``None``).
:func:`fold_key` derives a key from a key and an index on the same hash
(the engine keys fork sibling ``i`` with it, where JAX uses ``fold_in``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["fold_key", "generate", "keyed_uniform", "sample_keyed"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit avalanche hash (lowbias32's shifts and multipliers) on int64
    tensors that hold values below ``2**32``; both multipliers are below
    ``2**31``, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def fold_key(key: Any, i: int):
    """A new key, two 32-bit words (``(2,) uint32``), from ``key`` (an int
    seed or two words, normalized by
    :func:`~torchdistx_tpu_torch.telemetry.audit.canonical_key`) and the
    index ``i``, by the counter-based hash of :func:`keyed_uniform` on
    Python ints: the port's counterpart of ``jax.random.fold_in`` (not its
    values).  Distinct indices give unrelated keys."""
    import numpy as np

    from ..telemetry.audit import canonical_key

    k0, k1 = (int(w) for w in canonical_key(key))
    i = int(i) & _M32
    w0 = _mix32(_mix32(k0 ^ _GOLDEN) ^ i)
    w1 = _mix32(_mix32(k1 ^ w0) ^ ((i + _GOLDEN) & _M32))
    return np.asarray([w0, w1], dtype=np.uint32)


def keyed_uniform(keys, steps, n_cols: int, rows=None):
    """Uniforms in (0, 1), float32 ``(B, n_cols)``: element ``(b, c)`` is a
    function of ``keys[b]`` (two 32-bit words, int64 ``(B, 2)``),
    ``steps[b]`` (int64 ``(B,)``) and the counter ``c + rows[b] * n_cols``
    (``rows`` int64 ``(B,)``, zero when ``None``) alone.  Integer ops only
    until the last cast, so CPU and CUDA give the same bits."""
    keys = keys.long()
    seed = _mix32(_mix32(_mix32(keys[:, 0]) ^ keys[:, 1]) ^ (steps.long() & _M32))
    cols = torch.arange(n_cols, device=keys.device, dtype=torch.int64)[None]
    if rows is not None:
        cols = cols + rows.long()[:, None] * n_cols
    h = _mix32((_mix32((cols & _M32) ^ seed[:, None]) + _GOLDEN) & _M32)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_keyed(logits, keys, steps, temperature: float, top_k: Optional[int], rows=None):
    """One token a row of ``logits (B, V)`` (float32): ``argmax`` at
    ``temperature == 0``; else Gumbel-max over ``logits / temperature``
    with everything below the ``top_k``-th value masked, the noise from
    :func:`keyed_uniform` (``keys``, ``steps``, ``rows`` as there).  No
    generator state and no host sync, so it runs inside a CUDA graph."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _scaled(logits, temperature, top_k)
    u = keyed_uniform(keys, steps, logits.shape[-1], rows)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _scaled(logits, temperature: float, top_k: Optional[int]):
    """``logits / temperature``, everything below the ``top_k``-th value
    at ``-inf``."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return logits


def _sample(logits, temperature: float, top_k: Optional[int], generator):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_scaled(logits, temperature, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    model,
    prompt: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    key: Any = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt (B, S)``.

    ``model`` provides ``cfg``, ``init_cache``, ``prep_decode`` and
    ``forward_cached`` (:class:`~torchdistx_tpu_torch.models.llama.Llama`,
    :class:`~torchdistx_tpu_torch.models.gpt2.GPT2`).
    Returns ``(B, max_new_tokens)`` int64 tokens on the prompt's device.
    After ``eos_id`` (if given) a sequence keeps emitting ``eos_id``; once
    every sequence is done, the remaining steps skip the model and emit
    ``eos_id``.  ``key`` (an int seed or two 32-bit words, normalized by
    :func:`~torchdistx_tpu_torch.telemetry.audit.canonical_key`) samples
    step ``n`` of row ``r`` by :func:`sample_keyed` at counter row ``r``;
    ``generator`` is then unused.
    """
    cfg = model.cfg
    b, s = prompt.shape
    total = s + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds cfg.max_seq_len ({cfg.max_seq_len})"
        )
    cache = model.init_cache(b, total, device=prompt.device)
    weights = model.prep_decode()

    if key is not None:
        from ..telemetry.audit import canonical_key

        words = torch.as_tensor(canonical_key(key).astype("int64"), device=prompt.device)
        keys = words[None].expand(b, 2)
        rows = torch.arange(b, device=prompt.device)

        def sample(logits, step):
            steps = torch.full((b,), step, dtype=torch.int64, device=prompt.device)
            return sample_keyed(logits, keys, steps, temperature, top_k, rows)
    else:
        def sample(logits, step):
            return _sample(logits, temperature, top_k, generator)

    logits, cache = model.forward_cached(prompt, cache, 0, weights)
    tok = sample(logits[:, -1], 0)
    done = tok == eos_id if eos_id is not None else None
    out = [tok]
    for i in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            # All-done early exit: no model forward, just the eos fill.
            out.append(torch.full_like(tok, eos_id))
            continue
        logits, cache = model.forward_cached(tok[:, None], cache, s + i, weights)
        tok = sample(logits[:, -1], i + 1)
        if done is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
