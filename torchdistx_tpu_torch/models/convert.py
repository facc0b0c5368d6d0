"""Move parameters between the JAX package's layout and the port's, and read
Hugging Face checkpoints.

The JAX pytrees (``_shapes`` of ``torchdistx_tpu.models.{llama,gpt2,moe}``)
store weights ``(in, out)`` with the layers stacked on axis 0; the port's
modules keep ``nn.Linear`` weights ``(out, in)``, one block per layer (MoE
expert weights keep the JAX ``(E, in, out)``).  ``*_from_jax_params`` /
``*_to_jax_params`` carry a model across in either direction, as float32
numpy arrays.

The HF half (counterpart of ``torchdistx_tpu/models/convert.py``) turns a
flat HF GPT-2 or Llama parameter dict (a ``state_dict()``, or the values of
``materialize_module_torch`` of a ``deferred_init`` HF model) into the
JAX-layout numpy pytree, which ``gpt2_from_jax_params`` /
``llama_from_jax_params`` then load: HF GPT-2's ``Conv1D`` weights are
``(in, out)`` already, HF Llama's ``nn.Linear`` ones are transposed, and a
Llama without ``lm_head.weight`` (tied) takes ``embed_tokens.weight``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .._device import resolve_device
from .gpt2 import GPT2, GPT2Config
from .llama import Llama, LlamaConfig
from .moe import MoE, MoEConfig

__all__ = [
    "copy_jax_params_",
    "llama_from_jax_params",
    "llama_to_jax_params",
    "gpt2_from_jax_params",
    "gpt2_to_jax_params",
    "moe_from_jax_params",
    "moe_to_jax_params",
    "to_jax_params",
    "gpt2_config_from_hf",
    "llama_config_from_hf",
    "gpt2_params_from_hf",
    "llama_params_from_hf",
]

# (JAX pytree path, port parameter name, transpose to (out, in)); a name
# with "{i}" is one parameter per layer, stacked on axis 0 in the pytree.
_Table = List[Tuple[Tuple[str, ...], str, bool]]

_LLAMA_ATTENTION: _Table = [
    (("layers", "attn_norm"), "layers.{i}.attn_norm.weight", False),
    *((("layers", k), f"layers.{{i}}.{k}.weight", True) for k in ("wq", "wk", "wv", "wo")),
    (("layers", "mlp_norm"), "layers.{i}.mlp_norm.weight", False),
]
_LLAMA_ENDS: _Table = [
    (("embed", "weight"), "embed.weight", False),
    (("norm", "weight"), "norm.weight", False),
    (("lm_head", "weight"), "lm_head.weight", True),
]
_TABLES: Dict[type, _Table] = {
    Llama: _LLAMA_ENDS + _LLAMA_ATTENTION + [
        (("layers", k), f"layers.{{i}}.{k}.weight", True) for k in ("w_gate", "w_up", "w_down")
    ],
    MoE: _LLAMA_ENDS + _LLAMA_ATTENTION + [
        (("layers", "router"), "layers.{i}.router.weight", True),
        *((("layers", k), f"layers.{{i}}.{k}", False) for k in ("e_gate", "e_up", "e_down")),
    ],
    GPT2: [
        (("wte", "weight"), "wte.weight", False),
        (("wpe", "weight"), "wpe.weight", False),
        *(entry for name in ("ln_1", "ln_2") for entry in (
            (("layers", name, "scale"), f"layers.{{i}}.{name}.weight", False),
            (("layers", name, "bias"), f"layers.{{i}}.{name}.bias", False))),
        *(entry for name in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj") for entry in (
            (("layers", name, "weight"), f"layers.{{i}}.{name}.weight", True),
            (("layers", name, "bias"), f"layers.{{i}}.{name}.bias", False))),
        (("ln_f", "scale"), "ln_f.weight", False),
        (("ln_f", "bias"), "ln_f.bias", False),
    ],
}


def _table(model: nn.Module) -> _Table:
    for cls, table in _TABLES.items():
        if type(model) is cls:
            return table
    raise TypeError(f"no JAX layout for {type(model).__name__} (Llama, GPT2 or MoE)")


def copy_jax_params_(model: nn.Module, params_np: dict) -> nn.Module:
    """Copy the JAX parameters ``params_np`` (a pytree of numpy arrays; bf16
    arrays may be passed as ``np.asarray(x, np.float32)``) into ``model``'s
    parameters in place, cast to their dtype.  ``model`` is a :class:`Llama`,
    :class:`GPT2` or :class:`MoE`.  The parameter objects stay the same, so
    an optimizer built over them keeps working.  Returns ``model``."""

    def put(dst: torch.Tensor, src, transpose: bool) -> None:
        t = torch.tensor(np.asarray(src, np.float32))
        if transpose:
            t = t.T
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)

    with torch.no_grad():
        for path, name, transpose in _table(model):
            src = params_np
            for key in path:
                src = src[key]
            if "{i}" not in name:
                put(model.get_parameter(name), src, transpose)
                continue
            for i in range(model.cfg.n_layers):
                put(model.get_parameter(name.format(i=i)), src[i], transpose)
    return model


def _from_jax(cls, params_np: dict, cfg, device) -> nn.Module:
    device = resolve_device(device)
    model = cls(cfg, device="meta").to_empty(device=device)
    return copy_jax_params_(model, params_np)


def to_jax_params(model: nn.Module, *, grads: bool = False) -> dict:
    """``model``'s parameters (or, with ``grads``, their ``.grad``) in the
    JAX pytree layout of its family, as float32 numpy arrays: layers
    stacked on axis 0, weights ``(in, out)``."""

    def get(name: str, transpose: bool) -> np.ndarray:
        p = model.get_parameter(name)
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        t = t.detach().float().cpu()
        return (t.T if transpose else t).numpy()

    tree: dict = {}
    for path, name, transpose in _table(model):
        if "{i}" in name:
            leaf = np.stack([get(name.format(i=i), transpose)
                             for i in range(model.cfg.n_layers)])
        else:
            leaf = get(name, transpose)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def llama_from_jax_params(params_np: dict, cfg: LlamaConfig,
                          device: Optional[Any] = None) -> Llama:
    """A :class:`Llama` on ``device`` computing the same function as the JAX
    parameters ``params_np`` (see :func:`copy_jax_params_`).  Values are
    cast to ``cfg.dtype``."""
    return _from_jax(Llama, params_np, cfg, device)


def gpt2_from_jax_params(params_np: dict, cfg: GPT2Config,
                         device: Optional[Any] = None) -> GPT2:
    """A :class:`GPT2` from the JAX GPT-2 pytree, as
    :func:`llama_from_jax_params`."""
    return _from_jax(GPT2, params_np, cfg, device)


def moe_from_jax_params(params_np: dict, cfg: MoEConfig,
                        device: Optional[Any] = None) -> MoE:
    """A :class:`MoE` from the JAX MoE pytree, as
    :func:`llama_from_jax_params`."""
    return _from_jax(MoE, params_np, cfg, device)


llama_to_jax_params = gpt2_to_jax_params = moe_to_jax_params = to_jax_params


# ---------------------------------------------------------------------------
# Hugging Face checkpoints -> the JAX-layout numpy pytree


def gpt2_config_from_hf(hf_config, **overrides) -> GPT2Config:
    return GPT2Config(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        max_seq_len=hf_config.n_positions,
        norm_eps=hf_config.layer_norm_epsilon,
        **overrides,
    )


def llama_config_from_hf(hf_config, **overrides) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        ffn_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        **overrides,
    )


def _numpy(value) -> np.ndarray:
    """A numpy array of a torch tensor (bf16 widened to f32) or an
    array-like."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def _get(arrays: Dict[str, Any], name: str, *, prefixes=("", "transformer.", "model.")):
    for p in prefixes:
        if p + name in arrays:
            return _numpy(arrays[p + name])
    raise KeyError(
        f"parameter '{name}' not found (tried prefixes {list(prefixes)}); "
        f"have e.g. {sorted(arrays)[:5]}"
    )


def _stack(arrays, fmt: str, n_layers: int, *, transpose: bool = False) -> np.ndarray:
    leaves = []
    for i in range(n_layers):
        a = _get(arrays, fmt.format(i=i))
        leaves.append(a.T if transpose else a)
    return np.stack(leaves)


def _count_layers(arrays, fmt: str) -> int:
    i = 0
    while any(k.endswith(fmt.format(i=i)) for k in arrays):
        i += 1
    return i


def gpt2_params_from_hf(arrays: Dict[str, Any], cfg: Optional[GPT2Config] = None) -> dict:
    """Flat HF GPT-2 parameter dict -> the JAX GPT-2 pytree (numpy), for
    :func:`gpt2_from_jax_params`.  ``arrays``: ``{name: tensor or
    array-like}``, names with or without the ``transformer.`` prefix; the
    layer count from ``cfg`` or from the names."""
    n = cfg.n_layers if cfg is not None else _count_layers(arrays, "h.{i}.ln_1.weight")

    def pair(hf: str, weight: str = "weight") -> dict:
        return {weight: _stack(arrays, f"h.{{i}}.{hf}.weight", n),
                "bias": _stack(arrays, f"h.{{i}}.{hf}.bias", n)}

    return {
        "wte": {"weight": _get(arrays, "wte.weight")},
        "wpe": {"weight": _get(arrays, "wpe.weight")},
        "layers": {
            "ln_1": pair("ln_1", "scale"),
            "attn_qkv": pair("attn.c_attn"),
            "attn_proj": pair("attn.c_proj"),
            "ln_2": pair("ln_2", "scale"),
            "mlp_fc": pair("mlp.c_fc"),
            "mlp_proj": pair("mlp.c_proj"),
        },
        "ln_f": {"scale": _get(arrays, "ln_f.weight"), "bias": _get(arrays, "ln_f.bias")},
    }


def llama_params_from_hf(arrays: Dict[str, Any], cfg: Optional[LlamaConfig] = None) -> dict:
    """Flat HF Llama parameter dict -> the JAX Llama pytree (numpy, linears
    transposed to ``(in, out)``), for :func:`llama_from_jax_params`.  With
    no ``lm_head.weight`` (tied embeddings) the head is the embedding."""
    n = (cfg.n_layers if cfg is not None
         else _count_layers(arrays, "layers.{i}.input_layernorm.weight"))
    lm_head = (_get(arrays, "lm_head.weight")
               if any(k.endswith("lm_head.weight") for k in arrays)
               else _get(arrays, "embed_tokens.weight"))

    def linear(hf: str) -> np.ndarray:
        return _stack(arrays, f"layers.{{i}}.{hf}.weight", n, transpose=True)

    return {
        "embed": {"weight": _get(arrays, "embed_tokens.weight")},
        "layers": {
            "attn_norm": _stack(arrays, "layers.{i}.input_layernorm.weight", n),
            "wq": linear("self_attn.q_proj"),
            "wk": linear("self_attn.k_proj"),
            "wv": linear("self_attn.v_proj"),
            "wo": linear("self_attn.o_proj"),
            "mlp_norm": _stack(arrays, "layers.{i}.post_attention_layernorm.weight", n),
            "w_gate": linear("mlp.gate_proj"),
            "w_up": linear("mlp.up_proj"),
            "w_down": linear("mlp.down_proj"),
        },
        "norm": {"weight": _get(arrays, "norm.weight")},
        "lm_head": {"weight": lm_head.T},
    }
