"""Carry flax GPT-2 weights and ZeRO-1 state across to the port.

:func:`flax_to_state_dict` turns the flax parameter tree of
:class:`adapcc_tpu.models.gpt2.GPT2`, given as nested dicts of numpy arrays,
into a ``state_dict`` for :class:`adapcc_tpu_torch.models.gpt2.GPT2`:

- ``Dense.kernel`` is ``[in, out]`` and becomes the transposed ``Linear.weight``;
- ``LayerNorm.scale`` becomes ``weight``;
- ``Embed.embedding`` becomes ``Embedding.weight``;
- module names (``h{i}``, ``attn``, ``qkv``, ``ln_f``, ...) stay as they are.

:func:`flax_paths` is the inverse map, parameter by parameter; the ZeRO-1
flat layout orders the leaves by it.  :func:`zero1_state_from_jax` carries a
JAX ZeRO-1 ``(master, opt_state)`` pair across, and :func:`residual_from_jax`
one rank's error-feedback residual of the JAX ``DDPTrainer``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax GPT-2 tree (with or without the
    top-level ``"params"`` collection)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            if name not in _LEAF_NAMES:
                raise ValueError(f"unknown flax parameter {prefix}{name}")
            arr = np.asarray(value)
            if name == "kernel":
                arr = arr.T
            if arr.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, narrow back
                t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, order="C"))  # a writable, contiguous copy
            out[f"{prefix}{_LEAF_NAMES[name]}"] = t

    walk(params, "")
    return out


def flax_paths(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """``{parameter name: (flax path, transposed)}`` for a model built of
    ``Linear``, ``LayerNorm`` and ``Embedding`` modules: the path of the leaf
    in the flax tree (``("h0", "attn", "qkv", "kernel")``) and whether the
    flax leaf is the transpose of the torch parameter (a ``Dense.kernel``).
    Sorting by path gives ``jax.tree_util``'s leaf order, which sorts dict
    keys at every level."""
    modules = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        mod_name, _, pname = name.rpartition(".")
        mod = modules[mod_name]
        if pname == "bias":
            leaf = "bias"
        elif isinstance(mod, nn.Linear):
            leaf = "kernel"
        elif isinstance(mod, nn.LayerNorm):
            leaf = "scale"
        elif isinstance(mod, nn.Embedding):
            leaf = "embedding"
        else:
            raise ValueError(f"no flax leaf for {name} ({type(mod).__name__})")
        out[name] = ((*mod_name.split("."), leaf), leaf == "kernel")
    return out


def _adam_state(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state, e.g. ``optax.adamw``'s ``(ScaleByAdamState, EmptyState, EmptyState)``."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def zero1_state_from_jax(master: Any, opt_state: Any) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A JAX ``Zero1Optimizer`` pair as numpy (``jax.device_get`` of
    ``(master [world, N/world], optax adamw state)``) → the port's
    ``(master, Adam state)``: the float32 master and ``{"step", "exp_avg",
    "exp_avg_sq"}``, the state ``torch.optim.AdamW`` keeps for it.  The flat
    layouts match element for element (``parallel/fsdp.py``), so nothing is
    permuted."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    counts = np.unique(np.asarray(adam.count))
    if counts.size != 1:
        raise ValueError(f"per-rank Adam step counts differ: {counts}")

    def f32(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    state = {"step": torch.tensor(float(counts[0])), "exp_avg": f32(adam.mu), "exp_avg_sq": f32(adam.nu)}
    return f32(master), state


def residual_from_jax(residual: Mapping[str, Any], model: nn.Module, rank: int) -> List[torch.Tensor]:
    """Rank ``rank``'s error-feedback residual of the JAX ``DDPTrainer``
    (its ``_residual``: the flax tree with a leading ``[world]`` dim, float32,
    as numpy) → the port's residual for that rank: one float32 tensor per
    parameter of ``model``, in ``model.parameters()`` order."""

    def row(tree: Mapping[str, Any]) -> Dict[str, Any]:
        return {k: row(v) if isinstance(v, Mapping) else np.asarray(v, dtype=np.float32)[rank]
                for k, v in tree.items()}

    by_name = flax_to_state_dict(row(residual))
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(by_name):
        raise ValueError(f"residual leaves {sorted(by_name)} do not match the model's {sorted(names)}")
    return [by_name[name] for name in names]
