"""Carry flax GPT-2 weights across to the port.

:func:`flax_to_state_dict` turns the flax parameter tree of
:class:`adapcc_tpu.models.gpt2.GPT2`, given as nested dicts of numpy arrays,
into a ``state_dict`` for :class:`adapcc_tpu_torch.models.gpt2.GPT2`:

- ``Dense.kernel`` is ``[in, out]`` and becomes the transposed ``Linear.weight``;
- ``LayerNorm.scale`` becomes ``weight``;
- ``Embed.embedding`` becomes ``Embedding.weight``;
- module names (``h{i}``, ``attn``, ``qkv``, ``ln_f``, ...) stay as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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
