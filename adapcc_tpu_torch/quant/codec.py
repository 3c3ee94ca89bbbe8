"""Block-wise wire codecs: the port of :mod:`adapcc_tpu.quant.codec`.

A codec shrinks the bytes a collective ships.  The registry names the codecs
the strategy plane speaks (``Strategy.wire_dtype``), so one definition
serves the DDP gradient hook, ZeRO-1's contributions, the engine's quantized
ring and the fused ring kernels (``csrc/ring.cu``, K5a/K5b).

The int8 wire format: a flat float32 payload of ``n`` elements is padded to
whole blocks of ``block_size`` elements and quantized per block::

    scale_b = max(|x| over block b) / 127        (float32, one per block)
    q_i     = round(x_i / scale_b)               (int8, clipped to [-127, 127])

An all-zero block keeps ``scale = 1``.  Rounding is half to even
(``torch.round``, as ``jnp.round``) and both divisions are IEEE float32
divisions, so codes and scales equal the JAX package's bit for bit.  The
stochastic mode, ``floor(y + u)`` with ``u ~ U[0, 1)``, draws ``u`` from a
caller's ``torch.Generator``: its bits are not ``jax.random``'s.

Error feedback defers the quantization error instead of dropping it:
``compensated = grad + residual``, the wire carries ``apply(compensated)``
and ``residual = compensated - wire`` folds into the next step, so
``wire + new_residual == grad + residual`` exactly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: default quantization block (elements per float32 scale)
DEFAULT_BLOCK_SIZE = 256

#: env override for the wire codec; wins over the caller's value and the
#: strategy's wire_dtype (the ADAPCC_RING_CHUNK_BYTES precedence)
WIRE_DTYPE_ENV = "ADAPCC_WIRE_DTYPE"


# --------------------------------------------------------------------------- #
# block-wise int8 quantize / dequantize
# --------------------------------------------------------------------------- #


def _as_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[n]`` → ``[nblocks, block_size]``, zero-padded to whole blocks."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    n = flat.shape[0]
    nblocks = -(-n // block_size) if n else 1
    pad = nblocks * block_size - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(nblocks, block_size)


def quantize_int8(
    flat: torch.Tensor,
    block_size: int = DEFAULT_BLOCK_SIZE,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise int8 quantization of a flat payload: ``(q [nblocks,
    block_size] int8, scales [nblocks] float32)``.  Stochastic rounding needs
    ``generator`` and is unbiased in expectation."""
    blocks = _as_blocks(flat.to(torch.float32), block_size)
    absmax = blocks.abs().amax(dim=1)
    # a tensor divisor: torch on CUDA multiplies by the reciprocal of a
    # Python scalar, which is not the IEEE quotient the codec is defined by
    scales = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), torch.ones_like(absmax))
    y = blocks / scales[:, None]
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        u = torch.rand(y.shape, generator=generator, device=y.device, dtype=torch.float32)
        q = torch.floor(y + u)
    else:
        q = torch.round(y)
    return q.clamp_(-127.0, 127.0).to(torch.int8), scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; ``n`` trims the block padding."""
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    return flat if n is None else flat[:n]


def int8_roundtrip(
    flat: torch.Tensor,
    block_size: int = DEFAULT_BLOCK_SIZE,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The wire value of a payload: ``decode(encode(x))``."""
    q, scales = quantize_int8(flat, block_size, stochastic, generator)
    return dequantize_int8(q, scales, flat.shape[0])


def int8_error_bound(flat: Any, block_size: int = DEFAULT_BLOCK_SIZE, stochastic: bool = False) -> np.ndarray:
    """Elementwise ``|x - roundtrip(x)|`` bound (numpy): half a quantization
    step of the element's block under deterministic rounding, a full step
    under stochastic rounding."""
    flat = np.asarray(flat, dtype=np.float32).reshape(-1)
    blocks = _as_blocks(torch.from_numpy(flat), block_size).numpy()
    absmax = np.max(np.abs(blocks), axis=1)
    step = np.where(absmax > 0, absmax / 127.0, 1.0)
    per_block = step * (1.0 if stochastic else 0.5)
    return np.repeat(per_block, block_size)[: flat.shape[0]]


# --------------------------------------------------------------------------- #
# codec registry: the one place codecs are named
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class WireCodec:
    """One wire codec: the value every contribution takes on the wire
    (``apply(x, block_size)``, in ``x``'s shape and dtype), the arrays that
    cross the wire (``encode(flat, block_size)``), their inverse
    (``decode(wire, n, block_size)`` → flat float32), and the wire bytes one
    payload element costs (``wire_bytes_per_element(block_size, elem_bytes)``)."""

    name: str
    apply: Callable[..., torch.Tensor]
    encode: Callable[..., Tuple[torch.Tensor, ...]]
    decode: Callable[..., torch.Tensor]
    wire_bytes_per_element: Callable[[int, float], float]


def _identity_apply(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    return x


def _bf16_apply(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _int8_apply(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    flat = x.reshape(-1).to(torch.float32)
    return int8_roundtrip(flat, block_size).reshape(x.shape).to(x.dtype)


_REGISTRY: Dict[str, WireCodec] = {}


def register_codec(codec: WireCodec) -> WireCodec:
    """Add a codec; a name registered twice raises (two meanings of one
    wire_dtype must never coexist)."""
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def codec_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_codec(name: str) -> WireCodec:
    """Registry lookup; an unknown name raises listing the known ones."""
    codec = _REGISTRY.get(name)
    if codec is None:
        raise ValueError(f"unknown wire codec {name!r}; registered codecs: {'|'.join(codec_names())}")
    return codec


register_codec(WireCodec(
    name="off",
    apply=_identity_apply,
    encode=lambda flat, block_size=DEFAULT_BLOCK_SIZE: (flat,),
    decode=lambda wire, n, block_size=DEFAULT_BLOCK_SIZE: wire[0][:n],
    wire_bytes_per_element=lambda block_size=DEFAULT_BLOCK_SIZE, elem_bytes=4.0: float(elem_bytes),
))

register_codec(WireCodec(
    name="bf16",
    apply=_bf16_apply,
    encode=lambda flat, block_size=DEFAULT_BLOCK_SIZE: (flat.to(torch.bfloat16),),
    decode=lambda wire, n, block_size=DEFAULT_BLOCK_SIZE: wire[0].to(torch.float32)[:n],
    wire_bytes_per_element=lambda block_size=DEFAULT_BLOCK_SIZE, elem_bytes=4.0: 2.0,
))

register_codec(WireCodec(
    name="int8",
    apply=_int8_apply,
    encode=lambda flat, block_size=DEFAULT_BLOCK_SIZE: quantize_int8(flat, block_size),
    decode=lambda wire, n, block_size=DEFAULT_BLOCK_SIZE: dequantize_int8(wire[0], wire[1], n),
    wire_bytes_per_element=lambda block_size=DEFAULT_BLOCK_SIZE, elem_bytes=4.0: 1.0 + 4.0 / block_size,
))


def resolve_wire_dtype(wire_dtype: Optional[str] = None) -> str:
    """The wire codec in force: the ``ADAPCC_WIRE_DTYPE`` override wins, then
    the caller's value, then ``"off"``.  A malformed override or an unknown
    name raises: a typo must not silently run another codec."""
    env = os.environ.get(WIRE_DTYPE_ENV)
    if env is not None and env.strip():
        name = env.strip()
        if name not in _REGISTRY:
            raise ValueError(f"{WIRE_DTYPE_ENV}={env!r}: expected one of {'|'.join(codec_names())}")
        return name
    if wire_dtype is None:
        return "off"
    return get_codec(wire_dtype).name


# --------------------------------------------------------------------------- #
# error feedback
# --------------------------------------------------------------------------- #


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensors of matching dicts, lists, tuples or tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def error_feedback_step(grads: Any, residual: Any, apply_fn: Callable[[torch.Tensor], torch.Tensor]) -> Tuple[Any, Any]:
    """One error-feedback round over a tree of tensors (dict, list, tuple or
    one tensor): ``(wire, new_residual)`` with ``wire = apply(grads +
    residual)`` and ``new_residual = (grads + residual) - wire``."""
    compensated = _tree_map(lambda g, r: g + r, grads, residual)
    wire = _tree_map(apply_fn, compensated)
    new_residual = _tree_map(lambda c, w: c - w, compensated, wire)
    return wire, new_residual


# --------------------------------------------------------------------------- #
# host-side codec timing
# --------------------------------------------------------------------------- #

#: process-wide default registry for codec timings, created on first use
CODEC_METRICS = None


def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def timed_roundtrip(name: str, x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE, registry=None) -> torch.Tensor:
    """Encode and decode ``x`` through codec ``name``, recording each half's
    walltime, the device's work included (a sync before each clock read),
    as ``quant.<name>.quantize`` / ``quant.<name>.dequantize`` in the
    metrics registry (the module's default when none is given).  Returns
    the decoded values in ``x``'s shape, float32."""
    global CODEC_METRICS
    if registry is None:
        if CODEC_METRICS is None:
            from adapcc_tpu_torch.utils.observability import MetricsRegistry

            CODEC_METRICS = MetricsRegistry()
        registry = CODEC_METRICS
    codec = get_codec(name)
    flat = x.reshape(-1).to(torch.float32)
    _wait(flat)
    with registry.timer(f"quant.{name}.quantize"):
        wire = codec.encode(flat, block_size)
        _wait(wire[0])
    with registry.timer(f"quant.{name}.dequantize"):
        out = codec.decode(wire, flat.shape[0], block_size)
        _wait(out)
    return out.reshape(x.shape)
