"""Disaggregated prefill/decode serving (the port of
:mod:`adapcc_tpu.serve.disagg`).

The colocated batcher interleaves prefill and decode in one pool, so a long
prompt stalls every decode lane behind it.  :class:`ClusterRouter` splits
serving into two pods: a *prefill pool* that turns prompts into KV pages
and first tokens, and a *decode pool* that streams the rest, the finished
prefill's pages migrating between them through
:meth:`~adapcc_tpu_torch.comm.engine.CollectiveEngine.kv_transfer`, traced
like every collective.  On one card both pods are stacked worlds on the
same device.

- the float32 (``"off"``) KV wire is the default and bit-exact: the
  disaggregated streams equal the colocated ``GPT2Server``'s;
- a lossy wire (``ADAPCC_KV_WIRE_DTYPE=int8``) is admitted only under a
  measured token-level KL bound (``ADAPCC_KV_KL_BOUND``): above it the
  router's construction raises.
"""

from __future__ import annotations

import os
from typing import Optional

#: opt into the disaggregated serving path (truthy/falsy; env > arg > off)
DISAGG_ENV = "ADAPCC_DISAGG"

#: wire dtype of the KV-page migration stream (a quant codec name)
KV_WIRE_DTYPE_ENV = "ADAPCC_KV_WIRE_DTYPE"

#: token-level KL acceptance bound for a lossy KV wire (nats)
KV_KL_BOUND_ENV = "ADAPCC_KV_KL_BOUND"

#: default acceptance bar: a lossy KV wire may distort the next-token
#: distribution by at most this much (nats)
DEFAULT_KV_KL_BOUND = 0.02

_TRUTHY = frozenset({"1", "true", "on", "yes"})
_FALSY = frozenset({"0", "false", "off", "no"})


def resolve_disagg(explicit: Optional[bool] = None) -> bool:
    """Whether the disaggregated path is in force: ``ADAPCC_DISAGG`` env >
    the caller's explicit value > off.  Anything but 1/true/on/yes vs
    0/false/off/no raises."""
    env = os.environ.get(DISAGG_ENV)
    if env is not None and env.strip():
        token = env.strip().lower()
        if token in _TRUTHY:
            return True
        if token in _FALSY:
            return False
        raise ValueError(f"{DISAGG_ENV}={env!r}: expected one of {sorted(_TRUTHY)} / {sorted(_FALSY)}")
    return bool(explicit) if explicit is not None else False


def resolve_kv_wire_dtype(explicit: Optional[str] = None) -> str:
    """KV-migration wire dtype in force: ``ADAPCC_KV_WIRE_DTYPE`` env > the
    caller's explicit value > ``"off"`` (float32, bit-exact); an unknown
    codec raises here, not mid-migration."""
    from adapcc_tpu_torch.quant import get_codec

    env = os.environ.get(KV_WIRE_DTYPE_ENV)
    value = env.strip() if env is not None and env.strip() else explicit
    name = value if value is not None else "off"
    get_codec(name)  # loud on an unknown codec name
    return name


def resolve_kv_kl_bound(explicit: Optional[float] = None) -> float:
    """Token-level KL acceptance bound (nats) in force: ``ADAPCC_KV_KL_BOUND``
    env > the caller's explicit value > :data:`DEFAULT_KV_KL_BOUND`.
    Malformed or non-positive values raise."""
    env = os.environ.get(KV_KL_BOUND_ENV)
    value: object = env if env is not None and env.strip() else explicit
    if value is None:
        return DEFAULT_KV_KL_BOUND
    try:
        bound = float(str(value).strip())
    except ValueError as e:
        raise ValueError(f"{KV_KL_BOUND_ENV}={value!r}: expected a positive KL bound in nats") from e
    if bound <= 0:
        raise ValueError(f"{KV_KL_BOUND_ENV}={value!r}: the KL bound must be > 0")
    return bound


from adapcc_tpu_torch.serve.disagg.cluster import ClusterRouter, measure_token_kl  # noqa: E402

__all__ = [
    "ClusterRouter",
    "DEFAULT_KV_KL_BOUND",
    "DISAGG_ENV",
    "KV_KL_BOUND_ENV",
    "KV_WIRE_DTYPE_ENV",
    "measure_token_kl",
    "resolve_disagg",
    "resolve_kv_kl_bound",
    "resolve_kv_wire_dtype",
]
