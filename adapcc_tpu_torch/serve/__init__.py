"""The latency-SLO serving plane (the port of :mod:`adapcc_tpu.serve`), in
the JAX plane's single-controller form: a tensor-parallel world's ranks
stacked as the leading ``[world, ...]`` dimension on one device.

- :mod:`~adapcc_tpu_torch.serve.trace`: seeded synthetic request traffic,
  replayable as a JSON artifact (``ADAPCC_SERVE_TRACE``);
- :mod:`~adapcc_tpu_torch.serve.kv_cache`: the slot-paged KV cache laid out
  by heads over the world, with the slot lifecycle (admission zeroes a
  slot, evict-on-EOS frees it for the next request);
- :mod:`~adapcc_tpu_torch.serve.model`: the head-sharded decode step whose
  per-token combine is ONE :meth:`CollectiveEngine.all_reduce` per layer
  over a zero-padded partial, so each column has one addend that may be
  non-zero and the sum is exact;
- :mod:`~adapcc_tpu_torch.serve.scheduler`: the continuous batcher
  (admission into fixed decode slots, prefill and decode interleaved,
  a generator per request, step-clock and wall-clock latency ledgers);
- :mod:`~adapcc_tpu_torch.serve.disagg`: the prefill/decode router over
  :meth:`CollectiveEngine.kv_transfer`.

Offline pricing lives in :mod:`adapcc_tpu_torch.sim.cost_model`
(``decode_step_time``, ``serve_queue_metrics``, ``disagg_queue_metrics``).
"""

from __future__ import annotations

import os
from typing import Optional

#: fixed decode-slot count of the continuous batcher (env > arg > default)
SERVE_SLOTS_ENV = "ADAPCC_SERVE_SLOTS"

DEFAULT_SERVE_SLOTS = 4

#: per-request sojourn SLO in milliseconds (env > arg > None = no SLO)
SERVE_SLO_ENV = "ADAPCC_SERVE_SLO_MS"


def resolve_serve_slots(explicit: Optional[int] = None) -> int:
    """Decode-slot count in force: ``ADAPCC_SERVE_SLOTS`` env > the caller's
    explicit value > :data:`DEFAULT_SERVE_SLOTS`.  Malformed or non-positive
    values raise: a typo'd slot count serving another batch geometry would
    invalidate the latency numbers the run was meant to produce."""
    env = os.environ.get(SERVE_SLOTS_ENV)
    value: object = env if env is not None and env.strip() else explicit
    if value is None:
        return DEFAULT_SERVE_SLOTS
    try:
        slots = int(str(value).strip())
    except ValueError as e:
        raise ValueError(f"{SERVE_SLOTS_ENV}={value!r}: expected a positive integer") from e
    if slots < 1:
        raise ValueError(f"{SERVE_SLOTS_ENV}={value!r}: slot count must be >= 1")
    return slots


def resolve_serve_slo_ms(explicit: Optional[float] = None) -> Optional[float]:
    """Sojourn SLO in force: ``ADAPCC_SERVE_SLO_MS`` env > the caller's
    explicit value > None (no SLO tracked).  Malformed or non-positive
    values raise."""
    env = os.environ.get(SERVE_SLO_ENV)
    value: object = env if env is not None and env.strip() else explicit
    if value is None:
        return None
    try:
        slo = float(str(value).strip())
    except ValueError as e:
        raise ValueError(f"{SERVE_SLO_ENV}={value!r}: expected a positive number of milliseconds") from e
    if slo <= 0:
        raise ValueError(f"{SERVE_SLO_ENV}={value!r}: the SLO must be > 0 ms")
    return slo


from adapcc_tpu_torch.serve.kv_cache import SlotKVCache  # noqa: E402
from adapcc_tpu_torch.serve.model import TPDecodeModel  # noqa: E402
from adapcc_tpu_torch.serve.scheduler import GPT2Server, Request, RequestResult  # noqa: E402
from adapcc_tpu_torch.serve.trace import (  # noqa: E402
    SERVE_TRACE_ENV,
    ArrivalTrace,
    RequestSpec,
    load_serve_trace,
    synthesize_arrival_trace,
)
from adapcc_tpu_torch.serve.disagg import (  # noqa: E402
    DISAGG_ENV,
    KV_KL_BOUND_ENV,
    KV_WIRE_DTYPE_ENV,
    ClusterRouter,
    measure_token_kl,
    resolve_disagg,
    resolve_kv_kl_bound,
    resolve_kv_wire_dtype,
)

__all__ = [
    "ArrivalTrace",
    "ClusterRouter",
    "DEFAULT_SERVE_SLOTS",
    "DISAGG_ENV",
    "GPT2Server",
    "KV_KL_BOUND_ENV",
    "KV_WIRE_DTYPE_ENV",
    "Request",
    "RequestResult",
    "RequestSpec",
    "SERVE_SLO_ENV",
    "SERVE_SLOTS_ENV",
    "SERVE_TRACE_ENV",
    "SlotKVCache",
    "TPDecodeModel",
    "load_serve_trace",
    "measure_token_kl",
    "resolve_disagg",
    "resolve_kv_kl_bound",
    "resolve_kv_wire_dtype",
    "resolve_serve_slo_ms",
    "resolve_serve_slots",
    "synthesize_arrival_trace",
]
