"""Deterministic synthetic request traffic for the serving plane (the port
of :mod:`adapcc_tpu.serve.trace`).

Every serving claim is driven by an explicit arrival trace: seeded Poisson
inter-arrival gaps, per-request prompts, lengths and sampling seeds, all
replayable from a JSON artifact through the one env→artifact funnel
(:mod:`adapcc_tpu_torch.utils.artifacts`, ``ADAPCC_SERVE_TRACE``).  The
JSON is the JAX package's, key for key and byte for byte, so a trace saved
by either package replays in the other.

Synthesis draws from ``numpy.random.Generator(seed)`` where JAX draws from
``jax.random``: the same seed gives other traffic in the two packages (a
trace crosses between them as its JSON artifact).

Arrival times are measured in **decode steps** (the scheduler's virtual
clock), not wall seconds: the continuous batcher admits at step
boundaries, so step-granular arrivals are what it can observe, and they
keep the trace, and every percentile derived from it, byte-reproducible.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from adapcc_tpu_torch.utils.artifacts import load_env_json_artifact

#: env var naming a JSON arrival-trace artifact to replay
SERVE_TRACE_ENV = "ADAPCC_SERVE_TRACE"


@dataclass(frozen=True)
class RequestSpec:
    """One request of an arrival trace."""

    req_id: int
    #: decode step (virtual clock) at which the request becomes admissible
    arrival_step: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    #: per-request sampling seed: the serving plane samples this request
    #: from a generator seeded with it, as a one-at-a-time
    #: ``gpt2_generate.generate`` run with the same seed does
    seed: int

    def __post_init__(self) -> None:
        if self.arrival_step < 0:
            raise ValueError(f"request {self.req_id}: arrival_step must be >= 0, got {self.arrival_step}")
        if not self.prompt:
            raise ValueError(f"request {self.req_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.req_id}: max_new_tokens must be >= 1, got {self.max_new_tokens} "
                "(a request that decodes nothing is not serving traffic)"
            )

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def service_steps(self) -> int:
        """Engine steps the request occupies a decode slot: the loop length
        of the equivalent ``generate`` call (``total − 1``)."""
        return self.total_tokens - 1

    def to_dict(self) -> dict:
        return {
            "req_id": self.req_id,
            "arrival_step": self.arrival_step,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, obj: Mapping) -> "RequestSpec":
        return cls(
            req_id=int(obj["req_id"]),
            arrival_step=int(obj["arrival_step"]),
            prompt=tuple(int(t) for t in obj["prompt"]),
            max_new_tokens=int(obj["max_new_tokens"]),
            seed=int(obj["seed"]),
        )


@dataclass
class ArrivalTrace:
    """A replayable arrival schedule.  ``world`` is the tensor-parallel
    world the trace was authored for, validated by the env funnel."""

    world: int
    seed: int
    requests: List[RequestSpec] = field(default_factory=list)
    label: str = ""

    def __post_init__(self) -> None:
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        steps = [r.arrival_step for r in self.requests]
        if steps != sorted(steps):
            raise ValueError("arrival trace requests must be sorted by arrival_step (the batcher admits FIFO)")

    def to_dict(self) -> dict:
        return {
            "world": self.world,
            "seed": self.seed,
            "label": self.label,
            "requests": [r.to_dict() for r in self.requests],
        }

    @classmethod
    def from_dict(cls, obj: Mapping) -> "ArrivalTrace":
        return cls(
            world=int(obj["world"]),
            seed=int(obj["seed"]),
            label=str(obj.get("label", "")),
            requests=[RequestSpec.from_dict(r) for r in obj["requests"]],
        )

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=1)
        return path

    def __len__(self) -> int:
        return len(self.requests)


def synthesize_arrival_trace(
    world: int,
    num_requests: int,
    rate: float,
    seed: int = 0,
    prompt_len: Tuple[int, int] = (4, 12),
    max_new_tokens: Tuple[int, int] = (8, 16),
    vocab_size: int = 256,
    eos_id: Optional[int] = None,
    label: str = "synthetic-poisson",
) -> ArrivalTrace:
    """Seeded Poisson traffic: exponential inter-arrival gaps at ``rate``
    requests per decode step, uniform prompt lengths and generation budgets
    in the given inclusive ranges, uniform prompt tokens below
    ``vocab_size``, all from one ``numpy.random.Generator(seed)``.

    ``eos_id`` (when given) is kept out of prompt bodies, so an injected
    separator cannot end a request at its first sampled comparison."""
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0 requests/step, got {rate}")
    if prompt_len[0] < 1 or prompt_len[0] > prompt_len[1]:
        raise ValueError(f"bad prompt_len range {prompt_len}")
    if max_new_tokens[0] < 1 or max_new_tokens[0] > max_new_tokens[1]:
        raise ValueError(f"bad max_new_tokens range {max_new_tokens}")
    if vocab_size < 2:
        raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=num_requests) / rate
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    plens = rng.integers(prompt_len[0], prompt_len[1] + 1, size=num_requests)
    news = rng.integers(max_new_tokens[0], max_new_tokens[1] + 1, size=num_requests)
    toks = rng.integers(0, vocab_size, size=(num_requests, int(prompt_len[1])))
    if eos_id is not None:
        # deterministic re-map of any drawn eos to its neighbor token
        toks = np.where(toks == int(eos_id), (toks + 1) % vocab_size, toks)
    seeds = rng.integers(0, 1 << 30, size=num_requests)
    requests = [
        RequestSpec(
            req_id=i,
            arrival_step=int(arrivals[i]),
            prompt=tuple(int(t) for t in toks[i, : int(plens[i])]),
            max_new_tokens=int(news[i]),
            seed=int(seeds[i]),
        )
        for i in range(num_requests)
    ]
    return ArrivalTrace(world=world, seed=seed, requests=requests, label=label)


def load_serve_trace(world: Optional[int] = None, env: Optional[Mapping[str, str]] = None) -> Optional[ArrivalTrace]:
    """The ``ADAPCC_SERVE_TRACE`` env funnel: None when unset, the parsed
    artifact otherwise; a missing file, non-trace JSON or a world mismatch
    raises (the funnel's shared policy)."""
    return load_env_json_artifact(
        SERVE_TRACE_ENV,
        ArrivalTrace.from_dict,
        "serve arrival-trace",
        world=world,
        env=env,
        mismatch_hint=(
            "its prompts and head split were authored for that mesh — replaying it as-is would serve "
            "different traffic than the trace claims"
        ),
    )


def arrival_steps(trace: ArrivalTrace) -> Sequence[int]:
    """The trace's arrival clock, for the queueing model."""
    return [r.arrival_step for r in trace.requests]
