"""One env-var → JSON-artifact funnel for every injectable schedule (the port
of :mod:`adapcc_tpu.utils.artifacts`).

Injection artifacts — ``ADAPCC_FAULT_PLAN``
(:mod:`adapcc_tpu_torch.elastic.faults`) and ``ADAPCC_CONGESTION_PROFILE``
(:mod:`adapcc_tpu_torch.sim.congestion`) — share one lifecycle and one
failure policy:

- env unset → ``None`` (no injection; the healthy default),
- env set but the file is missing → :class:`FileNotFoundError`,
- env set but the file is not that artifact's JSON → :class:`ValueError`
  naming the env var and the parse failure,
- env set but the artifact was authored for another world →
  :class:`ValueError` with the artifact's hint of what silently injecting
  it would corrupt.

A set-but-broken value must never silently run un-injected (the
ADAPCC_MERGE_ROUNDS policy): the whole point of an injection artifact is
the drill it drives, and a typo'd path that "ran fine" is the drill not
happening.  This module is the ONE spelling of that funnel so the two
artifacts (and any future one) can never drift apart.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Mapping, Optional, TypeVar

T = TypeVar("T")


def load_env_json_artifact(
    env_var: str,
    from_dict: Callable[[Mapping], T],
    kind: str,
    world: Optional[int] = None,
    env: Optional[Mapping[str, str]] = None,
    mismatch_hint: str = "injecting it as-is would corrupt the drill",
) -> Optional[T]:
    """The shared env→artifact funnel (module doc).

    ``from_dict`` parses the decoded JSON object into the artifact type;
    the returned object must expose a ``world`` attribute, validated
    against the runtime ``world`` when one is given.  ``kind`` names the
    artifact in every diagnostic ("fault-plan", "congestion-profile", …).
    Semantic validation errors raised by ``from_dict`` itself (an unknown
    event kind, a factor < 1) propagate unchanged — they already carry
    the loud, specific message.
    """
    env = env if env is not None else os.environ
    path = env.get(env_var, "").strip()
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{env_var}={path!r}: no such {kind} artifact"
        )
    expected = (
        f" (expected world={world})" if world is not None else ""
    )
    try:
        with open(path) as f:
            obj = json.load(f)
        artifact = from_dict(obj)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{env_var}={path!r} is not a {kind} JSON artifact: invalid "
            f"JSON — {e}{expected}"
        ) from e
    except KeyError as e:
        # name the offending field, not just the exception repr: the
        # author of a hand-edited artifact needs to know WHICH key the
        # schema wants (the generic message was the bug this fixes)
        raise ValueError(
            f"{env_var}={path!r} is not a {kind} JSON artifact: missing "
            f"required field {e.args[0]!r}{expected}"
        ) from e
    except TypeError as e:
        raise ValueError(
            f"{env_var}={path!r} is not a {kind} JSON artifact: "
            f"malformed field — {e}{expected}"
        ) from e
    if world is not None and artifact.world != world:
        raise ValueError(
            f"{env_var}={path!r} was authored for world={artifact.world} "
            f"but this run has world={world}; re-author the {kind} — "
            f"{mismatch_hint}"
        )
    return artifact
