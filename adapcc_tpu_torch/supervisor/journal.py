"""Crash-safe write-ahead decision journal for the supervisor daemon (the
port of :mod:`adapcc_tpu.supervisor.journal`: a journal written by either
package replays in the other to the same state).

The supervisor must not become a new single point of hang: every decision
it makes (suspicion, demotion, epoch bump, strategy swap, adaptation
outcome) is appended — serialized, flushed, **fsync'd** — *before* the
actuation runs.  A supervisor restart replays the journal and resumes
with an identical WorldView:

- records whose actuation was confirmed (a later ``applied`` marker
  referencing their ``seq``) fold into state only — they are never
  re-actuated, so a restart performs **zero duplicate epoch bumps**;
- a decision with no ``applied`` marker is exactly the crash window the
  write-ahead order creates (journaled, then died before or during
  actuation): replay surfaces it as *unapplied* and the daemon completes
  it once on resume.

The file is append-only JSONL.  A torn final line (the crash landed
mid-``write``) is detected and ignored on replay — by construction it can
only be the one record whose decision was not yet durable, so dropping it
is the correct recovery.  Anything else malformed raises loudly: a
corrupt journal must never silently replay into a wrong world picture.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

JOURNAL_VERSION = 1

#: decision kinds with side effects on the data plane: these are written
#: ahead of actuation and need an ``applied`` confirmation marker.  The
#: other kinds (suspicion, demotion, worker admission (``admit``, the
#: rejoin protocol), the ``swap`` record the
#: actuation itself emits, adaptation reports) are informational — replay
#: folds them but never re-runs anything for them.
ACTUATING_KINDS = ("epoch", "restore")


@dataclass(frozen=True)
class Decision:
    """One journaled record."""

    seq: int
    kind: str
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_line(self) -> str:
        rec = {"v": JOURNAL_VERSION, "seq": self.seq, "kind": self.kind}
        rec.update(self.payload)
        return json.dumps(rec, sort_keys=True)


@dataclass
class JournalState:
    """What a replay reconstructs."""

    decisions: List[Decision] = field(default_factory=list)
    applied: Set[int] = field(default_factory=set)
    next_seq: int = 0
    #: the last journaled world picture (an ``epoch``/``restore`` record's
    #: alive/relays/epoch payload), None when no membership decision was
    #: ever taken
    last_view: Optional[Dict[str, Any]] = None

    @property
    def unapplied(self) -> List[Decision]:
        """Actuating decisions whose confirmation marker never landed —
        the interrupted work a resuming supervisor completes exactly
        once."""
        return [
            d
            for d in self.decisions
            if d.kind in ACTUATING_KINDS and d.seq not in self.applied
        ]

    def epoch_bumps(self) -> List[Decision]:
        return [d for d in self.decisions if d.kind in ("epoch", "restore")]


class DecisionJournal:
    """Append-only fsync'd JSONL journal (module doc).

    ``append`` is the write-ahead barrier: it returns only after the
    record is durable (``flush`` + ``os.fsync``), so the actuation that
    follows can crash without losing the decision.  ``mark_applied``
    appends the confirmation marker with the same durability.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = None
        state, good_bytes = self._replay_with_offset()
        # repair the torn tail BEFORE the first append: the torn bytes
        # are by construction the one record that never became durable,
        # but left in place a post-resume append would merge into them —
        # and the merged line would either shadow a durable record on the
        # next replay or make the journal unreadable.  Truncating to the
        # last good record is the durable spelling of "that write never
        # happened".
        if os.path.exists(self.path) and good_bytes < os.path.getsize(
            self.path
        ):
            with open(self.path, "r+b") as f:
                f.truncate(good_bytes)
                f.flush()
                os.fsync(f.fileno())
        self._seq = state.next_seq

    def _handle(self):
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    # -- write-ahead append ----------------------------------------------------

    def append(self, kind: str, **payload: Any) -> Decision:
        """Durably journal one decision BEFORE its actuation; returns it
        (the ``seq`` is what :meth:`mark_applied` confirms later)."""
        if kind == "applied":
            raise ValueError(
                "'applied' is the confirmation marker; use mark_applied"
            )
        d = Decision(seq=self._seq, kind=kind, payload=dict(payload))
        self._seq += 1
        fh = self._handle()
        fh.write(d.to_line() + "\n")
        fh.flush()
        os.fsync(fh.fileno())
        return d

    def mark_applied(self, seq: int) -> None:
        """Durably confirm that decision ``seq``'s actuation completed —
        the marker replay uses to guarantee zero double-actuation."""
        fh = self._handle()
        fh.write(
            json.dumps(
                {"v": JOURNAL_VERSION, "seq": self._seq, "kind": "applied",
                 "ref": int(seq)},
                sort_keys=True,
            )
            + "\n"
        )
        self._seq += 1
        fh.flush()
        os.fsync(fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- replay ----------------------------------------------------------------

    def replay(self) -> JournalState:
        """Fold the journal back into a :class:`JournalState`.

        Tolerates exactly one torn record, and only at the tail (the
        crash-mid-write window); any other malformed or out-of-order line
        raises — silent tolerance there would replay a wrong world."""
        return self._replay_with_offset()[0]

    def _replay_with_offset(self) -> "tuple[JournalState, int]":
        """:meth:`replay`, additionally returning the byte offset of the
        end of the last GOOD record — the truncation point the
        constructor's torn-tail repair uses."""
        state = JournalState()
        if not os.path.exists(self.path):
            return state, 0
        with open(self.path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # drop the trailing empty slice of a newline-terminated file
        if lines and lines[-1] == "":
            lines.pop()
        good_bytes = 0
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if i == len(lines) - 1:
                    break  # torn tail: the one legal kind of damage
                raise ValueError(
                    f"{self.path}:{i + 1}: corrupt journal record "
                    f"(not the torn tail): {line!r}"
                ) from e
            if rec.get("v") != JOURNAL_VERSION:
                raise ValueError(
                    f"{self.path}:{i + 1}: journal version "
                    f"{rec.get('v')!r} != {JOURNAL_VERSION}"
                )
            seq, kind = int(rec["seq"]), str(rec["kind"])
            if seq != state.next_seq:
                raise ValueError(
                    f"{self.path}:{i + 1}: seq {seq} breaks the monotone "
                    f"chain (expected {state.next_seq}) — the journal was "
                    "edited or interleaved"
                )
            state.next_seq = seq + 1
            good_bytes += len(line.encode("utf-8")) + 1  # + the newline
            if kind == "applied":
                state.applied.add(int(rec["ref"]))
                continue
            payload = {
                k: v for k, v in rec.items() if k not in ("v", "seq", "kind")
            }
            d = Decision(seq=seq, kind=kind, payload=payload)
            state.decisions.append(d)
            if kind in ("epoch", "restore"):
                state.last_view = payload
        return state, good_bytes


__all__ = [
    "ACTUATING_KINDS",
    "Decision",
    "DecisionJournal",
    "JOURNAL_VERSION",
    "JournalState",
]
