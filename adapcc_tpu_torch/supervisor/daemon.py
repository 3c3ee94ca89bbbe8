"""The autonomous supervisor: out-of-band detect → decide → swap.

The port of :mod:`adapcc_tpu.supervisor.daemon`.  The elastic failover
could close its loop from inside the training loop (the trainer polls the
worldview and activates standby plans between its own steps); this daemon
moves that authority out of band, the shape production collective stacks
use (The Big Send-off, PAPERS.md): a
:class:`Supervisor` owns the loop, training processes only observe epoch
bumps (and retry ``EpochMismatch`` exactly as they already do).

Two detection funnels feed the same
:meth:`~adapcc_tpu_torch.coordinator.logic.CoordinatorLogic.worldview`:

- **real cross-process silence** — ranks lease liveness through the
  coordinator's heartbeat RPC; the supervisor sweeps the per-rank
  :class:`~adapcc_tpu_torch.supervisor.liveness.LivenessTable` (healthy →
  suspected → dead with a grace window) and journals confirmed deaths;
- **injected fault plans** — ``ADAPCC_FAULT_PLAN`` events folded at the
  supervisor's own cadence (the CPU-testable twin), including ``slow``
  events, which the chaos harness also spells as a real SIGSTOP
  duty-cycle (:mod:`adapcc_tpu_torch.supervisor.chaos`).

Every decision is journaled to a fsync'd write-ahead log *before*
actuation (:mod:`adapcc_tpu_torch.supervisor.journal`), so a supervisor restart
replays to an identical WorldView with zero duplicate epoch bumps — the
supervisor itself is not a new single point of hang.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from adapcc_tpu_torch.elastic.worldview import WorldView, slow_ranks_from_medians
from adapcc_tpu_torch.supervisor.journal import DecisionJournal
from adapcc_tpu_torch.supervisor.liveness import (
    DEAD,
    HEALTHY,
    SUSPECTED,
    LivenessConfig,
    LivenessTable,
)

#: workload gate: ``on`` arms supervision from the
#: environment (the battery spelling); anything else but ``off``/unset is
#: a loud error
SUPERVISOR_ENV = "ADAPCC_SUPERVISOR"

#: consecutive poll failures before the daemon thread gives up loudly (a
#: supervisor spinning on a poisoned poll is as useless as a hung one)
MAX_CONSECUTIVE_ERRORS = 5


def supervisor_enabled(explicit: bool = False) -> bool:
    """The ``ADAPCC_SUPERVISOR`` funnel: env > explicit flag > off;
    malformed → loud (the ADAPCC_MERGE_ROUNDS policy)."""
    raw = os.environ.get(SUPERVISOR_ENV, "").strip().lower()
    if not raw:
        return bool(explicit)
    if raw in ("on", "1", "true"):
        return True
    if raw in ("off", "0", "false"):
        return False
    raise ValueError(f"{SUPERVISOR_ENV}={raw!r}: expected on|off")


class Supervisor:
    """One world's autonomous failure-handling authority (module doc).

    Wiring::

        logic = CoordinatorLogic(world)            # heartbeat funnel
        cache = StandbyPlanCache(engine); cache.build(); cache.warm(...)
        sup = Supervisor(logic, engine, cache=cache, trainer=trainer,
                         journal_path="topology/supervisor.journal")
        sup.start(period_s=0.25)                   # the daemon thread
        ...
        mask = sup.current_mask()                  # what trainers consume
        sup.stop()

    ``poll()`` is one deterministic pass (tests drive it with injected
    clocks); ``start`` runs it on a timer.  All decisions are
    write-ahead journaled; ``Supervisor(..., resume=True)`` (the default)
    replays an existing journal before doing anything else.
    """

    def __init__(
        self,
        logic,
        engine=None,
        cache=None,
        trainer=None,
        journal_path: Optional[str] = None,
        config: Optional[LivenessConfig] = None,
        metrics=None,
        adapt=None,
        adapt_every: int = 0,
        fault_plan=None,
        step_source: Optional[Callable[[], int]] = None,
        on_world_change: Optional[Callable[[WorldView, WorldView], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        resume: bool = True,
    ) -> None:
        if cache is not None and engine is None:
            engine = cache.engine
        if fault_plan is not None:
            if step_source is None:
                raise ValueError(
                    "a fault plan needs step_source (the plan's events are "
                    "keyed by training step; the supervisor cannot fold "
                    "them without knowing where the run is)"
                )
            if fault_plan.world != logic.world_size:
                raise ValueError(
                    f"fault plan world {fault_plan.world} != coordinator "
                    f"world {logic.world_size}"
                )
        if adapt_every < 0:
            raise ValueError(f"adapt_every must be >= 0, got {adapt_every}")
        self.logic = logic
        self.engine = engine
        self.cache = cache
        self.trainer = trainer
        self.metrics = metrics
        self.adapt = adapt
        self.adapt_every = int(adapt_every)
        self.fault_plan = fault_plan
        self.step_source = step_source
        self.on_world_change = on_world_change
        self.clock = clock
        self.config = (
            config if config is not None else LivenessConfig.from_env()
        )
        now = clock()
        self.table = LivenessTable(logic.world_size, self.config, now=now)
        self.journal = (
            DecisionJournal(journal_path) if journal_path else None
        )
        #: the view whose actuation last completed — what trainers see
        self._applied_view: WorldView = logic.worldview()
        #: epoch token for engine dispatches planned against this view
        self.engine_epoch: int = engine.epoch if engine is not None else 0
        #: ranks the fault plan currently marks down / slow (feed B state)
        self._plan_dead: frozenset = frozenset()
        self._plan_slow: frozenset = frozenset()
        self._beats_seen: Dict[int, int] = {}
        self.decisions = 0
        self.polls = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.RLock()
        if resume and self.journal is not None:
            self._resume()

    # -- journal helpers -------------------------------------------------------

    def _journal(self, kind: str, **payload):
        self.decisions += 1
        if self.metrics is not None:
            self.metrics.incr("supervisor/decisions")
            self.metrics.incr(f"supervisor/decisions/{kind}")
        if self.journal is not None:
            return self.journal.append(kind, **payload)
        return None

    def _view_payload(self, wv: WorldView) -> dict:
        return {
            "alive": sorted(wv.alive),
            "relays": sorted(wv.relays),
            "wv_epoch": wv.epoch,
        }

    # -- resume ----------------------------------------------------------------

    def _resume(self) -> None:
        """Replay the journal: restore the applied view and complete any
        decision that was journaled but whose actuation never confirmed.
        Confirmed decisions are NEVER re-actuated — the zero-duplicate-
        epoch-bump property the restart drill pins."""
        state = self.journal.replay()
        if state.last_view is not None:
            replayed = WorldView(
                world_size=self.logic.world_size,
                alive=frozenset(state.last_view["alive"]),
                relays=frozenset(state.last_view["relays"]),
                epoch=int(state.last_view["wv_epoch"]),
            )
            live = self.logic.worldview()
            # never regress a live coordinator that moved past the journal
            # while the supervisor was down; a fresh (or lagging) logic is
            # brought up to the journaled picture
            if replayed.epoch >= live.epoch:
                self._applied_view = self.logic.restore_worldview(
                    replayed.alive, replayed.relays, replayed.epoch
                )
            else:
                self._applied_view = live
        for d in state.decisions:
            if d.kind == "swap" and "engine_epoch" in d.payload:
                self.engine_epoch = max(
                    self.engine_epoch, int(d.payload["engine_epoch"])
                )
            if d.kind in ("admit", "recover") and "gen" in d.payload:
                # re-seed the admit counter: a fresh logic starts at 0,
                # and without this a post-restart rejoin would reuse a
                # journaled generation's rendezvous namespace (and read
                # the earlier rejoin's stale keys as its own).  Both the
                # heartbeat admit and the fault-plan recover bump it;
                # recover records of older journals carry no gen and are
                # skipped
                if hasattr(self.logic, "seed_restart_generation"):
                    self.logic.seed_restart_generation(int(d.payload["gen"]))
        # the fresh liveness table must agree with the replayed view: a
        # journald death stays DEAD (no duplicate suspicion walk, no
        # duplicate dead decision), and beats that PREDATE the restart are
        # history, not new evidence of life — only a post-restart beat
        # (fresh count) may flip a dead rank back to healthy
        for rank in sorted(self._applied_view.dead):
            if rank in self.table.ranks:
                self.table.ranks[rank].state = DEAD
        if hasattr(self.logic, "heartbeat_snapshot"):
            self._beats_seen = {
                r: rec["beats"]
                for r, rec in self.logic.heartbeat_snapshot().items()
            }
        for d in state.unapplied:
            # the crash window: journaled, died before the actuation
            # confirmed — complete it exactly once
            self._actuate(self._applied_view, seq=d.seq)

    def reconcile(self) -> None:
        """Re-actuate the (replayed) applied view against a freshly built
        engine — the cold-restart bootstrap for a supervisor process that
        came back with a new engine/cache (the in-process restart path
        never needs this: the engine kept its swapped strategy)."""
        if not self._applied_view.degraded:
            return
        d = self._journal("restore", **self._view_payload(self._applied_view))
        self._actuate(self._applied_view, seq=d.seq if d else None)

    # -- actuation -------------------------------------------------------------

    def _actuate(self, wv: WorldView, seq: Optional[int] = None) -> None:
        """Drive the data plane onto ``wv``: standby-cache swap (dead
        ranks) or base-plan restore (recovery / relay-only change), the
        trainer's program adoption, and the world-change callback.  The
        journal confirmation marker lands only after everything ran."""
        if self.cache is not None:
            if wv.dead:
                plan, self.engine_epoch = self.cache.activate(wv.alive)
                strategy = plan.strategy
                swap_payload = {
                    "label": plan.label,
                    "fingerprint": strategy.fingerprint(),
                    "warmed": plan.warmed,
                    "engine_epoch": self.engine_epoch,
                }
            else:
                # recovery or relay-only demotion: the base plan's compiled
                # programs never left the cache — relay masks are runtime
                # state, so no re-emitted strategy is needed
                self.engine_epoch = self.cache.restore_full()
                strategy = self.cache.base_strategy
                swap_payload = {
                    "label": "base",
                    "fingerprint": strategy.fingerprint(),
                    "warmed": True,
                    "engine_epoch": self.engine_epoch,
                }
            self._journal("swap", **swap_payload)
            if self.trainer is not None:
                self.trainer.adopt_strategy(strategy)
        elif self.engine is not None:
            self.engine_epoch = self.engine.advance_epoch()
        if self.on_world_change is not None:
            self.on_world_change(self._applied_view, wv)
        if (
            self.engine is not None
            and getattr(self.engine, "trace", None) is not None
        ):
            # satellite: the liveness table rides the dispatch trace on
            # every epoch bump, so a trace dump answers "what did the
            # supervisor believe when it swapped"
            self.engine.trace.record(
                "supervisor",
                "epoch_bump",
                0,
                epoch=self.engine_epoch,
                seq=seq,
                liveness=self.table.rows(self.clock()),
                **self._view_payload(wv),
            )
        self._applied_view = wv
        if self.metrics is not None:
            self.metrics.gauge("supervisor/wv_epoch", wv.epoch)
            self.metrics.gauge("supervisor/engine_epoch", self.engine_epoch)
        if seq is not None and self.journal is not None:
            self.journal.mark_applied(seq)

    # -- the loop --------------------------------------------------------------

    def _feed_heartbeats(self, now: float) -> List[tuple]:
        """Feed A: consume new beats from the coordinator's heartbeat
        funnel into the liveness table, then sweep silence into
        transitions.

        The sweep is gated on a lease actually existing: until the FIRST
        beat ever arrives, no rank has taken a liveness lease and silence
        is not evidence — a deployment that never wires heartbeats (the
        fault-plan-only workload spelling) must not watch its whole world
        age past the confirm window and declare everyone dead.  Once any
        rank leases, a rank that never did is detected exactly like one
        that stopped (the died-during-launch case)."""
        transitions: List[tuple] = []
        snapshot = (
            self.logic.heartbeat_snapshot()
            if hasattr(self.logic, "heartbeat_snapshot")
            else {}
        )
        for rank, rec in snapshot.items():
            if rec["beats"] > self._beats_seen.get(rank, 0):
                self._beats_seen[rank] = rec["beats"]
                t = self.table.beat(rank, rec["ts"], rec.get("median_s"))
                if t is not None:
                    transitions.append(t)
        if self._beats_seen:
            transitions.extend(self.table.sweep(now))
        return transitions

    def _feed_fault_plan(self, note) -> None:
        """Feed B: fold the injected plan's state at the current training
        step into the same decision stream real silence feeds."""
        state = self.fault_plan.state_at(int(self.step_source()))
        down, slow = state.down, frozenset(state.slow_map)
        for rank in sorted(down - self._plan_dead):
            note("dead", rank=rank, origin="plan")
            self.logic.mark_down([rank])
        recovered = self._plan_dead - down
        if recovered:
            # this path bumps the admit counter too (the ranks were DEAD),
            # so the journaled record must carry the generation — replay
            # re-seeds from it exactly like a heartbeat-path admit, or a
            # restarted supervisor would reissue this generation's
            # rendezvous namespace to the next rejoin
            gen = self.logic.mark_recovered(recovered)
            note("recover", ranks=sorted(recovered), origin="plan", gen=gen)
        self._plan_dead, self._plan_slow = down, slow

    def poll(self, now: Optional[float] = None) -> List[dict]:
        """One pass of the loop; returns the decisions taken (journaled
        order).  Deterministic given the heartbeat timestamps, the clock,
        and the step source."""
        with self._lock:
            return self._poll_locked(
                self.clock() if now is None else float(now)
            )

    def _poll_locked(self, now: float) -> List[dict]:
        self.polls += 1
        taken: List[dict] = []

        def note(kind: str, **payload):
            self._journal(kind, **payload)
            taken.append({"kind": kind, **payload})

        # -- detect ------------------------------------------------------------
        for rank, old, new in self._feed_heartbeats(now):
            if new == SUSPECTED:
                note("suspect", rank=rank, age_s=round(
                    now - self.table.ranks[rank].last_beat, 6))
            elif new == DEAD:
                note("dead", rank=rank, origin="heartbeat")
                self.logic.mark_down([rank])
            elif old == DEAD and new == HEALTHY:
                # a replacement (or restarted) worker leased in for a
                # DEAD rank — the rejoin protocol's admit decision
                # the journaled generation is the
                # rendezvous namespace the newcomer's catch-up restore
                # (restore_newest_across_processes(gen=)) keys by, and the
                # membership change actuates below as the grow-back epoch
                # (StandbyPlanCache.restore_full → warm base plan)
                gen = self.logic.mark_recovered([rank])
                note("admit", rank=rank, origin="heartbeat", gen=gen)
            elif old == SUSPECTED and new == HEALTHY:
                # the false-positive guard fired: a paused-then-resumed
                # rank inside the grace window was never demoted
                note("clear", rank=rank)
        if self.fault_plan is not None:
            self._feed_fault_plan(note)
        # -- demote (slow-rank rule over reported step medians) ---------------
        medians = self.table.medians()
        measured_slow = (
            slow_ranks_from_medians(medians, factor=self.logic.slow_factor)
            if len(medians) > 2
            else frozenset()
        )
        target_relays = (measured_slow | self._plan_slow) - self.logic.worldview().dead
        current_relays = self.logic.worldview().relays
        if target_relays != current_relays:
            demoted = sorted(target_relays - current_relays)
            promoted = sorted(current_relays - target_relays)
            if demoted:
                note("demote", ranks=demoted, medians={
                    str(r): round(medians[r], 6) for r in demoted
                    if r in medians
                })
            if promoted:
                note("promote", ranks=promoted)
            self.logic.set_relays(target_relays)
        # -- decide + swap -----------------------------------------------------
        wv = self.logic.worldview()
        if (wv.alive, wv.relays) != (
            self._applied_view.alive,
            self._applied_view.relays,
        ):
            d = self._journal("epoch", **self._view_payload(wv))
            taken.append({"kind": "epoch", **self._view_payload(wv)})
            self._actuate(wv, seq=d.seq if d is not None else None)
        # -- adapt (the adaptation loop, supervisor-owned) ---------------------
        if (
            self.adapt is not None
            and self.adapt_every
            and self.polls % self.adapt_every == 0
        ):
            rep = self.adapt.maybe_adapt()
            # steady states are not decisions: while a re-route is live
            # every pass reads "congestion-active"/"congestion-sustained",
            # and journaling each would fsync an append per poll for the
            # whole window without recording anything actionable — only
            # the transitions (reroute, cleared, swap, …) ride the WAL
            if rep.outcome not in (
                "off", "no-drift", "congestion-active",
                "congestion-sustained",
            ):
                # the triage verdict rides the journal: a later audit must
                # be able to tell a transient congestion re-route (model
                # untouched, restore pending) from a re-calibrated
                # degradation swap
                note(
                    "adapt",
                    outcome=rep.outcome,
                    triage=rep.triage,
                    winner=rep.winner_fingerprint,
                    engine_epoch=rep.epoch,
                )
                if rep.swapped and rep.epoch is not None:
                    self.engine_epoch = rep.epoch
        # -- observe -----------------------------------------------------------
        self.table.export_gauges(self.metrics, now)
        return taken

    # -- queries ---------------------------------------------------------------

    @property
    def applied_view(self) -> WorldView:
        return self._applied_view

    def worldview(self) -> WorldView:
        return self.logic.worldview()

    def current_mask(self) -> np.ndarray:
        """The ``[world]`` bool contribution mask of the last *actuated*
        view — what a training step consumes.  Trainers never see a
        decision before its swap completed (the actuation order is the
        WAL order)."""
        with self._lock:
            return self._applied_view.mask()

    # -- daemon thread ---------------------------------------------------------

    def start(self, period_s: float = 0.25) -> "Supervisor":
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("supervisor already running")
        self._stop.clear()

        def loop() -> None:
            errors = 0
            while not self._stop.wait(period_s):
                try:
                    self.poll()
                    errors = 0
                except Exception:  # noqa: BLE001 — the daemon must not die silently
                    errors += 1
                    print(
                        f"[adapcc] supervisor poll failed "
                        f"({errors}/{MAX_CONSECUTIVE_ERRORS}):\n"
                        f"{traceback.format_exc()}",
                        file=sys.stderr,
                        flush=True,
                    )
                    if self.metrics is not None:
                        self.metrics.incr("supervisor/errors")
                    if errors >= MAX_CONSECUTIVE_ERRORS:
                        print(
                            "[adapcc] supervisor giving up after "
                            f"{errors} consecutive failures",
                            file=sys.stderr,
                            flush=True,
                        )
                        return

        self._thread = threading.Thread(
            target=loop, name="adapcc-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self.journal is not None:
            self.journal.close()


__all__ = [
    "MAX_CONSECUTIVE_ERRORS",
    "SUPERVISOR_ENV",
    "Supervisor",
    "supervisor_enabled",
]
