"""Relay/fault decision logic (transport-free).

Implements the two decisions of the reference coordinator
(proto/rpc_server.py:48-108) as a plain thread-safe object:

- **hook phase** (``hook_arrive``): the first rank to finish its backward
  pass for a step becomes the *leader* and runs a rent-or-buy (ski-rental)
  wait: each 5 ms time slot spent waiting for more ranks accrues "rent";
  committing to a partial collective with the ``m`` ranks present costs
  "buy" = the m-rank collective scaled by ``((m-1)/m) / ((n-1)/n)`` plus the
  deferred full-world cost.  The leader stops waiting when renting longer
  than buying, when the hard relay threshold (0.1 s) is exceeded, or when
  everyone arrived — then freezes the step's **active list**
  (rpc_server.py:69-96).  Ranks arriving before the freeze join it; ranks
  arriving after are relays and just learn the frozen list.

- **controller phase** (``controller_arrive``): a per-step heartbeat
  barrier.  If not all ranks report within the fault timeout (10 s), the
  caller gets the list of ranks that *did* report with ``status=0`` — the
  alive set the collectives continue with instead of hanging
  (rpc_server.py:48-62, README "fault tolerance").

The reference implements both with spin-polling and queues; this uses one
condition variable so waits wake on arrival instead of on a poll tick.

A whole copy of :mod:`adapcc_tpu.coordinator.logic` (importing the reference
module would load JAX through its package).  ``fault_plan`` is duck-typed:
any object whose ``state_at(step)`` returns a state with ``down`` and
``slow_map``, as :class:`adapcc_tpu_torch.elastic.FaultPlan`'s does.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple

from adapcc_tpu_torch.primitives import (
    FAULT_TOLERANT_TIME_S,
    RELAY_THRESHOLD_S,
    TIME_SLOT_DURATION_S,
)


class CoordinatorShutdown(RuntimeError):
    """The coordinator is stopping: blocked waiters are drained with this
    instead of being left parked on the condition variable forever.  The
    gRPC layer turns it into an UNAVAILABLE abort, so a worker blocked on
    ``send_ready_request`` unblocks with a clean error when the
    coordinator dies (instead of hanging past the server's teardown)."""


class CoordinatorLogic:
    def __init__(
        self,
        world_size: int,
        relay_threshold: float = RELAY_THRESHOLD_S,
        time_slot: float = TIME_SLOT_DURATION_S,
        fault_timeout: float = FAULT_TOLERANT_TIME_S,
        accumulated_size: float = 100 * 8 / 1024,
        accumulated_bandwidth: Optional[float] = None,
        fault_plan: Optional[object] = None,
        heartbeat_timeout: Optional[float] = None,
        slow_factor: Optional[float] = None,
    ) -> None:
        from adapcc_tpu_torch.elastic.worldview import (
            WorldView,
            heartbeat_timeout_s,
            slow_rank_factor,
        )

        self.world_size = world_size
        self.relay_threshold = relay_threshold
        self.time_slot = time_slot
        self.fault_timeout = fault_timeout
        #: heartbeat deadline for the controller barrier; defaults to the
        #: fault timeout, overridable per-deploy via
        #: ``ADAPCC_HEARTBEAT_TIMEOUT_S`` (docs/ELASTIC.md)
        self.heartbeat_timeout = heartbeat_timeout_s(
            heartbeat_timeout if heartbeat_timeout is not None else fault_timeout
        )
        #: slow-rank demotion threshold for :meth:`observe_step_medians`
        #: (``ADAPCC_SLOW_RANK_FACTOR`` overrides)
        self.slow_factor = slow_rank_factor(
            slow_factor if slow_factor is not None else 2.0
        )
        #: deterministic fault injection (the JAX package's elastic.faults): down
        #: ranks' arrivals are dropped at this funnel and the barriers'
        #: expected counts shrink, so every failover path is exercisable on
        #: CPU with no hardware and no wall-clock timeout
        self.fault_plan = fault_plan
        # cost-model constants mirroring the reference's defaults
        # (rpc_server.py:41-46): a nominal accumulated gradient size and an
        # aggregate bandwidth proportional to the world size
        self.accumulated_size = accumulated_size
        self.accumulated_bandwidth = (
            accumulated_bandwidth if accumulated_bandwidth is not None else 50.0 * world_size
        )

        self._cond = threading.Condition()
        self._ready: Dict[int, List[int]] = defaultdict(list)
        self._frozen: Dict[int, List[int]] = {}
        self._heartbeats: Dict[int, List[int]] = defaultdict(list)
        # liveness-lease funnel (docs/SUPERVISOR.md): per-rank beat count,
        # last-beat monotonic timestamp, and the rank's self-reported
        # recent step walltime — the raw inputs the supervisor's liveness
        # state machine and slow-rank rule run over
        self._beat_counts: Dict[int, int] = {}
        self._beat_times: Dict[int, float] = {}
        self._beat_medians: Dict[int, float] = {}
        self._shutdown = False
        self._worldview = WorldView.full(world_size)
        # rejoin bookkeeping (docs/RECOVERY.md §3): bumped whenever a
        # previously-DEAD rank is re-admitted, so a replacement worker's
        # rendezvous (restore_newest_across_processes) keys its KV
        # namespace by the admit generation and never reads the keys of
        # the world that died
        self._restart_gen = 0
        # plan-fold bookkeeping: the newest step whose fault state has been
        # applied (late arrivals for older steps must not regress the view)
        # and the relay set the PLAN installed (so plan updates never
        # clobber relays the slow-rank rule demoted independently)
        self._plan_step = -1
        self._plan_relays: frozenset = frozenset()

    def calibrate(self, total_grad_bytes: float, link_bandwidth_gbps: float) -> None:
        """Replace the reference's hardcoded cost constants
        (rpc_server.py:41-46) with measured quantities: the gradient volume a
        step actually allreduces and the profiled per-link bandwidth.

        Sets the units so ``_initial_rent_cost()`` equals the ring-allreduce
        estimate ``2(n-1)/n · bytes / bw`` in SECONDS — the same clock the
        leader's wall-time rent accrues on, so the rent-or-buy comparison
        becomes dimensionally honest instead of heuristically scaled.
        Thread-safe; takes effect for the next freeze decision.
        """
        if total_grad_bytes <= 0 or link_bandwidth_gbps <= 0:
            raise ValueError(
                f"calibrate needs positive bytes/bandwidth, got "
                f"{total_grad_bytes}/{link_bandwidth_gbps}"
            )
        with self._cond:
            self.accumulated_size = total_grad_bytes / 1e9  # GB
            self.accumulated_bandwidth = self.world_size * link_bandwidth_gbps

    # -- hook phase ------------------------------------------------------------

    def _initial_rent_cost(self) -> float:
        n = self.world_size
        return 2 * (n - 1) * self.accumulated_size / self.accumulated_bandwidth

    def _buy_cost(self, num_ready: int) -> float:
        n, m = self.world_size, num_ready
        ratio = ((m - 1) / m) / ((n - 1) / n)
        return self._initial_rent_cost() * ratio + n * self.accumulated_size / self.accumulated_bandwidth

    def _check_shutdown_locked(self) -> None:
        if self._shutdown:
            raise CoordinatorShutdown("coordinator stopped")

    def _plan_down_locked(self, step: int) -> frozenset:
        """Injected-dead ranks at ``step`` (empty without a fault plan).
        Folding the plan into the world picture happens here — the single
        funnel every arrival passes through — so detection is deterministic
        and the WorldView epoch advances exactly when membership changes.

        The fold is MONOTONE in step: a relay worker landing its arrival
        for an older step (the rent-or-buy design explicitly allows that)
        replays that step's barrier but must not regress the world picture
        to the older fault state.  Plan-installed relays are tracked
        separately so applying the plan never clobbers demotions the
        slow-rank rule (:meth:`observe_step_medians`) installed on its own.
        """
        if self.fault_plan is None:
            return frozenset()
        state = self.fault_plan.state_at(step)
        if step >= self._plan_step:
            self._plan_step = step
            plan_slow = frozenset(state.slow_map)
            kept = (self._worldview.relays - self._plan_relays) | plan_slow
            self._plan_relays = plan_slow
            self._worldview = self._worldview.with_alive(
                frozenset(range(self.world_size)) - state.down
            ).with_relays(kept)
        return state.down

    def hook_arrive(self, step: int, rank: int) -> List[int]:
        """Register ``rank`` as ready for ``step``; block until the active
        list is frozen; return it.  Thread-safe, reentrant across steps.

        With a fault plan attached, a rank the plan marks down at this step
        is dropped at the funnel: its arrival never joins the ready list
        (the injected analog of the dead worker whose RPC never lands) and
        it learns the frozen list like a late relay.  The freeze barrier
        shrinks to the injected-alive count so the decision is reached
        deterministically, with no wall-clock timeout in the loop.
        """
        with self._cond:
            self._check_shutdown_locked()
            down = self._plan_down_locked(step)
            expected = self.world_size - len(down)
            if rank in down:
                # injected-dead: the arrival is dropped; wait out the freeze
                # like a relay so the caller still unblocks deterministically
                while step not in self._frozen:
                    self._check_shutdown_locked()
                    self._cond.wait(timeout=self.time_slot)
                return list(self._frozen[step])
            if step in self._frozen:
                # relay worker: the train has left, learn who's on it
                return list(self._frozen[step])

            if rank not in self._ready[step]:
                # idempotent arrival: the client retries a transport-level
                # UNAVAILABLE (service.py _call_with_deadline), and gRPC can
                # surface that AFTER the server processed the call (response
                # lost to a reset) — a duplicate must not inflate the barrier
                # count and freeze the step with a live rank missing
                self._ready[step].append(rank)
            self._cond.notify_all()

            if len(self._ready[step]) > 1:
                # active waiting worker: sleep until the leader freezes
                while step not in self._frozen:
                    self._check_shutdown_locked()
                    self._cond.wait(timeout=self.time_slot)
                return list(self._frozen[step])

            # leader: rent-or-buy wait loop.  Unlike the reference
            # (rpc_server.py:69-96, which can wait forever when no peer ever
            # arrives), a sole leader escapes after the fault timeout and
            # freezes its singleton list — dead peers are the controller
            # phase's problem, not a reason to hang the hook phase.  Rent is
            # wall time actually waited (a condition variable wakes early on
            # any notify — heartbeats, other steps' arrivals — so counting a
            # full slot per wakeup would inflate rent arbitrarily).
            # snapshot the cost constants once: calibrate() may retune them
            # mid-wait (trainer's first step races the same step's freeze),
            # and one decision must not mix two scales — the new constants
            # take effect at the NEXT step's freeze
            size, bandwidth = self.accumulated_size, self.accumulated_bandwidth
            n = self.world_size
            initial_rent = 2 * (n - 1) * size / bandwidth

            def buy_cost(m: int) -> float:
                ratio = ((m - 1) / m) / ((n - 1) / n)
                return initial_rent * ratio + n * size / bandwidth

            t0 = time.monotonic()
            while True:
                self._check_shutdown_locked()
                accumulated_rent = time.monotonic() - t0
                num_ready = len(self._ready[step])
                # the freeze barrier is the *injected-alive* count: a plan's
                # dead ranks can never arrive, so waiting for the full world
                # would always ride the rent clock to the relay threshold
                if num_ready == expected:
                    break
                if num_ready > 1:
                    if (
                        accumulated_rent + initial_rent >= buy_cost(num_ready)
                        or accumulated_rent > self.relay_threshold
                    ):
                        break
                elif accumulated_rent > self.fault_timeout:
                    break
                self._cond.wait(timeout=self.time_slot)

            self._frozen[step] = list(self._ready[step])
            self._cond.notify_all()
            return list(self._frozen[step])

    # -- controller phase ------------------------------------------------------

    def controller_arrive(self, step: int, rank: int) -> Tuple[List[int], int]:
        """Heartbeat for ``step``; block until all ranks heartbeat (then
        return the frozen active list, status 1) or the heartbeat timeout
        expires (then return the alive list, status 0).

        With a fault plan, injected-dead ranks never count toward the
        barrier and their own heartbeats are dropped, so the alive subset
        surfaces with status 0 *deterministically* — the CPU-testable twin
        of the wall-clock timeout path.  Either status-0 exit also records
        the detection in the :class:`WorldView` (alive set shrunk, epoch
        bumped), which is what downstream plan failover keys on.
        """
        with self._cond:
            self._check_shutdown_locked()
            down = self._plan_down_locked(step)
            if rank in down:
                # injected-dead rank: its heartbeat is dropped at the funnel;
                # it learns the alive picture like everyone else
                return sorted(set(range(self.world_size)) - down), 0
            if rank not in self._heartbeats[step]:
                # idempotent like hook_arrive: a retried arrival whose first
                # attempt's response was lost must not count twice toward
                # the barrier
                self._heartbeats[step].append(rank)
            self._cond.notify_all()

            expected = self.world_size - len(down)
            deadline = time.monotonic() + self.heartbeat_timeout
            while len(self._heartbeats[step]) < expected:
                self._check_shutdown_locked()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    alive = list(self._heartbeats[step])
                    self._worldview = self._worldview.with_alive(alive)
                    return alive, 0
                self._cond.wait(timeout=remaining)

            if down:
                # every injected-alive rank reported; surface the alive
                # subset with status 0 without waiting out any clock
                alive = sorted(self._heartbeats[step])
                self._worldview = self._worldview.with_alive(alive)
                return alive, 0

            # everyone is alive; hand out the hook phase's decision
            while step not in self._frozen:
                self._check_shutdown_locked()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    alive = list(self._heartbeats[step])
                    self._worldview = self._worldview.with_alive(alive)
                    return alive, 0
                self._cond.wait(timeout=remaining)
            # bounded history (the reference preallocates 1M steps instead,
            # rpc_server.py:29-34); participants are never 1000 steps apart
            if step % 100 == 0:
                self._forget_locked(step - 1000)
            return list(self._frozen[step]), 1

    # -- world view / elastic surface ------------------------------------------

    def worldview(self):
        """The coordinator's current :class:`~adapcc_tpu_torch.elastic.worldview.
        WorldView` — alive set, relay set, epoch counter — the explicit
        output plan failover consumes (a bare active list cannot say
        *why* a rank is absent or whether anything changed)."""
        with self._cond:
            return self._worldview

    def observe_step_medians(self, medians: Mapping[int, float]):
        """Feed per-rank step medians (the DispatchTimer data already
        flowing through the tuner) into the slow-rank rule: ranks slower
        than ``slow_factor ×`` their peers' median are demoted to
        forwarding relays; ranks that caught back up are promoted.
        Returns the (possibly epoch-bumped) WorldView."""
        from adapcc_tpu_torch.elastic.worldview import slow_ranks_from_medians

        slow = slow_ranks_from_medians(medians, factor=self.slow_factor)
        with self._cond:
            self._worldview = self._worldview.with_relays(slow)
            return self._worldview

    def heartbeat_arrive(
        self,
        rank: int,
        median_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Tuple[List[int], int]:
        """The liveness-lease funnel (docs/SUPERVISOR.md): record that
        ``rank`` is alive *now* (and, optionally, its recent step
        walltime — the slow-rank rule's evidence, reported by the
        straggling process itself).  Returns ``(alive_list, epoch)`` so
        the beating process observes membership changes passively.

        Unlike the per-step barriers above, heartbeats never block: the
        call is a timestamp write plus a worldview read.  Detection —
        deciding that silence means death — is the supervisor's job
        (:mod:`adapcc_tpu.supervisor.liveness`), not this funnel's; both
        this funnel and the fault-plan injection feed the same
        :meth:`worldview`.
        """
        if not 0 <= rank < self.world_size:
            raise ValueError(
                f"rank {rank} outside world [0, {self.world_size})"
            )
        with self._cond:
            self._check_shutdown_locked()
            self._beat_counts[rank] = self._beat_counts.get(rank, 0) + 1
            self._beat_times[rank] = (
                time.monotonic() if now is None else float(now)
            )
            if median_s is not None and median_s > 0:
                self._beat_medians[rank] = float(median_s)
            wv = self._worldview
            return sorted(wv.alive), wv.epoch

    def heartbeat_snapshot(self) -> Dict[int, dict]:
        """Per-rank beat bookkeeping for the supervisor's sweep:
        ``{rank: {"beats", "ts", "median_s"}}`` — only ranks that ever
        beat appear (a rank silent since boot is the liveness table's
        initial-lease case, not this snapshot's)."""
        with self._cond:
            return {
                r: {
                    "beats": self._beat_counts[r],
                    "ts": self._beat_times[r],
                    "median_s": self._beat_medians.get(r),
                }
                for r in self._beat_counts
            }

    def mark_down(self, ranks) -> None:
        with self._cond:
            self._worldview = self._worldview.with_down(ranks)

    def mark_recovered(self, ranks) -> int:
        """Re-admit ``ranks``; returns the (possibly bumped) restart
        generation — bumped only when a genuinely DEAD rank came back, so
        a relay promotion never invalidates rendezvous keys.  The
        supervisor journals this generation in its ``admit`` decision and
        the replacement worker passes it to
        :func:`adapcc_tpu.checkpoint.restore_newest_across_processes`
        (``gen=``) for its catch-up restore."""
        with self._cond:
            was_dead = frozenset(int(r) for r in ranks) & self._worldview.dead
            self._worldview = self._worldview.with_recovered(ranks)
            if was_dead:
                self._restart_gen += 1
            return self._restart_gen

    @property
    def restart_generation(self) -> int:
        with self._cond:
            return self._restart_gen

    def seed_restart_generation(self, gen: int) -> None:
        """Fast-forward the admit counter to at least ``gen`` — the
        supervisor's journal replay calls this with the highest journaled
        ``admit`` generation, so a restarted supervisor can never hand a
        new rejoin a generation (and thus a rendezvous namespace) an
        earlier rejoin already used."""
        with self._cond:
            self._restart_gen = max(self._restart_gen, int(gen))

    def set_relays(self, ranks) -> None:
        """Replace the relay set wholesale — the supervisor's demotion
        actuator, merging its two slow-rank evidence streams (reported
        step medians, injected ``slow`` events) into one target."""
        with self._cond:
            self._worldview = self._worldview.with_relays(ranks)

    def restore_worldview(self, alive, relays, epoch: int):
        """Impose a journald world picture (supervisor restart replay,
        docs/SUPERVISOR.md §4).  Refuses to regress: a live view that
        moved past the journal's epoch while the supervisor was down
        stays — replay must reconstruct history, never rewrite it."""
        from adapcc_tpu_torch.elastic.worldview import WorldView

        with self._cond:
            if int(epoch) >= self._worldview.epoch:
                self._worldview = WorldView(
                    world_size=self.world_size,
                    alive=frozenset(int(r) for r in alive),
                    relays=frozenset(int(r) for r in relays),
                    epoch=int(epoch),
                )
            return self._worldview

    def shutdown(self) -> None:
        """Drain every blocked waiter with :class:`CoordinatorShutdown`
        (the explicit sentinel ``CoordinatorServer.stop`` fires before
        tearing the gRPC server down)."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    # -- introspection / GC ----------------------------------------------------

    def active_list(self, step: int) -> Optional[List[int]]:
        with self._cond:
            frozen = self._frozen.get(step)
            return list(frozen) if frozen is not None else None

    def forget_steps_before(self, step: int) -> None:
        """Drop per-step state older than ``step`` (the reference
        preallocates a dict of 1M steps instead, rpc_server.py:29-34)."""
        with self._cond:
            self._forget_locked(step)

    def _forget_locked(self, step: int) -> None:
        for d in (self._ready, self._frozen, self._heartbeats):
            for s in [s for s in d if s < step]:
                del d[s]
