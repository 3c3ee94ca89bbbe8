"""Per-step worker-skew (straggler) measurement.

The reference instruments its DDP hook with gRPC timestamps and reports, per
step, how long the fastest worker waits for the slowest (max−min arrival),
optionally scaling one rank's compute by ``heter_alpha`` to emulate
heterogeneity (units-test/get_wait_time.py:29-62,96-140; results
wait_time_{homo,heter}_bc128.csv).

Here the probe wraps :class:`~adapcc_tpu_torch.coordinator.logic.CoordinatorLogic`:
every ``hook_arrive`` stamps a host clock per (step, rank), and skew is
computed from those stamps — the same measurement point as the reference
(the moment a worker's backward pass finishes and it reports ready).

A copy of :mod:`adapcc_tpu.measure.wait_time` (importing the reference module
would load JAX through its package).
"""

from __future__ import annotations

import csv
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from adapcc_tpu_torch.coordinator.logic import CoordinatorLogic


class WaitTimeProbe:
    """Records hook-arrival timestamps and derives per-step skew.

    Use as a shim in front of the coordinator: call :meth:`hook_arrive`
    wherever the training loop would call the coordinator's, or call
    :meth:`stamp` directly from a custom hook.
    """

    def __init__(self, logic: Optional[CoordinatorLogic] = None) -> None:
        self.logic = logic
        self._lock = threading.Lock()
        self._stamps: Dict[int, Dict[int, float]] = defaultdict(dict)
        # negotiate() round-trip per (step, rank): the coordinator-overhead
        # component the reference logs to proto/latency_0.0.txt, distinct
        # from worker skew
        self._rpc: Dict[int, Dict[int, float]] = defaultdict(dict)

    def stamp(self, step: int, rank: int, t: Optional[float] = None) -> None:
        with self._lock:
            self._stamps[step][rank] = time.monotonic() if t is None else t

    def hook_arrive(self, step: int, rank: int) -> List[int]:
        """Stamp, then forward to the wrapped coordinator (if any), timing
        the negotiation round-trip."""
        self.stamp(step, rank)
        if self.logic is not None:
            t0 = time.perf_counter()
            active = self.logic.hook_arrive(step, rank)
            with self._lock:
                self._rpc[step][rank] = time.perf_counter() - t0
            return active
        return []

    def wait_time(self, step: int) -> float:
        """max−min arrival across ranks for ``step`` (0.0 if <2 arrivals)."""
        with self._lock:
            stamps = list(self._stamps.get(step, {}).values())
        if len(stamps) < 2:
            return 0.0
        return max(stamps) - min(stamps)

    def rpc_overhead(self, step: int) -> float:
        """Worst per-rank negotiate() round-trip for ``step``.

        Note the leader's rent-or-buy wait is *inside* its round-trip, so
        this upper-bounds pure RPC cost the same way the reference's hook
        timestamps do (commu.py:387-394 time the send_ready_request call).
        """
        with self._lock:
            vals = list(self._rpc.get(step, {}).values())
        return max(vals) if vals else 0.0

    def steps(self) -> List[int]:
        with self._lock:
            return sorted(set(self._stamps) | set(self._rpc))

    def write_csv(self, path: str) -> None:
        """``step,wait_time_s,rpc_overhead_s`` rows — the reference's wait
        CSV shape plus the coordinator-overhead column."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "wait_time_s", "rpc_overhead_s"])
            for step in self.steps():
                w.writerow(
                    [
                        step,
                        f"{self.wait_time(step):.6f}",
                        f"{self.rpc_overhead(step):.6f}",
                    ]
                )


def emulate_heterogeneous_steps(
    probe: WaitTimeProbe,
    world_size: int,
    num_steps: int,
    base_compute_s: float = 0.005,
    heter_alpha: float = 1.0,
    slow_ranks: Sequence[int] = (0,),
    step_timeout_s: float = 60.0,
) -> List[float]:
    """Drive ``world_size`` emulated workers through ``num_steps`` hook
    rounds; ``slow_ranks`` compute for ``base_compute_s × heter_alpha``
    (everyone else ``base_compute_s``) — the reference's ``heter_alpha``
    emulation (get_wait_time.py:60,103).  Returns the per-step wait times.

    Workers barrier between steps, like a real DDP loop barriers on the
    gradient allreduce: without it the straggler's lag would accumulate and
    later steps would report the *cumulative* skew, not the per-step skew.
    """
    barrier = threading.Barrier(world_size)
    errors: List[BaseException] = []
    broken: List[int] = []  # ranks that saw the barrier break

    def worker(rank: int) -> None:
        try:
            for step in range(num_steps):
                delay = base_compute_s * (heter_alpha if rank in slow_ranks else 1.0)
                time.sleep(delay)
                probe.hook_arrive(step, rank)
                barrier.wait(timeout=step_timeout_s)
        except threading.BrokenBarrierError:
            # either a peer aborted (its error is in `errors`) or this
            # rank's wait timed out — the caller distinguishes below
            broken.append(rank)
        except BaseException as exc:  # noqa: BLE001 — re-raised in the caller
            errors.append(exc)
            barrier.abort()  # release peers so the caller's join() returns

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if broken:  # barrier broke with no peer error captured: a wait timed out
        raise TimeoutError(
            f"emulation barrier broke on ranks {sorted(broken)} with no peer "
            f"error — a barrier.wait exceeded step_timeout_s={step_timeout_s}"
        )
    return [probe.wait_time(s) for s in range(num_steps)]
