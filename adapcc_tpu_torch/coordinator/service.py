"""gRPC transport for the coordinator (wire-compatible with the reference).

Service/message names, field numbers, and RPC semantics match the reference's
``coordinator.proto`` (proto/protobuf/coordinator.proto:20-43) so a reference
client could talk to this server.  The Python gRPC *stubs* are hand-written
over the protoc-generated message classes because the image ships protoc but
not the grpc codegen plugin.

Client classes mirror the reference's (proto/rpc_client.py): ``Controller``
sends per-step relay/heartbeat requests, ``Hooker`` sends bucket-ready
requests.  Beyond the reference, the service carries a third, additive RPC —
``heartbeat`` — the liveness lease the supervisor daemon
(docs/SUPERVISOR.md) detects real cross-process silence from; it reuses the
reference's ``cont_request``/``cont_response`` message shapes so the wire
vocabulary stays the reference's.

Every client call runs under a deadline (``ADAPCC_RPC_TIMEOUT_S``) with
bounded exponential backoff + jitter on transport-level UNAVAILABLE errors:
a dead coordinator surfaces a loud :class:`CoordinatorUnavailable` within
the budget, never an indefinite block.  (Server-side, ``stop()`` drains
blocked waiters with an explicit sentinel — the two halves of the same
no-hang contract.)

A copy of :mod:`adapcc_tpu.coordinator.service` (importing the reference
module would load JAX through its package).  This module and
:mod:`~adapcc_tpu_torch.coordinator.protocol` are the only ones of the port
that import ``grpc`` and ``google.protobuf``.
"""

from __future__ import annotations

import os
import random
import time
from concurrent import futures
from typing import Callable, List, Optional, Tuple

import grpc

from adapcc_tpu_torch.coordinator.logic import CoordinatorLogic, CoordinatorShutdown
from adapcc_tpu_torch.coordinator.protocol import coordinator_pb2 as pb

_SERVICE = "coordinator.Coordinator"

#: client-side deadline budget for every coordinator RPC (seconds).  The
#: default clears the coordinator's own longest legitimate wait (the 10 s
#: fault timeout a blocked barrier can ride) with headroom; deployments
#: with tighter heartbeat knobs shrink it to match.  Malformed → loud.
RPC_TIMEOUT_ENV = "ADAPCC_RPC_TIMEOUT_S"
DEFAULT_RPC_TIMEOUT_S = 30.0

#: backoff for transport-level retries: bounded, exponential, jittered
RPC_BACKOFF_INITIAL_S = 0.05
RPC_BACKOFF_MAX_S = 1.0


def rpc_timeout_s(default: float = DEFAULT_RPC_TIMEOUT_S) -> float:
    """The ``ADAPCC_RPC_TIMEOUT_S`` funnel (malformed → loud, the
    ADAPCC_MERGE_ROUNDS policy)."""
    raw = os.environ.get(RPC_TIMEOUT_ENV, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError as e:
        raise ValueError(f"{RPC_TIMEOUT_ENV}={raw!r}: expected a number") from e
    if value <= 0:
        raise ValueError(f"{RPC_TIMEOUT_ENV}={raw!r}: must be > 0")
    return value


class CoordinatorUnavailable(grpc.RpcError):
    """The coordinator did not answer within the RPC deadline budget.

    A :class:`grpc.RpcError` subclass so every existing handler that
    catches transport errors keeps working, but *named*: "the control
    plane is gone" must read differently from a generic RPC hiccup.
    Raised client-side after the bounded backoff budget is exhausted (or
    immediately on a deadline the server let expire) — the loud surface
    the fault machinery needs, never an indefinite block.
    """

    def __init__(self, message: str) -> None:
        super().__init__(message)
        self.message = message

    def code(self) -> grpc.StatusCode:
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return self.message


def _call_with_deadline(
    call: Callable,
    request,
    what: str,
    timeout_s: Optional[float] = None,
    rng: Optional[random.Random] = None,
):
    """Run one unary RPC under the deadline budget (module doc).

    Retries ONLY transport-level UNAVAILABLE (connection refused / reset
    — and since gRPC can surface that even after the server processed the
    call, the arrival funnels dedupe per (step, rank) server-side, so a
    re-send is idempotent); an explicit server abort (the shutdown
    sentinel's "coordinator stopped") re-raises as-is, and a
    DEADLINE_EXCEEDED converts straight to :class:`CoordinatorUnavailable`
    — the server held the call past the whole budget, so retrying would
    just double the hang.
    """
    budget = rpc_timeout_s() if timeout_s is None else float(timeout_s)
    rng = rng if rng is not None else random.Random(0xBEA7)
    deadline = time.monotonic() + budget
    backoff = RPC_BACKOFF_INITIAL_S
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise CoordinatorUnavailable(
                f"coordinator unreachable: {what} got no answer within "
                f"{budget:.3f}s ({RPC_TIMEOUT_ENV} budget)"
            )
        try:
            return call(request, timeout=remaining)
        except grpc.RpcError as e:
            code = e.code() if callable(getattr(e, "code", None)) else None
            if code is grpc.StatusCode.DEADLINE_EXCEEDED:
                raise CoordinatorUnavailable(
                    f"coordinator unresponsive: {what} deadline "
                    f"({budget:.3f}s, {RPC_TIMEOUT_ENV}) expired"
                ) from e
            if code is not grpc.StatusCode.UNAVAILABLE:
                raise
            details = e.details() if callable(getattr(e, "details", None)) else ""
            if details and "coordinator stopped" in details:
                # the server's own drain sentinel: an explicit answer,
                # not silence — surface it unchanged
                raise
            sleep = min(
                backoff * (1.0 + rng.random()),  # full jitter in [b, 2b)
                RPC_BACKOFF_MAX_S,
                max(0.0, deadline - time.monotonic()),
            )
            if sleep > 0:
                time.sleep(sleep)
            backoff = min(backoff * 2, RPC_BACKOFF_MAX_S)


class CoordinatorServer:
    """Hosts the decision logic on ``ip:port`` (rank 0 in the reference,
    commu.py:136-141)."""

    def __init__(
        self,
        world_size: int,
        ip: str = "127.0.0.1",
        port: int = 50051,
        logic: Optional[CoordinatorLogic] = None,
        max_workers: int = 16,
    ) -> None:
        self.logic = logic if logic is not None else CoordinatorLogic(world_size)
        self.address = f"{ip}:{port}"
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        handlers = {
            "controller_fetch": grpc.unary_unary_rpc_method_handler(
                self._controller_fetch,
                request_deserializer=pb.cont_request.FromString,
                response_serializer=pb.cont_response.SerializeToString,
            ),
            "hook_fetch": grpc.unary_unary_rpc_method_handler(
                self._hook_fetch,
                request_deserializer=pb.hook_request.FromString,
                response_serializer=pb.hook_response.SerializeToString,
            ),
            # additive liveness-lease RPC (docs/SUPERVISOR.md): reuses the
            # cont_request/cont_response shapes — step carries the rank's
            # self-reported recent step walltime in MICROSECONDS (0 =
            # none), the response's status carries the worldview epoch
            "heartbeat": grpc.unary_unary_rpc_method_handler(
                self._heartbeat,
                request_deserializer=pb.cont_request.FromString,
                response_serializer=pb.cont_response.SerializeToString,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self._port = self._server.add_insecure_port(self.address)

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "CoordinatorServer":
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = 0.5) -> None:
        """Drain in-flight waiters, then stop the transport.

        ``logic.shutdown()`` wakes every RPC handler blocked on the
        condition variable with an explicit sentinel (turned into an
        UNAVAILABLE abort below), so a worker parked in
        ``send_ready_request`` unblocks with a clean error instead of
        hanging until its channel times out long after the server is gone.
        """
        self.logic.shutdown()
        self._server.stop(grace)

    # -- rpc handlers ----------------------------------------------------------

    def _controller_fetch(self, request, context):
        try:
            active, status = self.logic.controller_arrive(request.step, request.world_rank)
        except CoordinatorShutdown:
            context.abort(grpc.StatusCode.UNAVAILABLE, "coordinator stopped")
        return pb.cont_response(active_list=active, status=status)

    def _hook_fetch(self, request, context):
        try:
            active = self.logic.hook_arrive(request.step, request.world_rank)
        except CoordinatorShutdown:
            context.abort(grpc.StatusCode.UNAVAILABLE, "coordinator stopped")
        return pb.hook_response(active_list=active)

    def _heartbeat(self, request, context):
        try:
            alive, epoch = self.logic.heartbeat_arrive(
                request.world_rank,
                median_s=(request.step / 1e6) if request.step > 0 else None,
            )
        except CoordinatorShutdown:
            context.abort(grpc.StatusCode.UNAVAILABLE, "coordinator stopped")
        return pb.cont_response(active_list=alive, status=epoch)


class _Stub:
    def __init__(self, channel: grpc.Channel):
        self.controller_fetch = channel.unary_unary(
            f"/{_SERVICE}/controller_fetch",
            request_serializer=pb.cont_request.SerializeToString,
            response_deserializer=pb.cont_response.FromString,
        )
        self.hook_fetch = channel.unary_unary(
            f"/{_SERVICE}/hook_fetch",
            request_serializer=pb.hook_request.SerializeToString,
            response_deserializer=pb.hook_response.FromString,
        )
        self.heartbeat = channel.unary_unary(
            f"/{_SERVICE}/heartbeat",
            request_serializer=pb.cont_request.SerializeToString,
            response_deserializer=pb.cont_response.FromString,
        )


class Controller:
    """Per-rank relay/heartbeat client (reference rpc_client.py Controller)."""

    def __init__(self, ip: str, port: int, timeout_s: Optional[float] = None):
        self._channel = grpc.insecure_channel(f"{ip}:{port}")
        self._stub = _Stub(self._channel)
        self._timeout_s = timeout_s
        self._rng = random.Random(0xC0)

    def send_relay_request(self, step: int, world_rank: int) -> Tuple[List[int], int]:
        resp = _call_with_deadline(
            self._stub.controller_fetch,
            pb.cont_request(step=step, world_rank=world_rank),
            f"controller_fetch(step={step}, rank={world_rank})",
            timeout_s=self._timeout_s,
            rng=self._rng,
        )
        return list(resp.active_list), resp.status

    def close(self) -> None:
        self._channel.close()


class Hooker:
    """Per-rank bucket-ready client (reference rpc_client.py Hooker)."""

    def __init__(self, ip: str, port: int, timeout_s: Optional[float] = None):
        self._channel = grpc.insecure_channel(f"{ip}:{port}")
        self._stub = _Stub(self._channel)
        self._timeout_s = timeout_s
        self._rng = random.Random(0x400C)

    def send_ready_request(self, step: int, world_rank: int) -> List[int]:
        resp = _call_with_deadline(
            self._stub.hook_fetch,
            pb.hook_request(step=step, world_rank=world_rank),
            f"hook_fetch(step={step}, rank={world_rank})",
            timeout_s=self._timeout_s,
            rng=self._rng,
        )
        return list(resp.active_list)

    def close(self) -> None:
        self._channel.close()


class HeartbeatClient:
    """Per-rank liveness lease (docs/SUPERVISOR.md).

    ``beat`` sends one heartbeat — optionally carrying the rank's recent
    step walltime, the slow-rank rule's evidence — and returns the
    coordinator's ``(alive_list, worldview_epoch)``, which is how a
    training process *observes* epoch bumps without owning any decision.
    ``run`` loops at ``period_s`` until stopped; an optional ``gate``
    (e.g. :class:`adapcc_tpu.supervisor.chaos.BeatChaos`) drops or delays
    individual beats at this exact seam, deterministically.
    """

    def __init__(
        self,
        ip: str,
        port: int,
        rank: int,
        timeout_s: Optional[float] = None,
    ):
        self._channel = grpc.insecure_channel(f"{ip}:{port}")
        self._stub = _Stub(self._channel)
        self.rank = int(rank)
        self._timeout_s = timeout_s
        self._rng = random.Random(0xBEA7 ^ self.rank)
        self.seq = 0

    def beat(self, median_s: Optional[float] = None) -> Tuple[List[int], int]:
        self.seq += 1
        median_us = 0
        if median_s is not None:
            if median_s <= 0:
                raise ValueError(f"median_s must be > 0, got {median_s}")
            median_us = max(1, int(round(median_s * 1e6)))
        resp = _call_with_deadline(
            self._stub.heartbeat,
            pb.cont_request(step=median_us, world_rank=self.rank),
            f"heartbeat(rank={self.rank}, seq={self.seq})",
            timeout_s=self._timeout_s,
            rng=self._rng,
        )
        return list(resp.active_list), resp.status

    def run(
        self,
        period_s: float,
        stop_event,
        median_source: Optional[Callable[[], Optional[float]]] = None,
        gate=None,
    ) -> None:
        """Beat every ``period_s`` until ``stop_event`` is set.  A beat
        the coordinator cannot take (unavailable within the deadline) is
        dropped and the loop continues — a rank must keep *trying* to
        lease through a control-plane blip, not die of one."""
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        while not stop_event.is_set():
            send, delay = (True, 0.0)
            if gate is not None:
                send, delay = gate.gate(self.rank, self.seq + 1)
            if delay > 0 and stop_event.wait(delay):
                return
            if send:
                try:
                    self.beat(
                        median_source() if median_source is not None else None
                    )
                except grpc.RpcError:
                    pass  # keep leasing; silence is the supervisor's signal
            else:
                self.seq += 1  # a dropped beat still consumes its slot
            if stop_event.wait(period_s):
                return

    def close(self) -> None:
        self._channel.close()
