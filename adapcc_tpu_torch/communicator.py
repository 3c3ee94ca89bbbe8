"""Communicator: the control-plane orchestrator (reference CudaCommu analog).

The port of :mod:`adapcc_tpu.communicator`, in the JAX package's
single-controller form: one object owns the detect → profile → synthesize →
execute workflow that the reference spreads across ctypes calls into
``communicator.so`` plus scp fan-out (commu.py:301-352), and its collectives
take stacked ``[world, ...]`` tensors (row ``r`` = rank ``r``) through the
port's stacked :class:`~adapcc_tpu_torch.comm.engine.CollectiveEngine`.

Lifecycle parity (reference commu.py / run.cu):

- ``init_threads(DETECT)`` / ``exit_threads(DETECT)``: detect the topology,
  dump per-host XML shards, merge them into the logical graph;
- ``init_threads(PROFILE)`` / ``exit_threads(PROFILE)``: probe the world,
  dump and gather the lat/bw matrices, synthesize and persist the strategy
  (``_synthesis_strategy``, commu.py:272-278);
- ``init_threads(<collective>)``: build an engine from the strategy file;
- ``exit_threads(<collective>)`` / ``clear()``: drop the engines.

A world is either one process holding every rank's row (rank → process all
zeros) or, given ``world=`` a process group of one process a rank, the
identity map.  The coordinator plane works in both.  The Communicator owns
one plan tuner (:class:`~adapcc_tpu_torch.tuner.CollectiveTuner`), shared by
every engine it builds; ``ADAPCC_TUNER`` decides whether anything consults
or feeds it.  :meth:`Communicator.supervisor` hands the world's failover to
an out-of-band :class:`~adapcc_tpu_torch.supervisor.Supervisor`, and
:meth:`Communicator.adaptation_controller` its online adaptation to an
:class:`~adapcc_tpu_torch.adapt.AdaptationController`.  The DETECT/PROFILE
bootstrap of a multi-process world raises until its slice.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from adapcc_tpu_torch.comm.engine import CollectiveEngine, EpochMismatch
from adapcc_tpu_torch.comm.mesh import DeviceLike, World, mesh_ip_table, resolve_device, world_processes
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.primitives import (
    ALLGATHER,
    ALLREDUCE,
    ALLTOALL,
    BOARDCAST,
    DETECT,
    PROFILE,
    REDUCE,
    REDUCESCATTER,
    ReduceOp,
    not_ported,
)
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.synthesizer import Synthesizer
from adapcc_tpu_torch.strategy.xml_io import (
    parse_logical_graph_xml,
    parse_strategy_xml,
    read_ip_table,
    write_ip_table,
)
from adapcc_tpu_torch.topology.detect import dump_detected_topology, gather_detect_graph
from adapcc_tpu_torch.topology.profile import NetworkProfiler, gather_topo_profile
from adapcc_tpu_torch.tuner import TUNER_DB_ENV, CollectiveTuner
from adapcc_tpu_torch.tuner.db import device_platform, topology_fingerprint

_COLLECTIVE_PRIMS = (ALLREDUCE, REDUCE, BOARDCAST, ALLGATHER, ALLTOALL, REDUCESCATTER)

#: bounded retry for collectives that race a plan failover: a dispatch
#: issued against a dead epoch raises EpochMismatch; the Communicator adopts
#: the engine's current epoch and re-issues after an exponential backoff.
#: Exhausting the budget re-raises.
EPOCH_RETRY_MAX = 3
EPOCH_RETRY_BACKOFF_S = 0.02

class Communicator:
    """One communication world: its ranks, artifacts and engines.

    ``world_size`` ranks stacked on ``device`` (the card unless the caller
    passes ``"cpu"``); ``world``, a multi-process :class:`World` of one
    process a rank, sets both and makes rank ``r`` process ``r``.  Without
    either, the world is one rank.  ``num_slices > 1`` makes the stacked
    world two-level (the JAX package's ``("dcn", "ici")`` mesh): its ip
    table labels each rank by its slice row, never read from an existing
    ``ip_table.txt`` and written only where none exists, and its engines run
    the two-level plane."""

    def __init__(
        self,
        args: CommArgs,
        world_size: Optional[int] = None,
        device: DeviceLike = None,
        world: Optional[World] = None,
        num_slices: int = 1,
    ) -> None:
        multi = world is not None and world.world_size > 1
        if multi and num_slices != 1:
            raise not_ported("a two-level world over a process group (one subgroup of lanes, one of slices)",
                             "the per-process slice")
        if multi:
            if world_size is not None and world_size != world.world_size:
                raise ValueError(
                    f"world_size {world_size} over a process group of {world.world_size} processes"
                )
            world_size = world.world_size
        if device is None and world is not None:
            device = world.device
        self.args = args
        self.world = world
        self.world_size = int(world_size) if world_size is not None else 1
        self.num_slices = int(num_slices)
        self.device = resolve_device(device)
        self.chunk_bytes = args.default_chunk_bytes
        #: rank → owning process
        self._process_of = world_processes(self.world_size, world if multi else None)

        os.makedirs(args.topology_dir, exist_ok=True)
        ip_table_path = os.path.join(args.topology_dir, "ip_table.txt")
        self.ip_table = None
        # a two-level world's hosts are its slice rows: an existing table
        # (real ips, or a flat run's) would split the synthesizer's hosts
        # away from the plane's slices
        if os.path.exists(ip_table_path) and self.num_slices == 1:
            table = read_ip_table(ip_table_path)
            if len(table) == self.world_size:
                self.ip_table = table
        if self.ip_table is None:
            # missing, stale (another world size) or two-level: derive from
            # the world, and persist only when no artifact exists
            self.ip_table = mesh_ip_table(self.world_size, self.num_slices, world if multi else None)
            if not os.path.exists(ip_table_path):
                write_ip_table(self.ip_table, ip_table_path)

        self.synthesizer = Synthesizer(args.strategy_file, self.ip_table, policy=args.policy)
        #: the measurement-driven plan tuner, shared by every engine built
        #: here and fingerprinted with the ip table and the device (a median
        #: taken under one host layout must not rank plans for another); its
        #: database lands beside the other topology artifacts unless
        #: ADAPCC_TUNER_DB says otherwise.  A malformed ADAPCC_TUNER raises.
        self.tuner = CollectiveTuner(
            world=self.world_size,
            topology=topology_fingerprint(self.world_size, dict(enumerate(self.ip_table)),
                                          platform=device_platform(self.device)),
            db_path=None if os.environ.get(TUNER_DB_ENV) else os.path.join(args.topology_dir, "tuning.jsonl"),
        )
        self._engines: Dict[int, CollectiveEngine] = {}
        self._strategy: Optional[Strategy] = None

        # coordinator plane (reference commu.py:81-94,143-170)
        self.fault_worker_list: List[int] = []
        self.coordinator_unreachable = False
        self.process_rank = 0
        self.num_processes = 1
        self._coordinator_server = None
        self._coordinator_addr = None
        self._controller = None
        self._hooker = None
        self._controller_thread = None
        self._heartbeat_client = None
        self._heartbeat_thread = None
        self._heartbeat_stop = None
        self._step_queue = None
        self._active_by_step: Dict[int, List[int]] = {}
        #: per-step negotiate() round-trip cost, (step, seconds) (the
        #: reference's rpc latency prints, commu.py:37,387-394)
        self.rpc_latencies: List[tuple] = []
        #: optional MetricsRegistry: negotiation round-trips under "negotiate",
        #: and the hook's bucket plan when the hook has no registry of its own
        self.metrics = None

    # -- lifecycle -------------------------------------------------------------

    def _single_process_bootstrap(self, what: str) -> None:
        if self.world is not None and self.world.world_size > 1:
            raise not_ported(
                f"the {what} bootstrap across {self.world.world_size} processes "
                "(profile gather and strategy fan-out over the process group)",
                "the per-process slice",
            )

    def init_threads(self, prim: int) -> None:
        if prim == DETECT:
            self._single_process_bootstrap("DETECT")
            dump_detected_topology(mesh_ip_table(self.world_size, self.num_slices), self.args.topology_dir)
        elif prim == PROFILE:
            self._single_process_bootstrap("PROFILE")
            NetworkProfiler(self.world_size, self.device).dump(self.args.topology_dir, rank=0)
        elif prim in _COLLECTIVE_PRIMS:
            self._engines[prim] = CollectiveEngine(
                self.world_size, self._load_strategy(), use_xla_fastpath=self.args.use_xla_fastpath,
                tuner=self.tuner, num_slices=self.num_slices,
            )
        else:
            raise ValueError(f"unknown primitive {prim}")

    def exit_threads(self, prim: int) -> None:
        if prim == DETECT:
            gather_detect_graph(self.args.topology_dir, self.args.logical_graph)
        elif prim == PROFILE:
            self._single_process_bootstrap("PROFILE")
            self._synthesis_strategy()
        elif prim in _COLLECTIVE_PRIMS:
            eng = self._engines.pop(prim, None)
            if eng is not None:
                eng.clear()

    def clear(self) -> None:
        """Tear down contexts and the coordinator plane (reference clear
        stops the controller thread and the grpc server, commu.py:285-291)."""
        for eng in self._engines.values():
            eng.clear()
        self._engines.clear()
        self._strategy = None
        self.stop_coordinator()

    def _load_strategy(self) -> Strategy:
        if self._strategy is not None:
            return self._strategy
        if self.args.strategy_file and os.path.exists(self.args.strategy_file):
            self._strategy = parse_strategy_xml(self.args.strategy_file, self.chunk_bytes)
            # a persisted strategy's chunk_bytes is the granularity every
            # engine built from it runs at
            self.chunk_bytes = self._strategy.chunk_bytes
        else:
            # no strategy artifact: the default ring over the world
            ips = {r: ip for r, ip in enumerate(self.ip_table)}
            self._strategy = Strategy.ring(self.world_size, max(1, self.args.parallel_degree), ips)
        return self._strategy

    def _synthesis_strategy(self) -> None:
        """Profile artifacts → strategy XML + chunk size (reference
        ``_synthesis_strategy``, commu.py:272-278)."""
        lat, bw = gather_topo_profile(self.args.topology_dir, self.world_size)
        if not bw.any():  # profiling produced nothing (one rank)
            return
        graph_local_rank0s = None
        if os.path.exists(self.args.logical_graph):
            graph_local_rank0s = parse_logical_graph_xml(self.args.logical_graph).local_rank0_list()
        self.chunk_bytes = self.synthesizer.generate_strategy(
            ALLREDUCE,
            self.args.parallel_degree,
            transmission_size=self.chunk_bytes,
            bandwidth_graph=bw,
            latency_graph=lat,
            local_rank0_list=graph_local_rank0s,
        )
        self._strategy = None  # reload from the fresh XML

    # -- collectives (stacked [world, ...] single-controller view) -------------

    def _engine(self, prim: int) -> CollectiveEngine:
        if prim not in self._engines:
            raise RuntimeError(
                f"no context for primitive {prim}; call setup/init_threads first "
                "(reference requires initThreads before collectives, run.cu:103-127)"
            )
        return self._engines[prim]

    def _dispatch_with_epoch_retry(self, dispatch: Callable, epoch: Optional[int]):
        """Run ``dispatch(epoch)`` with bounded EpochMismatch retry.

        ``epoch=None`` skips the check.  An elastic caller passes the epoch
        it planned against; if the world moved on, the engine's current
        epoch is adopted and the call re-issued, immediately the first time
        and after an exponential backoff after that."""
        attempt = 0
        while True:
            try:
                return dispatch(epoch)
            except EpochMismatch as e:
                if attempt >= EPOCH_RETRY_MAX:
                    raise
                if attempt > 0:
                    time.sleep(EPOCH_RETRY_BACKOFF_S * (2 ** (attempt - 1)))
                attempt += 1
                epoch = e.current

    @staticmethod
    def _no_positional_op(size, chunk_bytes) -> None:
        if isinstance(size, ReduceOp) or isinstance(chunk_bytes, ReduceOp):
            raise TypeError(
                "pass op= by keyword: the reference-parity positional slots "
                "are (tensor, size, chunk_bytes, active_gpus), so a "
                "positional ReduceOp would silently land in one of them and "
                "the reduction would run as SUM"
            )

    def all_reduce(
        self,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """Reference signature ``all_reduce(tensor, size, chunk_bytes,
        active_gpus)`` (commu.py:360-365); ``size``/``chunk_bytes`` are
        accepted for parity only (the granularity is the strategy's)."""
        self._no_positional_op(size, chunk_bytes)
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(ALLREDUCE).all_reduce(tensor, active_gpus=active_gpus, op=op, epoch=ep),
            epoch,
        )

    def reduce(
        self,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        self._no_positional_op(size, chunk_bytes)
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(REDUCE).reduce(tensor, active_gpus=active_gpus, op=op, epoch=ep),
            epoch,
        )

    def broadcast(
        self,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(BOARDCAST).broadcast(tensor, active_gpus, epoch=ep),
            epoch,
        )

    #: reference C-ABI spelling (commu.py boardcast); silent here, as in the
    #: JAX package's façade
    boardcast = broadcast

    def alltoall(
        self,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(ALLTOALL).all_to_all(tensor, active_gpus, epoch=ep),
            epoch,
        )

    def all_gather(
        self,
        tensor: torch.Tensor,
        active_gpus: Optional[Sequence[int]] = None,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(ALLGATHER).all_gather(tensor, active_gpus, epoch=ep),
            epoch,
        )

    def reduce_scatter(
        self,
        tensor: torch.Tensor,
        *,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        return self._dispatch_with_epoch_retry(
            lambda ep: self._engine(REDUCESCATTER).reduce_scatter(
                tensor, active_gpus=active_gpus, op=op, epoch=ep
            ),
            epoch,
        )

    # -- coordinator plane -----------------------------------------------------

    def enable_coordinator(
        self,
        is_master: bool = True,
        process_rank: int = 0,
        num_processes: Optional[int] = None,
        ip: str = "127.0.0.1",
        port: Optional[int] = None,
    ) -> None:
        """Start the relay/fault coordinator plane.

        In the reference, world rank 0 hosts the gRPC Coordinator and every
        rank runs a controller thread plus Controller/Hooker stubs
        (commu.py:81-94,136-141).  The participants are processes: one
        holding every rank, or one a rank."""
        import queue as _queue
        import threading

        from adapcc_tpu_torch.coordinator.service import Controller, CoordinatorServer, Hooker

        port = port if port is not None else self.args.port
        self.num_processes = num_processes if num_processes is not None else 1
        self.process_rank = process_rank
        if is_master:
            self._coordinator_server = CoordinatorServer(self.num_processes, ip=ip, port=port).start()
            port = self._coordinator_server.port  # resolves port=0 to the bound one
        self._coordinator_addr = (ip, port)
        self._controller = Controller(ip, port)
        self._hooker = Hooker(ip, port)
        self._step_queue = _queue.Queue()
        self._controller_thread = threading.Thread(target=self._controller_loop, daemon=True)
        self._controller_thread.start()

    def start_heartbeat(self, period_s: float = 1.0, median_source=None, gate=None) -> None:
        """Lease liveness through the coordinator's heartbeat RPC every
        ``period_s`` from a background thread, optionally carrying the
        recent step walltime ``median_source`` reports.  Needs
        :meth:`enable_coordinator` first; idempotent per enable cycle."""
        if self._coordinator_addr is None:
            raise RuntimeError(
                "start_heartbeat needs enable_coordinator first (the "
                "heartbeat leases through the coordinator channel)"
            )
        if self._heartbeat_thread is not None:
            return
        import threading

        from adapcc_tpu_torch.coordinator.service import HeartbeatClient

        ip, port = self._coordinator_addr
        self._heartbeat_client = HeartbeatClient(ip, port, self.process_rank)
        self._heartbeat_stop = threading.Event()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_client.run,
            args=(period_s, self._heartbeat_stop),
            kwargs={"median_source": median_source, "gate": gate},
            name="adapcc-heartbeat",
            daemon=True,
        )
        self._heartbeat_thread.start()

    def supervisor(self, prim: int = ALLREDUCE, **kwargs):
        """An autonomous :class:`~adapcc_tpu_torch.supervisor.Supervisor`
        over this world: the ``prim`` engine, a coordinator logic of the
        engine's world (the in-process coordinator's when it has that world,
        so its heartbeats feed the daemon; a logic of its own otherwise), a
        :class:`~adapcc_tpu_torch.elastic.StandbyPlanCache` over the engine,
        built (its warms on this world's device), and a journal at
        ``<topology_dir>/supervisor.journal``; any of them can be passed
        instead."""
        from adapcc_tpu_torch.supervisor import Supervisor

        engine = kwargs.pop("engine", None) or self._engine(prim)
        logic = kwargs.pop("logic", None)
        if logic is None:
            server = self._coordinator_server
            if server is not None and server.logic.world_size == engine.world_size:
                logic = server.logic
            else:
                from adapcc_tpu_torch.coordinator import CoordinatorLogic

                logic = CoordinatorLogic(engine.world_size)
        kwargs.setdefault("metrics", self.metrics)
        kwargs.setdefault("journal_path", os.path.join(self.args.topology_dir, "supervisor.journal"))
        if "cache" not in kwargs:
            # every plausible shrink ranked up front: the daemon's failover is
            # a dispatch-time cache-key switch, not a cold re-plan
            from adapcc_tpu_torch.elastic import StandbyPlanCache

            cache = StandbyPlanCache(engine, device=self.device)
            cache.build()
            kwargs["cache"] = cache
        return Supervisor(logic, engine=engine, **kwargs)

    def adaptation_controller(self, prim: int = ALLREDUCE, trainer=None, mode: Optional[str] = None, **kwargs):
        """The closed online adaptation loop over this world: an
        :class:`~adapcc_tpu_torch.adapt.AdaptationController` on the ``prim``
        engine, the communicator's synthesizer (the bootstrap's candidate
        pool), the tuner's database (the measurement feed) and topology
        fingerprint, a calibration artifact at
        ``<topology_dir>/calibration.json`` and this world's device; any of
        them can be passed instead.  ``ADAPCC_ADAPT`` gates the loop;
        ``mode`` is the default when it is unset."""
        from adapcc_tpu_torch.adapt import AdaptationController

        engine = self._engine(prim)
        kwargs.setdefault("db", self.tuner.db)
        kwargs.setdefault("fingerprint", self.tuner.topology)
        kwargs.setdefault("calibration_path", os.path.join(self.args.topology_dir, "calibration.json"))
        kwargs.setdefault("parallel_degree", max(1, self.args.parallel_degree))
        kwargs.setdefault("device", self.device)
        return AdaptationController(engine, self.synthesizer, trainer=trainer, mode=mode, **kwargs)

    def calibrate_coordinator(self, total_grad_bytes: float) -> bool:
        """Feed measured quantities into the rent-or-buy cost model: the
        caller's gradient volume and this world's profiled mean link
        bandwidth, inter-process links only where there are any.  Master
        process only; False (no in-process server, no usable profile) means
        "stay on the defaults", not an error."""
        if self._coordinator_server is None:
            return False
        lat, bw = gather_topo_profile(self.args.topology_dir, self.world_size)
        ips = np.asarray(self.ip_table)
        inter = ips[:, None] != ips[None, :]
        links = bw[(bw > 0) & inter]
        if links.size == 0:
            # one host: no inter-process links; the overall off-diagonal mean
            links = bw[(bw > 0) & ~np.eye(self.world_size, dtype=bool)]
        if links.size == 0:
            return False
        self._coordinator_server.logic.calibrate(total_grad_bytes, float(links.mean()))
        return True

    @property
    def _controller_alive(self) -> bool:
        return self._controller_thread is not None and self._controller_thread.is_alive()

    def _controller_loop(self) -> None:
        """Background heartbeat consumer (reference controller thread,
        commu.py:143-170): one relay request per training step; a status-0
        response records the dead processes and stops the thread, as does
        an RPC failure (reported, never silent)."""
        import grpc as _grpc

        while True:
            step = self._step_queue.get()
            if step is None:
                return
            try:
                active, status = self._controller.send_relay_request(step, self.process_rank)
            except _grpc.RpcError as e:  # noqa: PERF203
                if e.code() is not _grpc.StatusCode.CANCELLED:
                    print(f"[adapcc] controller RPC failed ({e.code()}); fault detection stopped")
                    self.coordinator_unreachable = True
                return
            if status == 0:
                self.fault_worker_list = sorted(set(range(self.num_processes)) - set(active))
                return
            self._active_by_step[step] = active
            for old in [s for s in self._active_by_step if s < step - 100]:
                del self._active_by_step[old]

    def update_relay(self, step: int) -> None:
        """Kick the controller heartbeat for this step (reference
        commu.py:293-299); a no-op once the controller thread stopped."""
        if self._step_queue is not None and self._controller_alive:
            self._step_queue.put(step)

    def hook_ready(self, step: int) -> List[int]:
        """First-bucket-ready negotiation: the frozen active process list of
        this step (reference cuda_allreduce_hook → hook_fetch,
        commu.py:385-399).  A sole process whose coordinator is unreachable
        goes on alone; in a multi-process world that raises, since an active
        set picked alone would diverge from its peers'."""
        if self._hooker is None:
            return list(range(self.world_size))
        import grpc as _grpc

        try:
            t0 = time.perf_counter()
            active = self._hooker.send_ready_request(step, self.process_rank)
            dt = time.perf_counter() - t0
            self.rpc_latencies.append((step, dt))
            if len(self.rpc_latencies) > 100_000:  # bound long-run memory
                del self.rpc_latencies[: 50_000]
            if self.metrics is not None:
                self.metrics.observe("negotiate", dt)
            return active
        except _grpc.RpcError as e:
            if self.num_processes <= 1:
                if not self.coordinator_unreachable:
                    print(f"[adapcc] hook RPC failed ({e.code()}); proceeding without coordinator")
                    self.coordinator_unreachable = True
                return [self.process_rank]
            raise RuntimeError(
                "coordinator unreachable during hook negotiation; cannot pick an "
                "active set unilaterally in a multi-process world"
            ) from e

    def write_rpc_latency(self, path: Optional[str] = None) -> str:
        """Dump per-step negotiate() round-trips, one float a line (the
        reference's ``proto/latency_0.0.txt``, commu.py:37,387-394)."""
        if path is None:
            path = os.path.join(self.args.topology_dir, f"latency_{self.process_rank}.0.txt")
        with open(path, "w") as f:
            for _, dt in self.rpc_latencies:
                f.write(format(dt, "f") + "\n")
        return path

    def relay_active_list(self, step: int) -> Optional[List[int]]:
        return self._active_by_step.get(step)

    def chips_of_processes(self, active_processes: Sequence[int]) -> List[int]:
        """Expand coordinator *process* ranks to the ranks they hold: a
        straggling process demotes all of its ranks to relays."""
        procs = set(active_processes)
        return [r for r in range(self.world_size) if self._process_of[r] in procs]

    def stop_coordinator(self) -> None:
        if self._step_queue is not None:
            self._step_queue.put(None)
        if self._controller_thread is not None:
            self._controller_thread.join(timeout=2)
            self._controller_thread = None
        if self._heartbeat_stop is not None:
            self._heartbeat_stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=2)
            self._heartbeat_thread = None
        for client in (self._controller, self._hooker, self._heartbeat_client):
            if client is not None:
                client.close()
        self._controller = self._hooker = self._heartbeat_client = None
        self._heartbeat_stop = None
        self._coordinator_addr = None
        if self._coordinator_server is not None:
            self._coordinator_server.stop()
            self._coordinator_server = None
        self._step_queue = None

    # -- introspection ---------------------------------------------------------

    @property
    def strategy(self) -> Strategy:
        return self._load_strategy()

    def active_contexts(self) -> List[int]:
        return sorted(self._engines)
