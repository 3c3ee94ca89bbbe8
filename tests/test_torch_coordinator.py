"""The port's coordinator plane held against the JAX package's.

- ``CoordinatorLogic``: the rent-or-buy cost functions and the calibration
  (exact floats), and the scenarios of ``tests/test_coordinator.py`` run
  with threads on both logics: the all-arrive freeze, straggler demotion,
  the sole leader's escape, the controller barrier's alive subset under a
  short fault timeout, a duck-typed fault plan, the wait-time probe.
- gRPC: a port client against a JAX server and a JAX client against a port
  server (one process holds both protobuf modules: their descriptors must
  be byte-identical).
- The Communicator's coordinator plane and the trainer's coordinator rules.
- A negotiated DDP step: the bench GPT-2 at a tiny size, world 2 over gloo,
  rank 0 hosting the server; rank 1 late at one step is demoted, and the
  JAX trainer run with the negotiated masks as explicit ``active_mask``s
  gives the same losses and parameters.

The logics' timings are cut as ``tests/test_coordinator.py::fast_logic``
cuts them; no default changes.  The threaded scenarios fix their arrival
order rather than race it: threads leave one barrier together, a late rank
waits on an event until the step froze without it, and the logic's clock
is stepped by arrivals and reads rather than by the scheduler
(``_SteppedClock``), so a loaded machine cannot demote an on-time rank,
and the rent-or-buy's buy point and relay threshold fall at a known
arrival and read (``test_rent_or_buy_freezes_at_the_formulas_time``).  The
JAX package is imported inside the functions that use it.
"""

import collections
import contextlib
import multiprocessing
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.communicator import Communicator
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.coordinator import CoordinatorLogic
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.elastic.worldview import WorldView, slow_ranks_from_medians
from adapcc_tpu_torch.measure import WaitTimeProbe, emulate_heterogeneous_steps
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from test_torch_ddp import LOSS_ATOL, LR, PER_RANK_BATCH, TINY, _assert_params_close, _flax_params, _free_port

FAST = dict(relay_threshold=0.05, time_slot=0.002, fault_timeout=0.5)


def _logics(world, **kw):
    """The port's and the JAX package's logic, built alike."""
    from adapcc_tpu.coordinator import CoordinatorLogic as JaxLogic

    kw = {**FAST, **kw}
    return CoordinatorLogic(world, **kw), JaxLogic(world, **kw)


def _run_workers(n, fn):
    """``fn(r)`` on ``n`` threads, released together from one barrier."""
    results, errors = {}, []
    start = threading.Barrier(n)

    def wrap(r):
        try:
            start.wait(timeout=10)
            results[r] = fn(r)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors
    return results


class _SteppedClock:
    """The clock of ``lg``'s module (``time.monotonic`` as the logic reads
    it), stepped by what happens instead of by the scheduler: it moves
    ``arrival_s`` with each arrival at a step and, once no open step has
    fewer than ``on_time`` arrivals, ``read_s`` with each read.  The
    rent-or-buy leader thus accrues ``(m - 1) * arrival_s`` of rent at its
    ``m``-th arrival and ``read_s`` a wait after the on-time ranks are in,
    so its buy point and relay threshold are crossed at a known arrival
    count and read, however a loaded machine schedules the threads.  The
    thresholds and the decision rule are the logic's own."""

    def __init__(self, lg, on_time, arrival_s=FAST["time_slot"], read_s=FAST["time_slot"]):
        self.lg, self.on_time, self.arrival_s, self.read_s = lg, on_time, arrival_s, read_s
        self.seen, self.reads, self.readings = {}, 0, []
        #: set once the clock was read with that many arrivals at an open step
        self.observed = collections.defaultdict(threading.Event)
        self._lock = threading.Lock()

    def at(self, arrivals, reads):
        return self.arrival_s * arrivals + self.read_s * reads

    def monotonic(self):
        # the logic reads its clock holding its condition: _ready and
        # _frozen are still while this runs
        with self._lock:
            held = False
            for step, ready in list(self.lg._ready.items()):
                self.seen[step] = max(self.seen.get(step, 0), len(ready))
                if step not in self.lg._frozen:
                    held |= len(ready) < self.on_time
                    self.observed[len(ready)].set()
            value = self.at(sum(self.seen.values()), self.reads)
            self.reads += not held
            self.readings.append(value)
            return value

    @contextlib.contextmanager
    def installed(self):
        module = sys.modules[type(self.lg).__module__]
        real = module.time
        module.time = SimpleNamespace(monotonic=self.monotonic)
        try:
            yield self
        finally:
            module.time = real


def _args(topo):
    return CommArgs(topology_dir=str(topo), strategy_file=str(topo / "strategy.xml"),
                    logical_graph=str(topo / "lg.xml"))


# --------------------------------------------------------------------------- #
# logic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_cost_model_and_calibration_are_jax_floats(world):
    port, ref = _logics(world)
    for calibration in (None, (400e6, 100.0), (1234567.0, 3.25)):
        if calibration is not None:
            port.calibrate(*calibration)
            ref.calibrate(*calibration)
        assert (port.accumulated_size, port.accumulated_bandwidth) == (ref.accumulated_size,
                                                                         ref.accumulated_bandwidth)
        assert port._initial_rent_cost() == ref._initial_rent_cost()
        assert [port._buy_cost(m) for m in range(1, world + 1)] == [ref._buy_cost(m) for m in range(1, world + 1)]
    for lg in (port, ref):
        with pytest.raises(ValueError, match="positive"):
            lg.calibrate(0, 100.0)


def _scenario_all_arrive(lg):
    return _run_workers(4, lambda r: sorted(lg.hook_arrive(step=0, rank=r)))


def _late_rank_workers(n, late, arrive):
    """``arrive(r)`` on ``n`` ranks: the on-time ones released together, the
    ``late`` one held on an event until an on-time rank's arrival has
    returned, i.e. the step is frozen without it: late past any threshold,
    whatever the machine's load."""
    frozen = threading.Event()

    def worker(r):
        if r == late:
            assert frozen.wait(timeout=10)
            return arrive(r)
        out = arrive(r)
        frozen.set()
        return out

    return _run_workers(n, worker)


def _scenario_straggler(lg):
    return _late_rank_workers(4, 3, lambda r: sorted(lg.hook_arrive(step=0, rank=r)))


def _scenario_sole_leader(lg):
    t0 = time.monotonic()
    active = lg.hook_arrive(step=0, rank=1)
    return active, time.monotonic() - t0 >= lg.fault_timeout


def _scenario_controller_alive(lg):
    def worker(r):
        lg.hook_arrive(step=0, rank=r)
        active, status = lg.controller_arrive(step=0, rank=r)
        return sorted(active), status

    return _run_workers(4, worker)


def _scenario_controller_fault(lg):
    # rank 3 never heartbeats: the others get the alive subset, status 0
    out = _run_workers(3, lambda r: lg.controller_arrive(step=0, rank=r))
    return {r: (sorted(a), s) for r, (a, s) in out.items()}, sorted(lg.worldview().alive)


def _scenario_fault_plan(lg):
    """A duck-typed plan with rank 2 down from step 1: its arrivals are
    dropped and the barriers shrink, with no clock in the decision."""
    class Plan:
        def state_at(self, step):
            return SimpleNamespace(down=frozenset({2}) if step >= 1 else frozenset(), slow_map={})

    lg.fault_plan = Plan()
    hooks = _run_workers(4, lambda r: sorted(lg.hook_arrive(step=1, rank=r)))
    conts = _run_workers(4, lambda r: lg.controller_arrive(step=1, rank=r))
    wv = lg.worldview()
    return hooks, {r: (sorted(a), s) for r, (a, s) in conts.items()}, (sorted(wv.alive), wv.epoch)


@pytest.mark.parametrize("scenario", [_scenario_all_arrive, _scenario_straggler, _scenario_sole_leader,
                                      _scenario_controller_alive, _scenario_controller_fault,
                                      _scenario_fault_plan], ids=lambda f: f.__name__[10:])
def test_logic_scenarios_decide_as_jax(scenario):
    world = 2 if scenario is _scenario_sole_leader else 4
    kw = {"fault_timeout": 0.2} if scenario in (_scenario_sole_leader, _scenario_controller_fault) else {}
    port, ref = _logics(world, **kw)
    # the ranks each scenario means to arrive on time (the others wait for
    # a timeout, which the clock must reach)
    on_time = {_scenario_all_arrive: 4, _scenario_straggler: 3, _scenario_controller_alive: 4,
               _scenario_fault_plan: 3}.get(scenario)
    results = []
    for lg in (port, ref):
        with _SteppedClock(lg, on_time).installed() if on_time else contextlib.nullcontext():
            results.append(scenario(lg))
    got, want = results
    assert got == want
    expected = {
        _scenario_all_arrive: {r: [0, 1, 2, 3] for r in range(4)},
        _scenario_straggler: {r: [0, 1, 2] for r in range(4)},
        _scenario_sole_leader: ([1], True),
        _scenario_controller_alive: {r: ([0, 1, 2, 3], 1) for r in range(4)},
        _scenario_controller_fault: ({r: ([0, 1, 2], 0) for r in range(3)}, [0, 1, 2]),
    }
    if scenario in expected:
        assert got == expected[scenario]
    else:
        hooks, conts, wv = got
        assert hooks == {r: [0, 1, 3] for r in range(4)} and wv == ([0, 1, 3], 1)
        assert all(c == ([0, 1, 3], 0) for c in conts.values())


def _freezes_at(lg, clock, m):
    """The rent at which the rent-or-buy freezes ``m`` ranks in when
    ``clock`` steps its time: the first read after the ``m``-th arrival at
    which renting on costs more than buying or the relay threshold is
    passed, from the logic's cost functions; and which of the two fired."""
    t0 = clock.at(1, 0)
    k = 0
    while True:
        rent = clock.at(m, k) - t0
        buy = rent + lg._initial_rent_cost() >= lg._buy_cost(m)
        if buy or rent > lg.relay_threshold:
            return rent, "buy" if buy else "relay"
        k += 1


@pytest.mark.parametrize("case", ["buy", "relay"])
def test_rent_or_buy_freezes_at_the_formulas_time(case):
    """Three of four ranks on time, each arriving once the leader has read
    its clock with the ranks before it in, the fourth held until the step
    froze: the leader freezes the three at the rent its cost formula names,
    on the stepped clock, and the port's logic at the same rent as JAX's.  ``buy``:
    the default costs and 7 ms an arrival put the buy point between the
    second and the third arrival (bought on the third's first read);
    ``relay``: calibrated costs put it past the 50 ms relay threshold,
    which fires first."""
    port, ref = _logics(4)
    rents = []
    for lg in (port, ref):
        if case == "relay":
            lg.calibrate(1e9, 10.0)  # 25 ms of size/bandwidth: the buy of 3 at 83 ms
        clock = _SteppedClock(lg, 3, arrival_s=0.007 if case == "buy" else FAST["time_slot"])
        # the decision must not fall before the third arrival, or the
        # arrival order would decide it
        assert _freezes_at(lg, clock, 2)[0] > clock.at(2, 0) - clock.at(1, 0)
        want_rent, fired = _freezes_at(lg, clock, 3)
        assert fired == case
        def arrive(r, lg=lg, clock=clock):
            if r in (1, 2):  # rank 0 leads and decides on each arrival count
                assert clock.observed[r].wait(timeout=10)
            return sorted(lg.hook_arrive(step=0, rank=r))

        with clock.installed():
            out = _late_rank_workers(4, 3, arrive)
        assert out == {r: [0, 1, 2] for r in range(4)}
        rent = clock.readings[-1] - clock.readings[0]
        assert rent == want_rent
        rents.append(rent)
    assert rents[0] == rents[1]
    # bought on the third arrival's first read; relayed some reads later
    assert (rents[0] == clock.at(3, 0) - clock.at(1, 0)) if case == "buy" else (rents[0] > FAST["relay_threshold"])


def test_worldview_and_heartbeat_funnel_match_jax():
    from adapcc_tpu.elastic.worldview import WorldView as JaxWorldView
    from adapcc_tpu.elastic.worldview import slow_ranks_from_medians as jax_slow

    port, ref = WorldView.full(6), JaxWorldView.full(6)
    for step in (lambda v: v.with_down([5]), lambda v: v.with_relays([1, 5]), lambda v: v.with_alive([0, 1, 2]),
                 lambda v: v.with_relays([2]), lambda v: v.with_recovered([5]), lambda v: v.with_relays([2])):
        port, ref = step(port), step(ref)
        assert (port.alive, port.relays, port.epoch, port.active_list()) == (
            ref.alive, ref.relays, ref.epoch, ref.active_list())
        assert np.array_equal(port.mask(), ref.mask())
    medians = {0: 1.0, 1: 1.1, 2: 3.5, 3: 0.9}
    assert slow_ranks_from_medians(medians, factor=2.0) == jax_slow(medians, factor=2.0) == frozenset({2})
    lg_port, lg_ref = _logics(4)
    for lg in (lg_port, lg_ref):
        lg.heartbeat_arrive(1, median_s=0.25, now=5.0)
        lg.heartbeat_arrive(1, now=6.0)
        lg.observe_step_medians(medians)
    assert lg_port.heartbeat_snapshot() == lg_ref.heartbeat_snapshot()
    assert lg_port.worldview().relays == lg_ref.worldview().relays == frozenset({2})


class _OrderedArrivals:
    """A probe's ``hook_arrive`` with each step's arrivals ordered: the
    on-time ranks pass one barrier together, the slow ones wait until an
    on-time rank's arrival has returned (the step froze without them), so
    the emulation's verdict does not hang on the scheduler's load."""

    def __init__(self, probe, world, steps, slow):
        self.probe, self.slow = probe, set(slow)
        self.together = threading.Barrier(world - len(self.slow))
        self.frozen = [threading.Event() for _ in range(steps)]

    def hook_arrive(self, step, rank):
        if rank in self.slow:
            assert self.frozen[step].wait(timeout=10)
            return self.probe.hook_arrive(step, rank)
        self.together.wait(timeout=10)
        out = self.probe.hook_arrive(step, rank)
        self.frozen[step].set()
        return out

    def wait_time(self, step):
        return self.probe.wait_time(step)


def test_wait_time_probe_with_a_slow_rank():
    """Eight emulated participants, rank 3 slow: the probe's per-step skew
    and the logic's frozen lists leave rank 3 out, as JAX's do."""
    from adapcc_tpu.measure import WaitTimeProbe as JaxProbe
    from adapcc_tpu.measure import emulate_heterogeneous_steps as jax_emulate

    results = {}
    for name, probe_cls, emulate, lg in (("port", WaitTimeProbe, emulate_heterogeneous_steps, _logics(8)[0]),
                                         ("jax", JaxProbe, jax_emulate, _logics(8)[1])):
        probe = probe_cls(lg)
        with _SteppedClock(lg, 7).installed():
            waits = emulate(_OrderedArrivals(probe, 8, 2, (3,)), 8, 2, base_compute_s=0.002, heter_alpha=100.0,
                            slow_ranks=(3,))
        results[name] = ([lg.active_list(s) for s in range(2)], waits, probe.steps())
    for name, (frozen, waits, steps) in results.items():
        assert [sorted(f) for f in frozen] == [[0, 1, 2, 4, 5, 6, 7]] * 2, name
        assert all(w >= 0.15 for w in waits) and steps == [0, 1], (name, waits)


# --------------------------------------------------------------------------- #
# gRPC wire compatibility
# --------------------------------------------------------------------------- #


def test_protocol_descriptor_is_the_jax_packages():
    from adapcc_tpu.coordinator.protocol import coordinator_pb2 as jax_pb

    from adapcc_tpu_torch.coordinator.protocol import coordinator_pb2 as pb

    assert pb.DESCRIPTOR.name == jax_pb.DESCRIPTOR.name == "coordinator.proto"
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    msg = pb.cont_request(step=7, world_rank=3).SerializeToString()
    assert jax_pb.cont_request.FromString(msg).step == 7


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_grpc_clients_and_servers_cross(server_side):
    """Hooker, Controller and HeartbeatClient of one package against the
    other's CoordinatorServer: a straggler demoted, the controller barrier's
    status, a heartbeat's alive list."""
    from adapcc_tpu import coordinator as jax_coord

    from adapcc_tpu_torch import coordinator as port_coord

    server_mod, client_mod = (jax_coord, port_coord) if server_side == "jax" else (port_coord, jax_coord)
    logic = server_mod.CoordinatorLogic(3, **FAST)
    server = server_mod.CoordinatorServer(3, port=0, logic=logic).start()
    clients = []
    try:
        hookers = [client_mod.Hooker("127.0.0.1", server.port) for _ in range(3)]
        controllers = [client_mod.Controller("127.0.0.1", server.port) for _ in range(3)]
        clients += hookers + controllers

        # rank 2 arrives after the step froze without it: a relay
        hooks = _late_rank_workers(3, 2, lambda r: sorted(hookers[r].send_ready_request(0, r)))
        conts = _run_workers(3, lambda r: controllers[r].send_relay_request(0, r))
        out = {r: (hooks[r], conts[r]) for r in range(3)}
        for r in range(3):
            active, (cont_active, status) = out[r]
            assert active == [0, 1] and sorted(cont_active) == [0, 1] and status == 1
        beat = client_mod.HeartbeatClient("127.0.0.1", server.port, rank=1)
        clients.append(beat)
        assert beat.beat(median_s=0.5) == ([0, 1, 2], 0)
        assert logic.heartbeat_snapshot()[1]["median_s"] == 0.5
    finally:
        for c in clients:
            c.close()
        server.stop()


def test_client_against_a_dead_coordinator_raises_unavailable(monkeypatch):
    from adapcc_tpu_torch.coordinator import CoordinatorUnavailable, Hooker, rpc_timeout_s

    monkeypatch.setenv("ADAPCC_RPC_TIMEOUT_S", "0.3")
    assert rpc_timeout_s() == 0.3
    hooker = Hooker("127.0.0.1", _free_port())
    try:
        t0 = time.monotonic()
        with pytest.raises(CoordinatorUnavailable, match="unreachable|unresponsive"):
            hooker.send_ready_request(0, 0)
        assert time.monotonic() - t0 < 3
    finally:
        hooker.close()
    monkeypatch.setenv("ADAPCC_RPC_TIMEOUT_S", "soon")
    with pytest.raises(ValueError, match="expected a number"):
        rpc_timeout_s()


# --------------------------------------------------------------------------- #
# the Communicator's coordinator plane and the trainer's rules
# --------------------------------------------------------------------------- #


def _two_host_profile(topo):
    with open(topo / "ip_table.txt", "w") as f:
        f.write("\n".join(["10.0.0.1", "10.0.0.1", "10.0.0.2", "10.0.0.2"]))
    with open(topo / "topo_profile_0", "w") as f:
        for s in range(4):
            for d in range(4):
                if s != d:
                    f.write(f"{s},{d},lat,0.00001\n{s},{d},bw,{100.0 if (s < 2) == (d < 2) else 10.0}\n")


def test_communicator_coordinator_plane_and_calibration_match_jax(tmp_path, mesh4):
    from adapcc_tpu.communicator import Communicator as JaxCommunicator
    from adapcc_tpu.config import CommArgs as JaxCommArgs

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for side in ("port", "jax"):
        _two_host_profile(tmp_path / side)
    port = Communicator(_args(tmp_path / "port"), world_size=4, device="cpu")
    ref = JaxCommunicator(JaxCommArgs(**vars(_args(tmp_path / "jax"))), mesh=mesh4)
    assert port.ip_table == ref.ip_table and port.calibrate_coordinator(1e6) is ref.calibrate_coordinator(1e6) is False
    for comm in (port, ref):
        comm.enable_coordinator(is_master=True, process_rank=0, num_processes=2, port=0)
    try:
        assert port.calibrate_coordinator(100e6) is ref.calibrate_coordinator(100e6) is True
        pl, rl = port._coordinator_server.logic, ref._coordinator_server.logic
        assert (pl.accumulated_size, pl.accumulated_bandwidth) == (rl.accumulated_size, rl.accumulated_bandwidth)
        assert pl.accumulated_bandwidth == pytest.approx(2 * 10.0)  # inter-process links only
    finally:
        port.clear()
        ref.clear()
    # a sole process: the negotiated list, the controller's, the latency file
    port.enable_coordinator(is_master=True, process_rank=0, num_processes=1, port=0)
    try:
        port.update_relay(0)
        assert port.hook_ready(0) == [0] and port.chips_of_processes([0]) == [0, 1, 2, 3]
        deadline = time.time() + 2
        while port.relay_active_list(0) is None and time.time() < deadline:
            time.sleep(0.01)
        assert port.relay_active_list(0) == [0] and port.fault_worker_list == []
        path = port.write_rpc_latency()
        assert len(open(path).read().split()) == 1 and path.endswith("latency_0.0.txt")
    finally:
        port.clear()
    assert port._controller_thread is None and port._coordinator_server is None


def test_hook_ready_without_a_coordinator_follows_the_jax_rules(tmp_path, monkeypatch):
    """An unreachable coordinator: a sole process goes on alone and says so;
    in a multi-process world picking an active set alone raises."""
    monkeypatch.setenv("ADAPCC_RPC_TIMEOUT_S", "0.2")
    dead = _free_port()
    comm = Communicator(_args(tmp_path), world_size=2, device="cpu")
    comm.enable_coordinator(is_master=False, process_rank=0, num_processes=1, port=dead)
    try:
        assert comm.hook_ready(0) == [0] and comm.coordinator_unreachable
    finally:
        comm.clear()
    comm.enable_coordinator(is_master=False, process_rank=1, num_processes=2, port=dead)
    try:
        with pytest.raises(RuntimeError, match="unilaterally"):
            comm.hook_ready(0)
    finally:
        comm.clear()
    with pytest.raises(RuntimeError, match="enable_coordinator first"):
        comm.start_heartbeat()


def test_trainer_coordinator_rules_and_first_step_calibration(tmp_path):
    """A communicator implies a dynamic mask; dynamic_mask=False with one
    raises; a step pushes the gradient volume into the server's rent-or-buy
    model until one succeeds (no profile yet: the defaults stay), then
    latches."""
    from adapcc_tpu_torch.strategy.ir import Strategy

    world = build_world_mesh(1, device="cpu")
    try:
        comm = Communicator(_args(tmp_path), world_size=4, device="cpu")
        loss = lambda m, b: (m(b) ** 2).mean()  # noqa: E731
        with pytest.raises(ValueError, match="dynamic-mask"):
            DDPTrainer(loss, adamw(LR), world, Strategy.ring(1), communicator=comm, dynamic_mask=False)
        comm.enable_coordinator(is_master=True, process_rank=0, num_processes=1, port=0)
        try:
            trainer = DDPTrainer(loss, adamw(LR), world, Strategy.ring(1), communicator=comm)
            assert trainer._dynamic_mask
            state = TrainState.create(torch.nn.Linear(4, 2), trainer.tx)
            logic = comm._coordinator_server.logic
            default = logic.accumulated_size
            trainer.step(state, torch.ones(3, 4))
            assert not trainer._coord_calibrated and logic.accumulated_size == default
            with open(tmp_path / "topo_profile_0", "w") as f:
                for s in range(4):
                    for d in range(4):
                        if s != d:
                            f.write(f"{s},{d},lat,0.00001\n{s},{d},bw,25.0\n")
            trainer.step(state, torch.ones(3, 4))
            assert trainer._coord_calibrated
            assert logic.accumulated_size == pytest.approx(40 / 1e9)  # Linear(4, 2): 10 float32
            assert logic.accumulated_bandwidth == pytest.approx(25.0)  # one process
            logic.calibrate(1.0, 1.0)
            trainer.step(state, torch.ones(3, 4))
            assert logic.accumulated_size == 1e-9  # latched: not pushed again
        finally:
            comm.clear()
    finally:
        destroy_world()


# --------------------------------------------------------------------------- #
# a negotiated DDP step, world 2 over gloo
# --------------------------------------------------------------------------- #

#: two steps, as test_torch_ddp.py's world-2 masked runs, whose tolerances
#: these are: after one Adam step the two frameworks' losses already differ
#: by a few float32 ulps (Adam turns rounding noise in near-zero gradients
#: into steps of ±lr); rank 1 is late at the second step, so the demotion
#: shows in the parameters, held to a tenth of lr
STEPS = 2
SLOW_STEP = 1
#: how long the sole leader waits for a peer before freezing alone (the
#: logic's fault_timeout, cut as fast_logic cuts it), and rank 1's delay
SOLE_LEADER_TIMEOUT_S = 0.4
SLOW_DELAY_S = 1.2


def _negotiated_rank(rank, init_method, topo, state_dict, tokens):
    """One rank: a coordinator-attached trainer; returns its per-step
    negotiated masks, losses and final state dict."""
    import torch.distributed as dist

    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    comm = Communicator(_args(topo / f"rank{rank}"), world=world)
    try:
        port = [None]
        if rank == 0:
            comm.enable_coordinator(is_master=True, process_rank=0, num_processes=2, port=0)
            comm._coordinator_server.logic.fault_timeout = SOLE_LEADER_TIMEOUT_S
            port = [comm._coordinator_server.port]
        dist.broadcast_object_list(port, src=0)
        if rank == 1:
            comm.enable_coordinator(is_master=False, process_rank=1, num_processes=2, port=port[0])
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=None)
        model.load_state_dict(state_dict)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, comm.strategy, communicator=comm)
        masks, negotiate = [], trainer.hook.negotiate
        trainer.hook.negotiate = lambda step: masks.append(negotiate(step)) or masks[-1]
        state = TrainState.create(model, trainer.tx)
        batch = torch.from_numpy(tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH])
        losses = []
        dist.barrier()
        for step in range(STEPS):
            if rank == 1 and step == SLOW_STEP:
                time.sleep(SLOW_DELAY_S)
            state, loss = trainer.step(state, batch)
            losses.append(loss.item())
        dist.barrier()
        return ([m.tolist() for m in masks], np.array(losses),
                {k: v.detach().numpy() for k, v in model.state_dict().items()})
    finally:
        if rank == 1:
            comm.clear()
        dist.barrier()
        comm.clear()
        destroy_world()


def _negotiated_child(*args):
    torch.set_num_threads(1)
    return _negotiated_rank(*args)


def _jax_masked_run(params, tokens, masks, ips):
    """Per-step ``[world]`` losses and final params of the JAX trainer with
    ``masks`` as its explicit per-step active masks."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.ddp import TrainState as JaxTrainState
    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:2], ("ranks",))
    trainer = JaxDDPTrainer(lambda p, b: jax_lm_loss(model.apply(p, b), b), optax.adamw(LR), mesh,
                            JaxStrategy.ring(2, 1, ips), dynamic_mask=True)
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    state = jax.device_put(JaxTrainState.create(params, trainer.tx), NamedSharding(mesh, P()))
    losses = []
    for mask in masks:
        state, loss = trainer.step(state, batch, active_mask=jnp.asarray(mask))
        losses.append(np.asarray(loss))
    return np.stack(losses, axis=1), flax_to_state_dict(jax.device_get(state.params))


def test_negotiated_ddp_step_demotes_a_straggler_and_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, TINY["vocab_size"], size=(2 * PER_RANK_BATCH, TINY["max_seq"]))
    params = _flax_params()
    sd = flax_to_state_dict(params)
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_negotiated_child, (1, init_method, tmp_path, sd, tokens))
        per_rank = [_negotiated_rank(0, init_method, tmp_path, sd, tokens), pending.get(timeout=120)]
    masks = per_rank[0][0]
    assert per_rank[1][0] == masks  # both ranks ran every step under one mask
    want = [[True, True]] * STEPS
    want[SLOW_STEP] = [True, False]  # the late rank 1 was demoted to a relay
    assert masks == want
    ips = {0: "process-0", 1: "process-1"}  # the communicator's strategy: one host a process
    losses_j, params_j = _jax_masked_run(params, tokens, masks, ips)
    for rank in range(2):
        _, losses_t, params_t = per_rank[rank]
        np.testing.assert_allclose(losses_t, losses_j[rank], atol=LOSS_ATOL, err_msg=f"rank {rank}")
        _assert_params_close(params_t, params_j)
    # the comparison sees the demotion: the full world's parameters differ
    _, params_full = _jax_masked_run(params, tokens, [[True, True]] * STEPS, ips)
    with pytest.raises(AssertionError):
        _assert_params_close(per_rank[0][2], params_full)
