"""The port's AdapCC façade and Communicator held against the JAX package's.

- The port's DETECT bootstrap runs end to end at world 8 on the CPU and
  leaves the artifacts the JAX one leaves.
- The profiles are timings, so two bootstraps may synthesize different
  trees: the bit-for-bit comparison runs both façades on one strategy, the
  XML that the JAX DETECT bootstrap wrote on the 8-device CPU mesh, copied
  into the port's directory and loaded with ``SKIP_BOOTSTRAP``.
- ``python -m adapcc_tpu_torch.api --device cpu`` reproduces the golden log
  ``log/primitive`` line for line, as ``tests/test_smoke_golden.py`` holds
  the JAX package's.

The JAX package is imported inside the functions that use it.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.api import AdapCC
from adapcc_tpu_torch.comm.mesh import World
from adapcc_tpu_torch.communicator import Communicator
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.primitives import (
    ALLREDUCE,
    ALLTOALL,
    BOARDCAST,
    DETECT,
    PROFILE,
    REDUCE,
    SKIP_BOOTSTRAP,
    ReduceOp,
)
from adapcc_tpu_torch.strategy import xml_io

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
RELAY = [r for r in range(WORLD) if r != 3]


def _args(topo, entry=SKIP_BOOTSTRAP, **kw):
    topo = pathlib.Path(topo)
    return CommArgs(strategy_file=str(topo / "strategy.xml"), logical_graph=str(topo / "logical_graph.xml"),
                    topology_dir=str(topo), entry_point=entry, **kw)


def _bits(x) -> bytes:
    """Raw bytes of a torch or JAX array, bfloat16 included."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.contiguous().numpy().tobytes()
    arr = np.asarray(x)
    return (arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr).tobytes()


@pytest.fixture(scope="module")
def jax_detected(tmp_path_factory, mesh8):
    """The JAX package's DETECT bootstrap on the 8-device CPU mesh: its
    topology directory, its façade left set up for ALLREDUCE, REDUCE,
    BOARDCAST and ALLTOALL on the strategy it synthesized, and the JAX
    CommArgs class."""
    from adapcc_tpu.api import AdapCC as JaxAdapCC
    from adapcc_tpu.config import CommArgs as JaxCommArgs

    topo = tmp_path_factory.mktemp("jax_topology")
    JaxAdapCC.init(JaxCommArgs(strategy_file=str(topo / "strategy.xml"),
                               logical_graph=str(topo / "logical_graph.xml"), topology_dir=str(topo),
                               entry_point=DETECT, parallel_degree=2, use_xla_fastpath=False), mesh=mesh8)
    for prim in (ALLREDUCE, REDUCE, BOARDCAST, ALLTOALL):
        JaxAdapCC.setup(prim)
    yield topo, JaxAdapCC
    for prim in (ALLREDUCE, REDUCE, BOARDCAST, ALLTOALL):
        JaxAdapCC.communicator.exit_threads(prim)
    JaxAdapCC.communicator.clear()


@pytest.fixture
def port_on_jax_strategy(tmp_path, jax_detected):
    """The port's façade at world 8 on the CPU, on the JAX bootstrap's
    strategy (copied in), the fast path off as in the JAX façade."""
    topo, _ = jax_detected
    shutil.copy(topo / "strategy.xml", tmp_path / "strategy.xml")
    AdapCC.init(_args(tmp_path, use_xla_fastpath=False), world_size=WORLD, device="cpu")
    for prim in (ALLREDUCE, REDUCE, BOARDCAST, ALLTOALL):
        AdapCC.setup(prim)
    yield AdapCC
    AdapCC.clear(ALLREDUCE)


def test_detect_bootstrap_runs_end_to_end_at_world_8(tmp_path, jax_detected):
    """``AdapCC.init(DETECT)``: ip table, per-host shard, logical graph (the
    JAX bootstrap's bytes), a profile CSV and a strategy both parsers
    accept; then an allreduce on it."""
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    jax_topo, _ = jax_detected
    AdapCC.init(_args(tmp_path, DETECT, parallel_degree=2), world_size=WORLD, device="cpu")
    try:
        assert AdapCC.world_size == WORLD and AdapCC.communicator.device == torch.device("cpu")
        for name in ("ip_table.txt", "topo_detect_0.xml", "logical_graph.xml"):
            assert (tmp_path / name).read_bytes() == (jax_topo / name).read_bytes(), name
        rows = (tmp_path / "topo_profile_0").read_text().splitlines()
        assert len(rows) == 2 * WORLD * (WORLD - 1)
        assert all(float(r.split(",")[3]) > 0 for r in rows)
        port_s = xml_io.parse_strategy_xml(str(tmp_path / "strategy.xml"))
        ref_s = jax_parse(str(tmp_path / "strategy.xml"))
        assert port_s.synthesis == ref_s.synthesis == "partrees" and port_s.world_size == ref_s.world_size == WORLD
        for t, r in zip(port_s.trees, ref_s.trees, strict=True):
            assert (t.root, t.children) == (r.root, r.children)
        assert AdapCC.communicator.strategy.fingerprint() == port_s.fingerprint()
        AdapCC.setup(ALLREDUCE)
        x = torch.stack([torch.full((16,), float(r + 1)) for r in range(WORLD)])
        assert torch.equal(AdapCC.allreduce(x), torch.full((WORLD, 16), 36.0))
        assert torch.equal(AdapCC.allreduce(x, active_gpus=RELAY), torch.full((WORLD, 16), 32.0))
    finally:
        AdapCC.clear(ALLREDUCE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("active", [None, "relay"])
def test_facade_allreduce_is_jax_bit_for_bit(port_on_jax_strategy, jax_detected, dtype, op, active):
    import jax.numpy as jnp

    from adapcc_tpu.primitives import ReduceOp as JaxOp

    _, jax_adapcc = jax_detected
    x = np.random.default_rng(3).standard_normal((WORLD, 1003)).astype(np.float32)
    active_gpus = RELAY if active else None
    got = port_on_jax_strategy.allreduce(torch.from_numpy(x).to(getattr(torch, dtype)), active_gpus=active_gpus,
                                         op=getattr(ReduceOp, op))
    want = jax_adapcc.allreduce(jnp.asarray(x, getattr(jnp, dtype)), active_gpus=active_gpus, op=getattr(JaxOp, op))
    assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype)
    assert _bits(got) == _bits(want)
    assert all(torch.equal(got[r], got[0]) for r in range(WORLD))


def test_facade_reduce_boardcast_alltoall_match_jax(port_on_jax_strategy, jax_detected):
    import jax.numpy as jnp

    from adapcc_tpu.primitives import ReduceOp as JaxOp

    _, jax_adapcc = jax_detected
    rng = np.random.default_rng(4)
    x = rng.standard_normal((WORLD, 517)).astype(np.float32)
    for active in (None, RELAY):
        for op in ("SUM", "MAX"):
            got = port_on_jax_strategy.reduce(torch.from_numpy(x), active_gpus=active, op=getattr(ReduceOp, op))
            want = jax_adapcc.reduce(jnp.asarray(x), active_gpus=active, op=getattr(JaxOp, op))
            assert _bits(got) == _bits(want), (active, op)
        assert _bits(port_on_jax_strategy.boardcast(torch.from_numpy(x), active_gpus=active)) == _bits(
            jax_adapcc.boardcast(jnp.asarray(x), active_gpus=active))
    a2a = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    for active in (None, RELAY):
        assert _bits(port_on_jax_strategy.alltoall(torch.from_numpy(a2a), active_gpus=active)) == _bits(
            jax_adapcc.alltoall(jnp.asarray(a2a), active_gpus=active))


def test_no_context_before_setup_and_positional_op_refused(tmp_path):
    AdapCC.init(_args(tmp_path), world_size=4, device="cpu")
    x = torch.ones(4, 8)
    with pytest.raises(RuntimeError, match="no context for primitive 0"):
        AdapCC.allreduce(x)
    AdapCC.setup(ALLREDUCE)
    comm = AdapCC.communicator
    with pytest.raises(TypeError, match="op= by keyword"):
        comm.all_reduce(x, ReduceOp.AVG)
    with pytest.raises(TypeError, match="op= by keyword"):
        comm.reduce(x, None, ReduceOp.MAX)
    # no strategy file: the default ring over the world's ip table
    assert comm.strategy.synthesis == "ring" and comm.strategy.trees[0].ips[3] == "process-0"
    assert torch.equal(AdapCC.allreduce(x, op=ReduceOp.AVG), x)
    AdapCC.clear(ALLREDUCE)
    assert comm.active_contexts() == []
    with pytest.raises(ValueError, match="no supported entry point"):
        AdapCC.init(_args(tmp_path, entry=5), world_size=4, device="cpu")


def test_reconstruct_topology_re_adapts_and_rebuilds_the_context(tmp_path):
    """``reconstruct_topology`` clears, re-runs the bootstrap (here PROFILE
    over a logical graph the first DETECT wrote) and sets the context up
    again on the same world and device."""
    args = _args(tmp_path, DETECT)
    AdapCC.init(args, world_size=4, device="cpu")
    AdapCC.setup(ALLREDUCE)
    first = AdapCC.communicator
    (tmp_path / "topo_profile_0").unlink()
    AdapCC.set_profile_freq(10)
    AdapCC.reconstruct_topology(_args(tmp_path, PROFILE), ALLREDUCE)
    try:
        comm = AdapCC.communicator
        assert comm is not first and first.active_contexts() == [] and comm.active_contexts() == [ALLREDUCE]
        assert (comm.world_size, comm.device) == (4, torch.device("cpu")) and AdapCC.world_size == 4
        assert (tmp_path / "topo_profile_0").exists()
        x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        assert torch.equal(AdapCC.allreduce(x), x.sum(0).expand(4, 3))
    finally:
        AdapCC.clear(ALLREDUCE)


def test_communicator_raises_for_what_waits(tmp_path, monkeypatch):
    comm = Communicator(_args(tmp_path), world_size=2, device="cpu")
    # the supervisor runs now (tests/test_torch_supervisor.py); it needs the
    # engine of a set-up primitive
    with pytest.raises(RuntimeError, match="no context"):
        comm.supervisor()
    # so does the adaptation controller (tests/test_torch_adapt.py)
    with pytest.raises(RuntimeError, match="no context"):
        comm.adaptation_controller()
    # the tuner runs now (tests/test_torch_tuner.py): every mode builds, a
    # malformed one raises
    assert comm.tuner is not None and comm.tuner.world == 2
    for mode in ("record", "choose", "off"):
        monkeypatch.setenv("ADAPCC_TUNER", mode)
        assert Communicator(_args(tmp_path), world_size=2, device="cpu").tuner.mode == mode
    monkeypatch.setenv("ADAPCC_TUNER", "chose")
    with pytest.raises(ValueError, match="ADAPCC_TUNER"):
        Communicator(_args(tmp_path), world_size=2, device="cpu")
    monkeypatch.setenv("ADAPCC_TUNER", "off")
    # a process group of one process a rank: SKIP_BOOTSTRAP works, the
    # DETECT/PROFILE bootstrap waits for the per-process slice
    (tmp_path / "mp").mkdir()
    mp = Communicator(_args(tmp_path / "mp"), world=World(rank=1, world_size=2, device=torch.device("cpu")))
    assert mp.world_size == 2 and mp.ip_table == ["process-0", "process-1"]
    assert mp.chips_of_processes([1]) == [1] and comm.chips_of_processes([0]) == [0, 1]
    for prim in (DETECT, PROFILE):
        with pytest.raises(NotImplementedError, match="per-process slice"):
            mp.init_threads(prim)
    with pytest.raises(ValueError, match="process group of 2"):
        Communicator(_args(tmp_path / "mp"), world_size=4, world=World(0, 2, torch.device("cpu")))


def test_smoke_benchmark_matches_golden():
    out = subprocess.run([sys.executable, "-m", "adapcc_tpu_torch.api", "--device", "cpu"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = [line for line in out.stdout.splitlines() if line.strip()]
    golden = [line for line in (REPO / "log" / "primitive").read_text().splitlines() if line.strip()]
    assert got == golden
