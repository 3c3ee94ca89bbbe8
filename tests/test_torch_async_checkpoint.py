"""The port's async checkpoints, elastic restore and sharded saves held
against the JAX package's.

- JAX's ``AsyncCheckpointManager`` scenarios (tests/test_checkpoint.py:
  round trip and retention, the async pipeline's point-in-time snapshot,
  a pipeline error raised at the next call, a truncated blob, a bit flip, a
  missing shard or manifest, a manifest that is not JSON or lacks its
  table, republishing over a corrupt step but never a good one, a torn tmp
  directory, keep-last-good retention) run on both managers, each with its
  own blob (the port's ``state.ckpt``, JAX's ``state.msgpack``): the same
  verdicts, step lists, restored epochs and exception types.  Messages
  name checksums and sizes of different bytes, so they are compared as
  far as they name no number.
- ``restore_newest_across_processes`` at gloo world 2 (rank 0 here, rank 1
  spawned): the rank behind adopts the newest epoch through the process
  group's key-value store (the blob cut into 2 KiB values here), keys live
  under the generation's namespace, and a peer that never publishes makes
  the fetch raise ``CoordinatorUnavailable`` within ``ADAPCC_RPC_TIMEOUT_S``.
- ``run_elastic`` with an injected ``_spawn`` gives JAX's calls and return
  codes; the ``ADAPCC_ASYNC_CKPT`` funnel JAX's answers.
- ``CheckpointManager.save_sharded`` writes one file a rank;
  ``restore_sharded`` gives a rank its own shard under the same world, and
  under another world the rows JAX's ``rebalance_zero1_pair`` makes of the
  same state.
"""

import multiprocessing
import os
import re

import numpy as np
import pytest
import torch

from adapcc_tpu_torch import checkpoint as ckpt
from adapcc_tpu_torch.checkpoint import (
    AsyncCheckpointManager,
    CheckpointCorrupt,
    CheckpointManager,
    TrainCheckpointState,
    async_checkpointing_enabled,
    restore_newest_across_processes,
    run_elastic,
    save_checkpoint,
)
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from test_torch_ddp import _free_port


def _port_params(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": torch.from_numpy((rng.normal(size=(4, 3)) * scale).astype(np.float32))},
            "bias": torch.zeros(3)}


def _jax_params(seed=0, scale=1.0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": jnp.asarray(rng.normal(size=(4, 3)) * scale, jnp.float32)},
            "bias": jnp.zeros((3,), jnp.float32)}


class _Side:
    """One package's manager, state and blob, for the scenarios."""

    def __init__(self, name):
        if name == "port":
            self.mgr_cls, self.corrupt, self.blob = AsyncCheckpointManager, CheckpointCorrupt, ckpt.BLOB_NAME
            self.state_cls, self.params = TrainCheckpointState, _port_params
        else:
            from adapcc_tpu.checkpoint import AsyncCheckpointManager as JMgr
            from adapcc_tpu.checkpoint import CheckpointCorrupt as JCorrupt
            from adapcc_tpu.checkpoint import TrainCheckpointState as JState

            self.mgr_cls, self.corrupt, self.blob = JMgr, JCorrupt, "state.msgpack"
            self.state_cls, self.params = JState, _jax_params

    def state(self, seed=0, scale=1.0, epoch=0, step=0):
        return self.state_cls(params=self.params(seed=seed, scale=scale), epoch=epoch, step=step)


def _verdict(fn):
    """``fn()``'s value, or its exception's type and message with every
    number and hex digest taken out."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the verdict is the point
        return (type(e).__name__, re.sub(r"[0-9a-f]{12}…|\d+", "#", str(e)))


def _kernel(state):
    return np.asarray(state.params["dense"]["kernel"]).tolist()


def _scenario_roundtrip(side, d):
    mgr = side.mgr_cls(str(d), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, side.state(scale=float(step), epoch=step, step=step))
    s, s2 = side.state(seed=9), side.state(seed=10)
    out = [mgr.latest_step(), mgr.published_steps(), mgr.restore(s), s.epoch, s.step, _kernel(s),
           mgr.restore(s2, step=2), s2.epoch, _verdict(lambda: mgr.restore(side.state(), step=7))]
    mgr.close()
    return out


def _scenario_async_pipeline(side, d):
    mgr = side.mgr_cls(str(d), max_to_keep=8)
    s = side.state(scale=1.0, epoch=1, step=1)
    mgr.save_async(1, s)
    s.epoch = 99
    mgr.save_async(2, s)
    mgr.wait()
    back = side.state(seed=3)
    out = [mgr.published_steps(), _verdict(lambda: mgr.verify(1)), _verdict(lambda: mgr.verify(2)),
           mgr.restore(back, step=1), back.epoch, mgr.restore(back, step=2), back.epoch, mgr.torn_saves()]
    mgr.close()
    return out


def _scenario_pipeline_error(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(5, side.state(epoch=5))
    mgr.save_async(5, side.state(epoch=6))
    out = [_verdict(mgr.wait)]
    mgr.save(6, side.state(epoch=6))
    return out + [mgr.latest_step()]


def _scenario_truncated(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    blob = d / "step-1" / side.blob
    blob.write_bytes(blob.read_bytes()[:-7])
    return [_verdict(lambda: mgr.restore(side.state(seed=2))), mgr.latest_good_step()]


def _scenario_bitflip(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    blob = d / "step-1" / side.blob
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blob.write_bytes(bytes(raw))
    return [_verdict(lambda: mgr.restore(side.state(seed=2)))]


def _scenario_missing(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    os.remove(d / "step-1" / side.blob)
    out = [_verdict(lambda: mgr.restore(side.state(seed=2)))]
    mgr.save(2, side.state(epoch=2))
    os.remove(d / "step-2" / "MANIFEST.json")
    return out + [_verdict(lambda: mgr.restore(side.state(seed=3)))]


def _scenario_manifest_json(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    mgr.save(2, side.state(epoch=2))
    man = d / "step-2" / "MANIFEST.json"
    man.write_text(man.read_text()[:-9] + "garbage")
    out = [_verdict(lambda: mgr.verify(2))[0], mgr.latest_good_step()]
    man.write_text('{"version": 1, "step": 2}')
    return out + [_verdict(lambda: mgr.verify(2)), mgr.latest_good_step()]


def _scenario_republish(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    mgr.save(2, side.state(epoch=2))
    blob = d / "step-2" / side.blob
    blob.write_bytes(blob.read_bytes()[:-7])
    out = [mgr.latest_good_step()]
    mgr.save(2, side.state(epoch=2))
    got = side.state(seed=9)
    out += [mgr.latest_good_step(), mgr.restore(got), got.epoch]

    def republish_good():
        mgr.save_async(2, side.state(epoch=3))
        mgr.wait()

    return out + [_verdict(republish_good)]


def _scenario_torn(side, d):
    mgr = side.mgr_cls(str(d))
    mgr.save(1, side.state(epoch=1))
    torn = d / ".tmp-step-2-12345"
    torn.mkdir()
    (torn / side.blob).write_bytes(b"half-writ")
    s = side.state(seed=4)
    return [mgr.published_steps(), mgr.torn_saves(), mgr.restore(s), s.epoch]


def _scenario_retention(side, d):
    mgr = side.mgr_cls(str(d), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, side.state(epoch=step))
    out = [mgr.published_steps()]
    blob = d / "step-3" / side.blob
    raw = bytearray(blob.read_bytes())
    raw[0] ^= 0xFF
    blob.write_bytes(bytes(raw))
    mgr.save(4, side.state(epoch=4))
    out.append(mgr.published_steps())
    blob4 = d / "step-4" / side.blob
    raw4 = bytearray(blob4.read_bytes())
    raw4[1] ^= 0xFF
    blob4.write_bytes(bytes(raw4))
    s = side.state(seed=6)
    return out + [_verdict(lambda: mgr.restore(side.state(seed=5)))[0], mgr.latest_good_step(),
                  mgr.restore(s, step=mgr.latest_good_step()), s.epoch]


SCENARIOS = [_scenario_roundtrip, _scenario_async_pipeline, _scenario_pipeline_error, _scenario_truncated,
             _scenario_bitflip, _scenario_missing, _scenario_manifest_json, _scenario_republish, _scenario_torn,
             _scenario_retention]


def _run(scenario, name, d):
    """The scenario's outputs with the side's blob name and directory
    replaced by placeholders."""
    side = _Side(name)

    def norm(x):
        if isinstance(x, str):
            # _verdict already took the numbers out of the directory
            return x.replace(side.blob, "<blob>").replace(re.sub(r"\d+", "#", str(d)), "<dir>")
        if isinstance(x, (list, tuple)):
            return type(x)(norm(v) for v in x)
        return x

    return norm(scenario(side, d))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[10:])
def test_async_manager_scenarios_match_jax(tmp_path, scenario, capsys):
    port = _run(scenario, "port", tmp_path / "port")
    port_err = capsys.readouterr().err
    jax_out = _run(scenario, "jax", tmp_path / "jax")
    jax_err = capsys.readouterr().err
    assert port == jax_out
    assert ("failed verification" in port_err) == ("failed verification" in jax_err)
    assert ("replacing the corrupt artifact" in port_err) == ("replacing the corrupt artifact" in jax_err)


def test_async_snapshot_is_a_copy_and_the_manager_names_corruption():
    """``save_async``'s snapshot owns its tensors (the loop updates the
    live ones in place at once); ``CheckpointCorrupt`` is a ``ValueError``."""
    live = {"w": torch.ones(4)}
    snap, event = ckpt._host_snapshot({"state": live, "epoch": 3})
    live["w"].add_(1)
    assert torch.equal(snap["state"]["w"], torch.ones(4)) and snap["epoch"] == 3 and event is None
    assert issubclass(CheckpointCorrupt, ValueError)


def test_async_env_funnel_and_run_elastic_match_jax(monkeypatch):
    from adapcc_tpu.checkpoint import async_checkpointing_enabled as jenabled
    from adapcc_tpu.checkpoint import run_elastic as jrun

    for raw in (None, "on", "off", "1", "TRUE", "sideways"):
        if raw is None:
            monkeypatch.delenv("ADAPCC_ASYNC_CKPT", raising=False)
        else:
            monkeypatch.setenv("ADAPCC_ASYNC_CKPT", raw)
        for explicit in (False, True):
            assert _verdict(lambda: async_checkpointing_enabled(explicit)) == _verdict(lambda: jenabled(explicit))
    for fail_until, restarts in ((3, 3), (99, 2), (1, 0)):
        runs = []
        for fn in (run_elastic, jrun):
            calls = []

            def spawn(cmd, env, calls=calls):
                calls.append((tuple(cmd), env["ADAPCC_RESTART_GEN"], env.get("EXTRA")))
                return 0 if len(calls) >= fail_until else 17

            runs.append((fn(["worker", "--x"], max_restarts=restarts, restart_delay_s=0, env={"EXTRA": "1"},
                            _spawn=spawn), calls))
        assert runs[0] == runs[1]


# --------------------------------------------------------------------------- #
# the elastic restore over a process group
# --------------------------------------------------------------------------- #


def _restore_rank(rank, init_method, directory, timeout_env):
    """One rank of the world-2 restore: rank 0 holds epoch 3, rank 1 epoch
    1; both restore under ``gen="7"``; then rank 0 alone restores under
    ``gen="lonely"``, where rank 1 never publishes."""
    torch.set_num_threads(1)
    os.environ.pop("ADAPCC_RPC_TIMEOUT_S", None)
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    out = {}
    try:
        path = os.path.join(directory, f"rank{rank}.ckpt")
        epoch = 3 if rank == 0 else 1
        save_checkpoint(TrainCheckpointState(params=_port_params(seed=epoch, scale=40.0), epoch=epoch), path)
        state = TrainCheckpointState(params=_port_params(seed=5))
        restore_newest_across_processes(state, path, gen="7")
        out["epoch"], out["kernel"] = state.epoch, _kernel(state)
        store = ckpt._default_store()
        out["keys"] = [store.check([k]) for k in ("adapcc/elastic/rejoin/g7/epoch/0", "adapcc/elastic/g0/epoch/0",
                                                  "adapcc/elastic/rejoin/g7/blob/count")]
        torch.distributed.barrier()
        if rank == 0:
            import time

            from adapcc_tpu_torch.coordinator.service import CoordinatorUnavailable

            # the short budget only here: a loaded machine may keep a live
            # peer's first publish longer than it
            os.environ["ADAPCC_RPC_TIMEOUT_S"] = timeout_env
            t0 = time.monotonic()
            try:
                with pytest.raises(CoordinatorUnavailable, match="epoch of peer 1"):
                    restore_newest_across_processes(TrainCheckpointState(params=_port_params()), path, gen="lonely")
            finally:
                del os.environ["ADAPCC_RPC_TIMEOUT_S"]
            out["dead_s"] = time.monotonic() - t0
        torch.distributed.barrier()
    finally:
        destroy_world()
    return out


def _restore_child(*args):
    return _restore_rank(*args)


def test_restore_newest_across_processes_world2(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "_BLOB_CHUNK_BYTES", 2048)
    monkeypatch.delenv("ADAPCC_RPC_TIMEOUT_S", raising=False)
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_restore_child, (1, init_method, str(tmp_path), "0.5"))
        r0 = _restore_rank(0, init_method, str(tmp_path), "0.5")
        r1 = pending.get(timeout=120)
    newest = _kernel(TrainCheckpointState(params=_port_params(seed=3, scale=40.0)))
    assert (r0["epoch"], r1["epoch"]) == (3, 3) and r0["kernel"] == r1["kernel"] == newest
    assert r0["keys"] == r1["keys"] == [True, False, True]
    assert 0.5 <= r0["dead_s"] < 5.0


def test_restore_newest_alone_is_the_local_load(tmp_path):
    path = str(tmp_path / "one.ckpt")
    save_checkpoint(TrainCheckpointState(params=_port_params(seed=2), epoch=4), path)
    state = TrainCheckpointState(params=_port_params())
    assert restore_newest_across_processes(state, path).epoch == 4 and _kernel(state) == _kernel(
        TrainCheckpointState(params=_port_params(seed=2)))


# --------------------------------------------------------------------------- #
# sharded saves
# --------------------------------------------------------------------------- #


def test_sharded_save_restores_own_rows_and_reshards_like_jax(tmp_path):
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.elastic import rebalance_zero1_pair as jrebalance
    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JZero1

    from adapcc_tpu_torch.ddp.trainer import adamw
    from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer
    from test_torch_zero1_elastic import TINY, _flax_params, _same

    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=0)
    opt = Zero1Optimizer(adamw(1e-3), 4)
    master, _ = opt.init(model)
    rng = np.random.default_rng(4)
    nu = torch.from_numpy(rng.random(master.shape).astype(np.float32)) * (master != 0)
    layout = dict(opt.layout_metadata(), total=opt._meta.total)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for r in range(4):
        mgr.save_sharded(10, {"master": master[r].clone(), "nu": nu[r].clone(), "step": torch.tensor(7.0)},
                         rank=r, world=4, layout=layout)
    assert sorted(os.listdir(tmp_path / "10")) == [f"shard-{r}-of-4.ckpt" for r in range(4)]
    like = {"master": torch.zeros(master.shape[1]), "nu": torch.zeros(master.shape[1]), "step": torch.tensor(0.0)}
    own = mgr.restore_sharded(like, rank=2, world=4, layout=opt.layout_metadata())
    assert _same(own["master"], master[2]) and _same(own["nu"], nu[2]) and float(own["step"]) == 7
    # onto world 2: JAX's re-balance of the same rows
    jopt = JZero1(optax.adam(1e-3), Mesh(jax.devices()[:2], ("ranks",)))
    jm, jnu = jrebalance((master.numpy(), {"nu": nu.numpy()}), _flax_params(), opt.layout_metadata(), jopt)
    target = Zero1Optimizer(adamw(1e-3), 2)
    shard = -(-opt._meta.total // 2)
    for r in range(2):
        got = mgr.restore_sharded({"master": torch.zeros(shard), "nu": torch.zeros(shard), "step": torch.tensor(0.0)},
                                  rank=r, world=2, layout=target.layout_metadata())
        assert _same(got["master"], torch.from_numpy(np.asarray(jm[r]))) and _same(
            got["nu"], torch.from_numpy(np.asarray(jnu["nu"][r])))
    with pytest.raises(ValueError, match="re-splits the rows"):
        mgr.restore_sharded(like, rank=0, world=2)
    # a later save retires the step beyond max_to_keep
    mgr.save_sharded(11, like, rank=0, world=1)
    assert mgr.all_steps() == [11]
