"""The port stands alone: it imports neither JAX nor the JAX package (nor
scipy, which only the MILP solve loads), calls no library attention and no
library collective on its ring, and its entry points run on the card or
raise."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import adapcc_tpu_torch
from adapcc_tpu_torch.comm.mesh import build_world_mesh, resolve_device
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = pathlib.Path(adapcc_tpu_torch.__file__).parent

_CHECK = """
import importlib, pkgutil, sys
import adapcc_tpu_torch
for m in pkgutil.walk_packages(adapcc_tpu_torch.__path__, "adapcc_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "adapcc_tpu", "scipy"))
print("BAD", bad)
print("MODULES", sorted(n for n in sys.modules if n.startswith("adapcc_tpu_torch.")))
"""

#: modules the walk must reach (a renamed module must not drop out unseen)
_PORT_MODULES = (
    "adapcc_tpu_torch.comm.engine", "adapcc_tpu_torch.comm.ring", "adapcc_tpu_torch.ops.flash_attention",
    "adapcc_tpu_torch.parallel.fsdp", "adapcc_tpu_torch.models.convert", "adapcc_tpu_torch.ddp.trainer",
    "adapcc_tpu_torch.quant.codec", "adapcc_tpu_torch.quant.ring", "adapcc_tpu_torch.strategy.ir",
    "adapcc_tpu_torch.strategy.xml_io", "adapcc_tpu_torch.comm.relay", "adapcc_tpu_torch.ddp.bucketing",
    "adapcc_tpu_torch.ddp.hook", "adapcc_tpu_torch.api", "adapcc_tpu_torch.communicator",
    "adapcc_tpu_torch.config", "adapcc_tpu_torch.coordinator.logic", "adapcc_tpu_torch.coordinator.service",
    "adapcc_tpu_torch.coordinator.protocol.coordinator_pb2", "adapcc_tpu_torch.elastic.worldview",
    "adapcc_tpu_torch.measure.wait_time", "adapcc_tpu_torch.topology.detect", "adapcc_tpu_torch.topology.profile",
    "adapcc_tpu_torch.strategy.partrees", "adapcc_tpu_torch.strategy.synthesizer",
    "adapcc_tpu_torch.ddp.overlap", "adapcc_tpu_torch.checkpoint",
    "adapcc_tpu_torch.tuner", "adapcc_tpu_torch.tuner.db", "adapcc_tpu_torch.tuner.measure",
    "adapcc_tpu_torch.tuner.policy", "adapcc_tpu_torch.sim", "adapcc_tpu_torch.sim.cost_model",
    "adapcc_tpu_torch.sim.calibrate", "adapcc_tpu_torch.utils", "adapcc_tpu_torch.utils.observability",
    "adapcc_tpu_torch.comm.latency", "adapcc_tpu_torch.comm.two_level", "adapcc_tpu_torch.strategy.hierarchy",
    "adapcc_tpu_torch.strategy.solver", "adapcc_tpu_torch.compiler", "adapcc_tpu_torch.compiler.ir",
    "adapcc_tpu_torch.compiler.verify", "adapcc_tpu_torch.compiler.builders", "adapcc_tpu_torch.compiler.synthesize",
    "adapcc_tpu_torch.compiler.optimize", "adapcc_tpu_torch.compiler.lower",
    "adapcc_tpu_torch.adapt", "adapcc_tpu_torch.adapt.controller", "adapcc_tpu_torch.adapt.detector",
    "adapcc_tpu_torch.adapt.fabric", "adapcc_tpu_torch.adapt.recalibrate", "adapcc_tpu_torch.adapt.triage",
    "adapcc_tpu_torch.sim.congestion", "adapcc_tpu_torch.strategy.flow_lp", "adapcc_tpu_torch.topology.variability",
    "adapcc_tpu_torch.elastic.redundancy", "adapcc_tpu_torch.elastic.rebalance", "adapcc_tpu_torch.ops.chunked_ce",
    "adapcc_tpu_torch.models.gpt2", "adapcc_tpu_torch.parallel.zero1_rank",
    "adapcc_tpu_torch.pipe", "adapcc_tpu_torch.pipe.schedule", "adapcc_tpu_torch.pipe.partition",
    "adapcc_tpu_torch.pipe.executor", "adapcc_tpu_torch.pipe.forward", "adapcc_tpu_torch.parallel.pipeline",
    "adapcc_tpu_torch.parallel.expert", "adapcc_tpu_torch.models.moe", "adapcc_tpu_torch.workloads.train_moe",
    "adapcc_tpu_torch.models.gpt2_generate", "adapcc_tpu_torch.serve", "adapcc_tpu_torch.serve.trace",
    "adapcc_tpu_torch.serve.kv_cache", "adapcc_tpu_torch.serve.model", "adapcc_tpu_torch.serve.scheduler",
    "adapcc_tpu_torch.serve.disagg", "adapcc_tpu_torch.serve.disagg.cluster", "adapcc_tpu_torch.workloads.serve_gpt2",
)

_CHECK_TUNER = """
import sys
import adapcc_tpu_torch.tuner, adapcc_tpu_torch.tuner.measure, adapcc_tpu_torch.tuner.policy
import adapcc_tpu_torch.sim, adapcc_tpu_torch.utils, adapcc_tpu_torch.comm.latency
from adapcc_tpu_torch.tuner import CollectiveTuner, TuningDatabase
tuner = CollectiveTuner(4, "t", db=TuningDatabase(persist=False), mode="choose")
tuner.choose("allreduce", 1 << 20, algos=("ring",))
tuner.choose("ddp_step", 1 << 20)
print("BAD", sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "adapcc_tpu")))
"""

_CHECK_SLICE18 = """
import sys
import torch
from adapcc_tpu_torch.pipe import PipelineExecutor, partition_gpt2, pipeline_program, pipeline_schedule
from adapcc_tpu_torch.parallel.expert import expert_parallel_moe
from adapcc_tpu_torch.models.moe import MoEConfig, MoEMLP
from adapcc_tpu_torch.workloads import train_moe
from adapcc_tpu_torch.parallel import Mesh
pipeline_program(pipeline_schedule(4, 4), tied_embedding=True)
m = MoEMLP(MoEConfig.tiny(), device="cpu")
expert_parallel_moe(m, torch.randn(8, 32), m.cfg, Mesh.stacked_mesh({"experts": 2}))
train_moe.build_parser()
print("BAD", sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "adapcc_tpu")))
"""

_CHECK_SERVING = """
import sys
import torch
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.models.gpt2_generate import generate, load_tokenizer
from adapcc_tpu_torch.serve import ClusterRouter, GPT2Server, synthesize_arrival_trace
from adapcc_tpu_torch.sim import decode_step_time, disagg_queue_metrics, serve_queue_metrics
from adapcc_tpu_torch.workloads import serve_gpt2
m = GPT2(GPT2Config(vocab_size=32, max_seq=16, n_layer=1, n_head=4, d_model=16, dtype=torch.float32),
         device="cpu", seed=0)
generate(m, [[1, 2]], 2, 3)
trace = synthesize_arrival_trace(4, 2, 1.0, prompt_len=(2, 3), max_new_tokens=(2, 3), vocab_size=32)
for server in (GPT2Server(m, 4, slots=2), ClusterRouter(m, 2, 2, prefill_slots=1, decode_slots=1,
                                                        kv_wire_dtype="int8", kv_kl_bound=1.0)):
    server.submit_trace(trace)
    server.run()
serve_gpt2.build_parser()
print("BAD", sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "adapcc_tpu")))
"""

_CHECK_NO_GRPC = """
import sys
import adapcc_tpu_torch, adapcc_tpu_torch.api, adapcc_tpu_torch.communicator
import adapcc_tpu_torch.coordinator, adapcc_tpu_torch.measure, adapcc_tpu_torch.ddp.trainer
from adapcc_tpu_torch.coordinator import CoordinatorLogic
print("LOADED", sorted(n for n in sys.modules if n.split(".")[0] == "grpc" or n.startswith("google.protobuf")))
"""


def test_port_imports_no_jax_and_no_reference_package():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    neither JAX, nor the JAX package, nor scipy loads."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    for name in _PORT_MODULES:
        assert f"'{name}'" in out.stdout, f"{name} was not imported"


def test_tuner_sim_and_observability_load_no_jax():
    """The tuner, its cost model and calibration, the trace sinks and the
    latency plane's host half, imported and consulted in a fresh
    interpreter: neither JAX nor the JAX package loads."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECK_TUNER], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_pipeline_and_expert_planes_load_no_jax():
    """The pipeline plane, expert parallelism, the MoE model and train_moe,
    imported and run a little in a fresh interpreter: neither JAX nor the
    JAX package loads."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECK_SLICE18], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_serving_plane_loads_no_jax():
    """Decode, generate, the continuous batcher, the disaggregated router
    (its int8 KL probe included), the serving prices and serve_gpt2,
    imported and run a little in a fresh interpreter: neither JAX nor the
    JAX package loads."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECK_SERVING], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_port_without_grpc_loads_no_grpc():
    """The façade, the Communicator and the coordinator's logic import on a
    machine without grpcio: only the gRPC transport loads it, on first use."""
    out = subprocess.run(
        [sys.executable, "-c", _CHECK_NO_GRPC], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_port_calls_no_library_attention():
    # torch.compile as a name of its own: the port's package path
    # "adapcc_tpu_torch.compiler" holds the letters but names no call
    banned = ("scaled_dot_product_attention", r"(?<![\w.])torch\.compile\b", "cudnn", "flash_attn")
    for path in [*PACKAGE.rglob("*.py"), *PACKAGE.rglob("*.cu")]:
        text = path.read_text()
        for word in banned:
            assert not re.search(word, text), f"{path.relative_to(REPO)} mentions {word}"
    assert re.search(banned[1], "f = torch.compile(model)") and not re.search(banned[1], "adapcc_tpu_torch.compiler")


def test_ring_plane_is_the_hand_written_kernels():
    """The ring plane (the fused codec kernels K5a/K5b included), the quant
    ring and ZeRO-1 reach the card only through the ring kernels or plain
    tensor code: no library collective, no process group; and every K5
    wrapper launches its own kernel of ``csrc/ring.cu``."""
    for rel in ("comm/ring.py", "parallel/fsdp.py", "csrc/ring.cu", "quant/codec.py", "quant/ring.py"):
        text = (PACKAGE / rel).read_text()
        for word in ("torch.distributed", "dist.", "nccl", "all_gather_into_tensor", "reduce_scatter_tensor"):
            assert word not in text, f"{rel} mentions {word}"
    cu = (PACKAGE / "csrc/ring.cu").read_text()
    ring_py = (PACKAGE / "comm/ring.py").read_text()
    for kernel in ("ring_k5a", "ring_k5b"):
        assert f"{kernel}_kernel" in cu and f"adapcc_{kernel}(" in cu, kernel
        assert f'"adapcc_{kernel}"' in ring_py, kernel
    # the decode-add rounds twice, as the plain version does: no FMA
    assert "__fadd_rn" in cu and "__fmul_rn" in cu and "__fdiv_rn" in cu


def test_entry_points_without_a_device_raise_on_a_box_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_world_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT2(GPT2Config.tiny())
    assert resolve_device("cpu") == torch.device("cpu")
