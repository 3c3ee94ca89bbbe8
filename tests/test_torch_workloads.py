"""The port's training workloads held against the JAX package's.

- ``train_gpt2`` at a tiny width: the corpus and its packing equal JAX's;
  the perplexity before and after one epoch against JAX's ``run`` from the
  same initial weights (JAX's flax init, handed to the port's ``run`` as
  ``init_state``), the port under ``--attn flash`` (its float32 kernels'
  plain versions on the CPU) and under ``--attn xla``, JAX under xla: the
  initial perplexity within ``PPL0_RTOL`` (float32 summation order), the
  final within ``PPL1_RTOL`` (a float32 rounding through 21 Adam steps);
- the refusals of ``train_gpt2`` and ``train_ddp``, word for word JAX's;
- ``accuracy_benchmark`` learns (top-1 well above chance).
"""

import numpy as np
import pytest

from adapcc_tpu_torch.comm.mesh import destroy_world
from adapcc_tpu_torch.workloads import accuracy_benchmark, train_ddp, train_gpt2

PPL0_RTOL = 1e-5
PPL1_RTOL = 1e-3
GPT2_ARGV = ["--epochs", "1", "--batch", "8", "--seq", "32", "--layers", "1", "--heads", "2", "--dmodel", "32",
             "--vocab", "64", "--corpus-tokens", "6144", "--warmup-steps", "4", "--lr", "3e-3"]


@pytest.fixture(autouse=True)
def _leave_no_world():
    """A workload joins a process group (a world of one here) and keeps it,
    as JAX's keeps its mesh; leave none behind for the next test in this
    process."""
    yield
    destroy_world()


def test_corpus_and_packing_match_jax():
    from adapcc_tpu.workloads import train_gpt2 as jax_train_gpt2

    a = train_gpt2.markov_corpus(5000, 97, seed=3)
    b = jax_train_gpt2.markov_corpus(5000, 97, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(train_gpt2.pack_sequences(a, 48), jax_train_gpt2.pack_sequences(b, 48))


def _jax_init_state(args):
    """JAX ``run``'s initial weights (``model.init(PRNGKey(0), train_set[:1])``)
    as the port's state dict."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config

    from adapcc_tpu_torch.models.convert import flax_to_state_dict

    packed = train_gpt2.pack_sequences(train_gpt2.markov_corpus(args.corpus_tokens, args.vocab, seed=0), args.seq)
    cfg = JaxGPT2Config(vocab_size=args.vocab, max_seq=args.seq, n_layer=args.layers, n_head=args.heads,
                        d_model=args.dmodel, dtype=jnp.float32)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.asarray(packed[:1]))
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_gpt2_run():
    from adapcc_tpu.workloads import train_gpt2 as jax_train_gpt2

    args = jax_train_gpt2.build_parser().parse_args(GPT2_ARGV + ["--world", "1"])
    return jax_train_gpt2.run(args), _jax_init_state(args)


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_train_gpt2_matches_jax_run(jax_gpt2_run, attn):
    (ppl0_j, ppl1_j), init_state = jax_gpt2_run
    args = train_gpt2.build_parser().parse_args(GPT2_ARGV + ["--device", "cpu", "--attn", attn, "--sample"])
    report = {}
    ppl0, ppl1 = train_gpt2.run(args, init_state=init_state, report=report)
    assert ppl0 == pytest.approx(ppl0_j, rel=PPL0_RTOL)
    assert ppl1 == pytest.approx(ppl1_j, rel=PPL1_RTOL)
    assert ppl1 < ppl0
    losses = report["losses"]
    assert len(losses) == report["epoch_steps"][0] == 21 and np.isfinite(losses).all()
    assert len(report["sample"]) == 24 and 0.0 <= report["hits_at_1"] <= 1.0


def test_train_gpt2_checkpoint_carries_the_zero1_layout(tmp_path):
    import torch

    args = train_gpt2.build_parser().parse_args(
        GPT2_ARGV + ["--device", "cpu", "--zero1", "--accum", "2", "--checkpoint-file", str(tmp_path / "c.ckpt")])
    train_gpt2.run(args)
    saved = torch.load(tmp_path / "c.ckpt", weights_only=True)
    assert saved["epoch"] == 0 and saved["extra"]["zero1_layout"]["world"] == 1


GPT2_REFUSALS = [
    ["--sp", "ring", "--accum", "2"],
    ["--sp", "ulysses", "--zero1"],
    ["--pp-stages", "2", "--zero1", "--grad-compress", "bf16"],
    ["--pp-stages", "2", "--sp", "ring", "--checkpoint-file", "x"],
    ["--pp-stages", "1"],
    ["--pp-stages", "2", "--batch", "6", "--pp-microbatches", "4"],
]


def _jax_refusal(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("argv", GPT2_REFUSALS)
def test_train_gpt2_refusals_are_jax_s(argv):
    from adapcc_tpu.workloads import train_gpt2 as jax_train_gpt2

    want = _jax_refusal(lambda: jax_train_gpt2.run(jax_train_gpt2.build_parser().parse_args(argv)))
    got = _jax_refusal(lambda: train_gpt2.run(train_gpt2.build_parser().parse_args(argv + ["--device", "cpu"])))
    assert got == want


DDP_REFUSALS = [
    ["--adapt", "detect", "--dp-mode", "fsdp"],
    ["--adapt-every", "0"],
    ["--supervisor", "--dp-mode", "zero1"],
    ["--supervisor-period", "0"],
    ["--coordinator", "--dp-mode", "fsdp"],
    ["--no-bsp", "--dp-mode", "zero1"],
    ["--zero1-ring"],
    ["--error-feedback", "--dp-mode", "zero1"],
    ["--wire-dtype", "strategy", "--dp-mode", "fsdp"],
    ["--tune", "--dp-mode", "fsdp"],
    ["--overlap", "bucket", "--dp-mode", "fsdp"],
    ["--overlap", "microbatch", "--dp-mode", "zero1"],
    ["--accum", "0"],
    ["--accum", "2", "--dp-mode", "fsdp"],
]


@pytest.mark.parametrize("argv", DDP_REFUSALS)
def test_train_ddp_refusals_are_jax_s(argv, monkeypatch):
    from adapcc_tpu.workloads import train_ddp as jax_train_ddp

    for env in ("ADAPCC_ADAPT", "ADAPCC_SUPERVISOR", "ADAPCC_OVERLAP", "ADAPCC_FAULT_PLAN",
                "ADAPCC_CONGESTION_PROFILE"):
        monkeypatch.delenv(env, raising=False)
    want = _jax_refusal(lambda: jax_train_ddp.main(argv))
    got = _jax_refusal(lambda: train_ddp.check_args(train_ddp.build_parser().parse_args(argv)))
    assert got == want


def test_train_ddp_fault_plan_refused_outside_ddp(monkeypatch):
    monkeypatch.setenv("ADAPCC_FAULT_PLAN", "1:down:0")
    with pytest.raises(ValueError, match="ADAPCC_FAULT_PLAN requires --dp-mode ddp"):
        train_ddp.check_args(train_ddp.build_parser().parse_args(["--dp-mode", "fsdp"]))


def test_train_ddp_zero1_ring_waits_for_the_per_process_ring(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="per-process ring"):
        train_ddp.main(["--device", "cpu", "--dp-mode", "zero1", "--zero1-ring", "--steps", "1", "--batch", "4"])


def test_accuracy_benchmark_learns():
    args = accuracy_benchmark.build_parser().parse_args(
        ["--device", "cpu", "--model", "mlp", "--epochs", "2", "--train-size", "256", "--image-size", "8"])
    report = {}
    top1, top5 = accuracy_benchmark.run(args, report=report)
    assert len(report["epochs"]) == 2
    assert top1 > 50.0 and top5 >= top1
    assert report["gns"] is None  # a world of one measures no GNS


def test_topk_accuracy_matches_jax():
    import jax.numpy as jnp
    import torch

    from adapcc_tpu.workloads.accuracy_benchmark import topk_accuracy as jax_topk

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(16, 7)).astype(np.float32)
    logits[3, 2] = logits[3, 5]  # a tie ranks the higher index first on both
    labels = rng.integers(0, 7, size=(16,))
    got = [float(a) for a in accuracy_benchmark.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))]
    want = [float(a) for a in jax_topk(jnp.asarray(logits), jnp.asarray(labels))]
    assert got == pytest.approx(want, abs=1e-4)


def test_schedule_clip_adamw_match_optax():
    """train_gpt2's optimizer: ``warmup_cosine_decay_schedule`` value for
    value (float32), and ``adamw(schedule, weight_decay=0.01, clip_norm=)``
    against ``optax.chain(clip_by_global_norm, adamw)`` over the warmup and
    the decay, clipped and unclipped steps, within float32 rounding."""
    import jax.numpy as jnp
    import optax
    import torch

    from adapcc_tpu_torch.ddp.trainer import adamw, warmup_cosine_decay_schedule

    kw = dict(init_value=0.0, peak_value=3e-3, warmup_steps=5, decay_steps=12)
    ours, theirs = warmup_cosine_decay_schedule(**kw), optax.warmup_cosine_decay_schedule(**kw)
    assert [ours(i) for i in range(16)] == [float(theirs(i)) for i in range(16)]
    rng = np.random.default_rng(8)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(theirs, weight_decay=0.01))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = adamw(ours, weight_decay=0.01, clip_norm=1.0)(tp)
    for step in range(14):
        scale = 3.0 if step % 2 else 0.05  # alternately above and below the clip norm
        grads = [(rng.normal(size=p.shape) * scale).astype(np.float32) for p in p0]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
