"""GPT-2 language-model training pipeline — the reference train_gpt2_ddp flow,
the port of :mod:`adapcc_tpu.workloads.train_gpt2`.

The reference fine-tunes HuggingFace GPT-2 on PersonaChat under torch DDP
with ignite (models/gpt2/train_gpt2_ddp.py): dataset → packed LM batches →
AdamW + linear LR decay + gradient clipping → periodic evaluation (the
convai_evaluation.py metric is perplexity) → interact.py sampling.  This
pipeline keeps that shape end to end: corpus → packed ``[B, T]`` batches →
:class:`~adapcc_tpu_torch.ddp.DDPTrainer` (adaptive allreduce) with
warmup+cosine LR and global-norm clipping (optax's, exactly:
:func:`~adapcc_tpu_torch.ddp.trainer.adamw` with a schedule and
``clip_norm``) → held-out perplexity per epoch → a generation sample from
the trained weights.  The model trains in float32, as JAX's does; under
``--attn flash`` its attention runs the float32 flash kernels.

The corpus is a seeded Markov chain over the vocabulary (zero-egress stand-in
for PersonaChat): it has real sequential structure, so validation perplexity
falls far below the uniform bound iff the model actually learns.

The DDP world is the process group (one process a rank, joined from the
launcher's environment; one process alone is world 1).  ``--sp`` shards the
sequence over ``--world`` ranks stacked on the one device, as the port's
sequence-parallel step runs them; ``--pp-stages`` stacks the stages on it.

Run::

    python -m adapcc_tpu_torch.workloads.train_gpt2 --epochs 2            # on the card
    python -m adapcc_tpu_torch.workloads.train_gpt2 --device cpu --epochs 1
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# --- corpus (PersonaChat stand-in) --------------------------------------------


def markov_corpus(n_tokens: int, vocab_size: int, branching: int = 4, seed: int = 0) -> np.ndarray:
    """A token stream from a sparse random Markov chain: each token has
    ``branching`` likely successors.  Entropy ≈ log(branching) ≪
    log(vocab_size), so a language model has real structure to learn."""
    rng = np.random.default_rng(seed)
    successors = rng.integers(0, vocab_size, size=(vocab_size, branching))
    probs = rng.dirichlet(np.ones(branching) * 2.0, size=vocab_size)
    # draw all uniforms up front and step via cumulative inverse transform —
    # per-token rng.choice(p=...) revalidates the distribution every call and
    # costs seconds at default corpus sizes
    cum = probs.cumsum(axis=1)
    uniforms = rng.random(n_tokens)
    out = np.empty(n_tokens, dtype=np.int32)
    tok = int(rng.integers(0, vocab_size))
    for i in range(n_tokens):
        out[i] = tok
        tok = int(successors[tok, np.searchsorted(cum[tok], uniforms[i])])
    return out


def pack_sequences(stream: np.ndarray, seq_len: int) -> np.ndarray:
    """Contiguous ``[N, seq_len]`` packing (drops the ragged tail) — the
    reference's padded-batch builder, minus padding (packing wastes nothing)."""
    n = len(stream) // seq_len
    return stream[: n * seq_len].reshape(n, seq_len)


# --- evaluation (convai_evaluation.py analog: perplexity + hits@1) ------------


def evaluate_perplexity(model, packed: np.ndarray, batch: int = 16) -> float:
    """exp(mean next-token NLL) over a held-out packed set, on the model's
    device, without gradients."""
    import torch

    from adapcc_tpu_torch.models.gpt2 import lm_loss

    dev = model.wte.weight.device
    total, count = 0.0, 0
    with torch.no_grad():
        for i in range(0, len(packed) - batch + 1, batch):
            b = torch.as_tensor(packed[i:i + batch], device=dev).long()
            total += float(lm_loss(model(b, deterministic=True), b)) * len(b)
            count += len(b)
    if count == 0:
        raise ValueError(f"held-out set smaller than one batch ({len(packed)} < {batch})")
    return float(np.exp(total / count))


#: sequences a hits@1 forward scores at once (the JAX package scores all
#: ``M·C`` in one call; the port bounds the ``[n, T, vocab]`` float32 logits)
HITS_CHUNK = 16


def evaluate_hits_at_1(model, packed: np.ndarray, n_candidates: int = 4, max_rows: int = 64) -> float:
    """Candidate-ranking accuracy, the reference's ConvAI hits@1 metric
    (models/gpt2/convai_evaluation.py ranks each gold reply against
    distractor candidates; its double-head model uses a trained classifier,
    ours ranks by LM log-likelihood — the zero-extra-parameter variant).

    Each held-out row ``[T]`` splits into context (first half) and
    continuation (second half); the gold continuation competes against
    ``n_candidates - 1`` distractor continuations drawn from other rows.
    Score = sum of next-token log-probs over the continuation positions.
    Chance level is ``1 / n_candidates``.
    """
    import torch

    rows = np.asarray(packed[:max_rows])
    M, T = rows.shape
    half = T // 2
    if M < n_candidates or half < 2:
        raise ValueError(f"need >= {n_candidates} rows of length >= 4, got {rows.shape}")
    # candidate c for row i = continuation of row (i + c·stride) mod M; c=0 is
    # the gold one.  A fixed stride keeps the distractor draw deterministic.
    seqs = np.stack([
        np.concatenate([rows[i, :half], rows[(i + c * max(1, M // n_candidates)) % M, half:]])
        for i in range(M)
        for c in range(n_candidates)
    ])
    dev = model.wte.weight.device
    scores = []
    with torch.no_grad():
        for i in range(0, len(seqs), HITS_CHUNK):
            s = torch.as_tensor(seqs[i:i + HITS_CHUNK], device=dev).long()
            # logits[:, t] predicts token t+1; sum log p over the continuation
            logp = torch.log_softmax(model(s, deterministic=True).float(), dim=-1)
            nxt = torch.gather(logp[:, :-1], -1, s[:, 1:, None])[..., 0]
            scores.append(nxt[:, half - 1:].sum(dim=-1))
    s = torch.cat(scores).reshape(M, n_candidates).cpu().numpy()
    return float(np.mean(np.argmax(s, axis=1) == 0))


# --- training -----------------------------------------------------------------


def _run_pipeline(args, dev, model, cfg, tx, train_set, val_set, report) -> Tuple[float, float]:
    """The --pp-stages branch: block stack split over stages stacked on the
    device, every hop through the traced engine, schedule resolved env >
    flag > tuner (docs/PIPELINE.md)."""
    import itertools

    import torch

    from adapcc_tpu_torch.comm.engine import CollectiveEngine
    from adapcc_tpu_torch.pipe import PipelineExecutor, partition_gpt2, split_params, sync_tied_embedding
    from adapcc_tpu_torch.pipe.partition import merge_params
    from adapcc_tpu_torch.strategy.ir import Strategy
    from adapcc_tpu_torch.utils import AverageMeter

    partition = partition_gpt2(cfg, args.pp_stages)
    engine = CollectiveEngine(args.pp_stages, Strategy.ring(args.pp_stages))
    executor = PipelineExecutor(cfg, partition, engine, num_microbatches=args.pp_microbatches,
                                schedule=args.pp_schedule, device=dev)
    stage_params = split_params(model, partition)
    opt_state = tx(itertools.chain.from_iterable(s.parameters() for s in stage_params))
    print(f"pipeline: {args.pp_stages} stages x {args.pp_microbatches} "
          f"microbatches, schedule {executor.schedule_kind}, "
          f"params/stage {partition.param_counts}")

    def merged():
        model.load_state_dict(merge_params(stage_params, partition))
        return model

    initial_ppl = evaluate_perplexity(merged(), val_set)
    print(f"val ppl before training: {initial_ppl:.1f} (uniform bound {float(args.vocab):.0f})")

    rng = np.random.default_rng(0)
    steps_per_epoch = max(1, len(train_set) // args.batch)
    ppl = initial_ppl
    for epoch in range(args.epochs):
        losses = AverageMeter("lm_loss", ":.4f")
        order = rng.permutation(len(train_set))
        for i in range(steps_per_epoch):
            b = torch.as_tensor(train_set[order[i * args.batch:(i + 1) * args.batch]], device=dev).long()
            loss, grads, pipe_report = executor.forward_backward(stage_params, b)
            for stage, g in zip(stage_params, grads):
                for name, p in stage.named_parameters():
                    p.grad = g[name]
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
            with torch.no_grad():
                sync_tied_embedding(stage_params)
            losses.update(float(loss), args.batch)
            report.setdefault("losses", []).append(float(loss))
        ppl = evaluate_perplexity(merged(), val_set)
        print(f"epoch {epoch:3d}  {losses}  val ppl {ppl:.2f}  "
              f"(bubble {pipe_report.bubble_fraction:.2f}, stash peak {pipe_report.stash_peak})")

    hits = evaluate_hits_at_1(merged(), val_set)
    report["hits_at_1"] = hits
    print(f"hits@1 over 4 candidates: {hits:.2f} (chance 0.25)")
    return initial_ppl, ppl


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=20)
    p.add_argument("--clip-norm", type=float, default=1.0, help="reference max_norm=1.0")
    # 258 = the generate CLI's ByteTokenizer vocab (bytes + BOS/EOS), so a
    # default-trained checkpoint round-trips with a default generate command
    p.add_argument("--vocab", type=int, default=258)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--dmodel", type=int, default=128)
    p.add_argument("--corpus-tokens", type=int, default=200_000)
    p.add_argument("--world", type=int, default=None,
                   help="DDP: the process group's size (default: the launcher's, else 1); "
                        "--sp / --pp-stages: ranks stacked on the one device")
    p.add_argument("--device", default=None, help="the device to train on (default: the card)")
    p.add_argument("--checkpoint-file", type=str, default=None)
    p.add_argument("--sample", action="store_true", help="print a generation sample at the end")
    p.add_argument("--sp", choices=("none", "ring", "ulysses"), default="none",
                   help="sequence parallelism: shard the sequence (not the "
                        "batch) over the world — the long-context regime")
    p.add_argument("--attn", choices=("xla", "flash"), default="xla",
                   help="block attention implementation (flash = the hand-written float32 kernels)")
    p.add_argument("--loss", choices=("dense", "chunked"), default="dense",
                   help="LM loss: dense materializes [B,T,vocab] logits; "
                        "chunked fuses the head into an online-softmax scan")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation: microbatches per step "
                        "(DDP path; per-rank batch must divide by it)")
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer state ZeRO-1 style inside the "
                        "adaptive DDP step (fp32 flat master)")
    p.add_argument("--grad-compress", choices=["off", "bf16"], default="off",
                   help="bf16 gradient-sync wire compression (DDP path)")
    p.add_argument("--pp-stages", type=int, default=0,
                   help="pipeline parallelism: split the block stack over "
                        "this many stages (0 = off; docs/PIPELINE.md)")
    p.add_argument("--pp-microbatches", type=int, default=4,
                   help="microbatches per pipelined step (--batch must "
                        "divide by it)")
    p.add_argument("--pp-schedule", choices=("gpipe", "1f1b"), default=None,
                   help="pipeline tick schedule; omitted = "
                        "ADAPCC_PIPE_SCHEDULE > tuner > 1f1b")
    return p


def _check_args(args) -> None:
    """JAX's refusals, word for word, before anything is built."""
    if args.sp != "none" and (args.accum != 1 or args.zero1):
        raise ValueError(
            "--accum/--zero1 ride the DDP trainer; they are not wired "
            "into the sequence-parallel step — drop --sp to use them"
        )
    if args.pp_stages:
        incompatible = []
        if args.sp != "none":
            incompatible.append("--sp")
        if args.accum != 1:
            incompatible.append("--accum")
        if args.zero1:
            incompatible.append("--zero1")
        if args.grad_compress != "off":
            incompatible.append("--grad-compress")
        if args.checkpoint_file:
            incompatible.append("--checkpoint-file")
        if incompatible:
            raise ValueError(
                f"{', '.join(incompatible)} ride the DDP trainer; the "
                "pipeline-parallel step (--pp-stages) runs its own "
                "executor — the pipeline already microbatches, syncs no "
                "gradients, and is not checkpoint-wired (docs/PIPELINE.md)"
            )
        if args.pp_stages < 2:
            raise ValueError(
                f"--pp-stages {args.pp_stages}: a pipeline needs at least "
                "2 stages (omit the flag for single-stage training)"
            )
        if args.batch % args.pp_microbatches:
            raise ValueError(
                f"--batch {args.batch} must divide by --pp-microbatches "
                f"{args.pp_microbatches}"
            )


def run(args, init_state: Optional[Dict] = None, report: Optional[Dict] = None) -> Tuple[float, float]:
    """Train; returns (initial_val_ppl, final_val_ppl).

    ``init_state``: a GPT-2 ``state_dict`` to start from instead of the
    seeded initialization (the parity tests hand over the JAX package's
    initial weights).  ``report``, when given, is filled with the per-step
    losses, each epoch's training seconds and steps (timed to completion),
    hits@1, the peak memory on the card and the sample's tokens."""
    _check_args(args)
    report = {} if report is None else report
    from adapcc_tpu_torch.launch import apply_platform_env, maybe_initialize_distributed

    maybe_initialize_distributed()

    import torch

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, resolve_device
    from adapcc_tpu_torch.data import device_batches
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adamw, warmup_cosine_decay_schedule
    from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss, lm_loss_chunked
    from adapcc_tpu_torch.strategy.ir import Strategy
    from adapcc_tpu_torch.tuner.measure import sync_device
    from adapcc_tpu_torch.utils import AverageMeter

    dev = resolve_device(args.device or apply_platform_env())
    stacked = args.sp != "none" or bool(args.pp_stages)
    world = build_world_mesh(None if stacked else args.world, device=dev)

    stream = markov_corpus(args.corpus_tokens, args.vocab, seed=0)
    packed = pack_sequences(stream, args.seq)
    n_val = max(16, len(packed) // 10)
    if len(packed) < n_val + args.batch:
        raise ValueError(
            f"corpus too small: {len(packed)} sequences of len {args.seq} can't "
            f"cover {n_val} validation rows plus one {args.batch}-row training "
            f"batch; raise --corpus-tokens or lower --seq/--batch"
        )
    train_set, val_set = packed[:-n_val], packed[-n_val:]

    cfg = GPT2Config(
        vocab_size=args.vocab, max_seq=args.seq, n_layer=args.layers,
        n_head=args.heads, d_model=args.dmodel, dtype=torch.float32,
        attention=args.attn,
    )
    model = GPT2(cfg, device=dev, seed=0)
    if init_state is not None:
        model.load_state_dict(init_state)

    if args.loss == "chunked":
        # fuse the LM head into the online-softmax loss: no [B, T, vocab]
        # logits tensor (ops/chunked_ce.py) — the long-vocab memory saver
        # (the SP branch passes loss= through to its own sharded variant)
        def loss_fn(m, b):
            return lm_loss_chunked(m, b, block=min(1024, args.vocab))
    else:

        def loss_fn(m, b):
            return lm_loss(m(b), b)

    steps_per_epoch = max(1, len(train_set) // args.batch)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr,
        warmup_steps=args.warmup_steps,
        decay_steps=max(args.warmup_steps + 1, steps_per_epoch * args.epochs),
    )
    # reference recipe: AdamW + clipping + decaying LR (train_gpt2_ddp.py's
    # PiecewiseLinear decay and max_norm clipping), optax's chain
    tx = adamw(schedule, weight_decay=0.01, clip_norm=args.clip_norm)
    if args.pp_stages:
        return _run_pipeline(args, dev, model, cfg, tx, train_set, val_set, report)
    if args.sp != "none":
        # sequence parallelism: the batch is replicated and the SEQUENCE is
        # sharded over the ranks — the long-context regime
        import dataclasses

        from adapcc_tpu_torch.parallel import Mesh, gpt2_sp_train_step

        sp_world = args.world or 1
        if args.seq % sp_world:
            raise ValueError(f"--seq {args.seq} must divide by world {sp_world} under --sp")
        mesh = Mesh.stacked_mesh({"ranks": sp_world})
        sp_model = GPT2(dataclasses.replace(cfg, sp_axis=mesh["ranks"], sp_impl=args.sp), device=dev, seed=None)
        sp_model.load_state_dict(model.state_dict())
        sp_step = gpt2_sp_train_step(sp_model, tx, mesh, loss=args.loss)
        sp_opt = tx(sp_model.parameters())
        trainer, state = None, None
    else:
        trainer = DDPTrainer(
            loss_fn, tx, world, Strategy.ring(world.world_size),
            accum_steps=args.accum, zero1=args.zero1,
            grad_compress=args.grad_compress,
        )
        state = trainer.init_state(model)

    initial_ppl = evaluate_perplexity(model, val_set)
    uniform = float(args.vocab)
    print(f"val ppl before training: {initial_ppl:.1f} (uniform bound {uniform:.0f})")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ppl = initial_ppl
    for epoch in range(args.epochs):
        losses = AverageMeter("lm_loss", ":.4f")
        # keep per-step losses on the device; one host sync per epoch keeps
        # the steps queued back to back
        epoch_losses = []
        # async input pipeline: the next batch lands on the device (this
        # rank's shard of it on the DDP path) while the current step computes
        batches = device_batches(train_set, args.batch, world=None if trainer is None else world,
                                 seed=epoch, device=dev)
        sync_device(dev)
        t0 = time.perf_counter()
        for b in batches:
            b = b.long()
            if trainer is None:
                _, sp_opt, loss = sp_step(sp_model, sp_opt, b)
            else:
                state, loss = trainer.step(state, b)
            epoch_losses.append(loss.detach().float().mean())
        sync_device(dev)
        report.setdefault("epoch_s", []).append(time.perf_counter() - t0)
        report.setdefault("epoch_steps", []).append(len(epoch_losses))
        for val in torch.stack(epoch_losses).cpu().tolist():
            losses.update(val, args.batch)
            report.setdefault("losses", []).append(val)
        if trainer is None:
            model.load_state_dict(sp_model.state_dict())
        ppl = evaluate_perplexity(model, val_set)
        print(f"epoch {epoch:3d}  {losses}  val ppl {ppl:.2f}")

        if args.checkpoint_file:
            from adapcc_tpu_torch.checkpoint import TrainCheckpointState, save_checkpoint

            optimizer = sp_opt if trainer is None else state.optimizer
            save_checkpoint(
                TrainCheckpointState(
                    params=model.state_dict(), opt_state=optimizer.state_dict(),
                    epoch=epoch, step=(epoch + 1) * steps_per_epoch if trainer is None else state.step,
                    # --zero1 runs stamp the optimizer layout so a resume
                    # under another layout fails loudly (checkpoint.py's
                    # layout guard) instead of loading permuted master weights
                    extra=trainer.checkpoint_extra() if trainer is not None else {},
                ),
                args.checkpoint_file,
            )
    if dev.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    hits = evaluate_hits_at_1(model, val_set)
    report["hits_at_1"] = hits
    print(f"hits@1 over 4 candidates: {hits:.2f} (chance 0.25)")

    if args.sample:
        from adapcc_tpu_torch.models.gpt2_generate import generate

        prompt = torch.as_tensor(val_set[:1, :8], device=dev).long()
        out = generate(model, prompt, prompt_len=8, max_new_tokens=24, temperature=0.8, top_k=8)
        report["sample"] = out[0, 8:].tolist()
        print("sample continuation:", report["sample"])

    return initial_ppl, ppl


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
