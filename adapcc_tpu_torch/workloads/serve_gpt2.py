"""Latency-SLO GPT-2 serving workload (the port of
:mod:`adapcc_tpu.workloads.serve_gpt2`).

A tensor-parallel GPT-2 behind the continuous batcher
(:mod:`adapcc_tpu_torch.serve`), driven by a deterministic synthetic
arrival trace (seeded Poisson, or a replayed JSON artifact through
``ADAPCC_SERVE_TRACE``), every decode-step allreduce routed through the
traced :class:`~adapcc_tpu_torch.comm.engine.CollectiveEngine`.  The world
is ``--world`` ranks stacked on one device (``--device``, the card by
default); ``--disagg`` splits it into a prefill and a decode pod.
Parameters come from the port's GPT-2 initialization (``--seed``) or a
``--ckpt`` :class:`~adapcc_tpu_torch.checkpoint.TrainCheckpointState` file
whose ``params`` are the model's ``state_dict``.

The run prints one row per request (sojourn and TTFT on the step clock,
EOS eviction) and a summary with step-time percentiles, SLO attainment and
the executed decode-collective histogram read back from the dispatch trace
(``decode_collectives``; ``kv_transfer_events`` under ``--disagg``).

Run::

    python -m adapcc_tpu_torch.workloads.serve_gpt2 --device cpu --requests 5 --slots 2 --world 4 \\
        --dmodel 64 --seq 32 --max-new-tokens 8 --json
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--requests", type=int, default=8,
                   help="synthetic requests to serve (ignored when ADAPCC_SERVE_TRACE replays an artifact)")
    p.add_argument("--rate", type=float, default=0.25, help="Poisson arrival rate (requests per decode step)")
    p.add_argument("--slots", type=int, default=None, help="decode-slot count (default: ADAPCC_SERVE_SLOTS env > 4)")
    p.add_argument("--seed", type=int, default=0,
                   help="arrival-trace and weight seed (per-request sampling seeds derive from it)")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="per-request sojourn SLO in milliseconds (default: ADAPCC_SERVE_SLO_MS env > none)")
    p.add_argument("--algo", default="auto",
                   help="decode-step collective algorithm (auto/ring/rd/tree; ADAPCC_COLL_ALGO outranks)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--eos-id", type=int, default=None,
                   help="EOS token: a sampled EOS latches the stream and evicts the lane early (slot reuse)")
    p.add_argument("--max-new-tokens", type=int, default=12,
                   help="upper bound of the per-request generation budget")
    p.add_argument("--disagg", action="store_true",
                   help="serve disaggregated: split the world into a prefill pod and a decode pod (world must "
                        "be even), KV pages migrating over the traced kv_transfer stream (ADAPCC_DISAGG outranks)")
    p.add_argument("--kv-wire-dtype", default=None,
                   help="disagg KV-migration wire codec (off/bf16/int8; ADAPCC_KV_WIRE_DTYPE outranks; 'off' = "
                        "fp32, bit-exact; lossy codecs are admitted only under the ADAPCC_KV_KL_BOUND bound)")
    p.add_argument("--ckpt", "--checkpoint", dest="ckpt", default=None,
                   help="serve trained parameters (a TrainCheckpointState file whose params are the model's "
                        "state_dict; the shape flags must match training)")
    p.add_argument("--trace-out", default=None,
                   help="save the (synthesized) arrival trace as a JSON artifact replayable via ADAPCC_SERVE_TRACE")
    p.add_argument("--vocab", type=int, default=258)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=None,
                   help="default: one head per rank (n_head must divide over the TP world)")
    p.add_argument("--dmodel", type=int, default=128)
    p.add_argument("--world", type=int, default=4, help="tensor-parallel ranks, stacked on the one device")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    p.add_argument("--json", action="store_true", help="one JSON row per request plus a summary row")
    return p


def run(args) -> dict:
    """Serve the trace; returns the summary dict (the printed artifact)."""
    import torch

    from adapcc_tpu_torch.comm.mesh import resolve_device
    from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from adapcc_tpu_torch.serve import ClusterRouter, GPT2Server, resolve_disagg
    from adapcc_tpu_torch.serve.trace import load_serve_trace, synthesize_arrival_trace
    from adapcc_tpu_torch.utils.observability import CollectiveTrace

    world = int(args.world)
    disagg = resolve_disagg(getattr(args, "disagg", False))
    heads = args.heads if args.heads is not None else max(1, world)
    if heads % world:
        raise SystemExit(f"--heads {heads} must divide over the TP world {world} (head-sharded decode)")
    if disagg:
        if world < 2 or world % 2:
            raise SystemExit(f"--disagg splits the world into two equal pods: world {world} must be an even count >= 2")
        if heads % (world // 2):
            raise SystemExit(f"--heads {heads} must divide over the per-pod TP world {world // 2} under --disagg")
    if args.dmodel % heads:
        raise SystemExit(f"--dmodel {args.dmodel} must divide over --heads {heads}")
    if args.max_new_tokens < 1 or args.max_new_tokens > args.seq - 2:
        # seq - 2: the KV cache holds prompt + generation together and the
        # shortest synthesized prompt is 2 tokens
        raise SystemExit(
            f"--max-new-tokens {args.max_new_tokens} must be in [1, --seq - 2 = {args.seq - 2}]: the KV cache "
            "holds the prompt (>= 2 tokens) and the generation together"
        )
    dev = resolve_device(args.device)
    cfg = GPT2Config(vocab_size=args.vocab, max_seq=args.seq, n_layer=args.layers, n_head=heads,
                     d_model=args.dmodel, dtype=torch.float32)
    model = GPT2(cfg, device=dev, seed=args.seed)
    if args.ckpt:
        from adapcc_tpu_torch.checkpoint import TrainCheckpointState, load_checkpoint

        mismatch = (f"checkpoint {args.ckpt!r} not found or incompatible with the model shape "
                    "(--vocab/--seq/--layers/--heads/--dmodel must match training)")
        state = TrainCheckpointState(params=model.state_dict())
        try:
            if not load_checkpoint(state, args.ckpt, device=dev):
                raise SystemExit(mismatch)
            model.load_state_dict(state.params)
        except (RuntimeError, KeyError) as e:
            raise SystemExit(f"{mismatch}\n  cause: {e}") from e
    model.eval()

    trace = load_serve_trace(world=world)
    if trace is None:
        # prompts must fit the cache next to the generation budget
        max_prompt = max(2, min(12, args.seq - args.max_new_tokens - 1))
        trace = synthesize_arrival_trace(
            world, args.requests, args.rate, seed=args.seed, prompt_len=(2, max_prompt),
            max_new_tokens=(max(1, args.max_new_tokens // 2), args.max_new_tokens),
            vocab_size=args.vocab, eos_id=args.eos_id,
        )
    if args.trace_out:
        trace.save(args.trace_out)
        print(f"[serve] arrival trace -> {args.trace_out}")

    dispatch_trace = CollectiveTrace()
    kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id,
              algo=args.algo, trace=dispatch_trace, slo_ms=args.slo_ms)
    if disagg:
        server = ClusterRouter(model, world // 2, world // 2, prefill_slots=args.slots, decode_slots=args.slots,
                               kv_wire_dtype=args.kv_wire_dtype, **kw)
    else:
        server = GPT2Server(model, world, slots=args.slots, **kw)
    server.submit_trace(trace)
    results = server.run()

    for r in results:
        row = {
            "req_id": r.req_id,
            "arrival_step": r.arrival_step,
            "admitted_step": r.admitted_step,
            "ttft_steps": r.ttft_steps,
            "sojourn_steps": r.sojourn_steps,
            "eos_evicted": r.eos_evicted,
            "generated": r.generated,
        }
        if args.json:
            print(json.dumps(row))
        else:
            print(
                f"[serve] req={r.req_id:>3} arrive={r.arrival_step:>4} admit={r.admitted_step:>4} "
                f"ttft={r.ttft_steps:>3} sojourn={r.sojourn_steps:>4}{' EOS' if r.eos_evicted else '    '} "
                f"tokens={r.generated}"
            )
    summary = server.summary()
    # the executed decode collectives, read back from the dispatch trace
    algos: dict = {}
    kv_events = 0
    for e in dispatch_trace.events():
        if e.primitive == "allreduce":
            algos[e.impl] = algos.get(e.impl, 0) + 1
        elif e.primitive == "kv_transfer":
            kv_events += 1
    summary["decode_collectives"] = algos
    if disagg:
        # every KV migration must be visible in the dispatch trace
        summary["kv_transfer_events"] = kv_events
    summary["trace_label"] = trace.label
    if args.json:
        print(json.dumps({"summary": summary}, sort_keys=True))
    else:
        print(f"[serve] summary: {json.dumps(summary, sort_keys=True)}")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
