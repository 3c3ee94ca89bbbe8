"""GPT-2 autoregressive generation (the port of
:mod:`adapcc_tpu.models.gpt2_generate`, the reference's
models/gpt2/interact.py).

:func:`generate` is a Python loop over positions (where JAX runs one
``lax.scan``) around the port's one-token decode step (``GPT2.forward(...,
decode=True)``): prompt tokens are force-fed for the first ``prompt_len``
steps and sampled thereafter, EOS is a carried mask.

Randomness is an explicit ``torch.Generator`` on the model's device.  Every
step draws, prompt steps too, as JAX splits its key on every step: a request
seeded alike draws the same stream whether it runs here alone or in a slot
of the continuous batcher (:mod:`adapcc_tpu_torch.serve`), which samples
each slot with its own generator over a ``[1, vocab]`` row, the shape of
one row here.  A categorical draw is the Gumbel-max of one ``[B, vocab]``
uniform draw (``jax.random.categorical``'s construction); torch's stream is
not threefry's, so the same seed samples other tokens than JAX does.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config


def filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to -inf (``k`` past the
    vocabulary masks nothing, as JAX's clamped index does)."""
    kth = torch.sort(logits, dim=-1).values[..., -min(k, logits.shape[-1]), None]
    return torch.where(logits < kth, float("-inf"), logits)


def filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted distribution
    with cumulative probability ≥ p (the first token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a sorted position is cut when the mass *before* it already reaches p
    cut = cum - probs >= p
    threshold = torch.where(cut, float("inf"), sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, float("-inf"), logits)


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """One token per row of ``logits [B, V]`` (int64); greedy iff
    ``temperature == 0`` (no draw).  Otherwise one uniform ``[B, V]`` draw
    from ``generator`` and the Gumbel-max of the filtered logits."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    # true division: on the card a Python scalar divisor becomes a multiply
    logits = logits / torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    if top_k:
        logits = filter_top_k(logits, top_k)
    if top_p:
        logits = filter_top_p(logits, top_p)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


@torch.no_grad()
def generate(
    model: GPT2,
    prompt: Union[torch.Tensor, Sequence[Sequence[int]]],
    prompt_len: int,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    eos_id: Optional[int] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` past a ``[B, prompt_len]`` prompt.

    Returns ``[B, prompt_len + max_new_tokens]`` int64 on the model's device
    (prompt included).  After a sampled EOS a row emits ``eos_id`` forever;
    an EOS inside the prompt does not latch.  The cache holds
    ``model.cfg.max_seq`` rows; the total length must fit in it.
    ``generator`` defaults to one seeded with 0."""
    cfg = model.cfg
    dev = model.wte.weight.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B = prompt.shape[0]
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq:
        raise ValueError(f"{total} tokens > max_seq={cfg.max_seq} cache slots")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = model.init_cache(B)
    tokens = torch.zeros((B, total), dtype=torch.long, device=dev)
    tokens[:, : prompt.shape[1]] = prompt[:, :total]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(total - 1):
        tok_in = tokens[:, t : t + 1]
        logits, cache = model(tok_in, decode=True, pos=t, cache=cache)
        nxt = sample_token(logits[:, 0], generator, temperature, top_k, top_p)
        if eos_id is not None:
            # only sampled tokens latch EOS: positions t < prompt_len are
            # forced prompt tokens (which may hold eos as a separator)
            done = done | ((tok_in[:, 0] == eos_id) & (t >= prompt_len))
            nxt = torch.where(done, eos_id, nxt)
        # prompt positions are forced, generated positions sampled
        if t + 1 >= prompt_len:
            tokens[:, t + 1] = nxt
    return tokens


# --------------------------------------------------------------------------- #
# interact CLI (models/gpt2/interact.py analog)
# --------------------------------------------------------------------------- #


class ByteTokenizer:
    """Offline tokenizer: raw UTF-8 bytes + BOS/EOS (vocab 258)."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def load_tokenizer():
    """HuggingFace GPT-2 BPE when its files are already on this machine
    (``local_files_only``: nothing is downloaded), else the byte
    tokenizer."""
    try:
        from transformers import GPT2TokenizerFast

        tok = GPT2TokenizerFast.from_pretrained("gpt2", local_files_only=True)
        tok.eos_id = tok.eos_token_id
        return tok
    except Exception:
        return ByteTokenizer()


def interact(argv: Optional[list] = None) -> None:
    """REPL (or one-shot with ``--prompt``): prompt in, continuation out.

    ``--ckpt`` loads trained parameters from the port's
    :class:`~adapcc_tpu_torch.checkpoint.TrainCheckpointState` file (its
    ``params`` the model's ``state_dict``); the model-shape flags must match
    the training run's.  ``--device`` picks the device (default: the card).
    """
    import argparse

    from adapcc_tpu_torch.comm.mesh import resolve_device

    ap = argparse.ArgumentParser(description="GPT-2 interactive sampling")
    ap.add_argument("--ckpt", "--checkpoint", dest="ckpt", default=None)
    ap.add_argument("--prompt", default=None, help="one-shot mode: generate from this prompt and exit")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.9)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=None, help="default: tokenizer vocab size")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--dmodel", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.max_new_tokens >= args.seq:
        raise SystemExit(
            f"--max-new-tokens {args.max_new_tokens} must be < --seq {args.seq}: the KV cache holds "
            "prompt + generation together"
        )
    mismatch = (
        f"checkpoint {args.ckpt!r} not found or incompatible with the model shape "
        "(--vocab/--seq/--layers/--heads/--dmodel must match training)"
    )
    if args.ckpt and not os.path.exists(args.ckpt):
        raise SystemExit(mismatch)

    dev = resolve_device(args.device)
    tok = load_tokenizer()
    vocab = args.vocab or max(getattr(tok, "vocab_size", 258), 258)
    cfg = GPT2Config(vocab_size=vocab, max_seq=args.seq, n_layer=args.layers, n_head=args.heads,
                     d_model=args.dmodel, dtype=torch.float32)
    model = GPT2(cfg, device=dev, seed=args.seed)
    if args.ckpt:
        from adapcc_tpu_torch.checkpoint import TrainCheckpointState, load_checkpoint

        state = TrainCheckpointState(params=model.state_dict())
        try:
            ok = load_checkpoint(state, args.ckpt, device=dev)
            if ok:
                model.load_state_dict(state.params)
        except Exception as e:  # a shape mismatch raises in load_state_dict
            raise SystemExit(f"{mismatch}\n  cause: {e}") from e
        if not ok:
            raise SystemExit(mismatch)
        print(f"loaded checkpoint (epoch {state.epoch})")

    rng = np.random.default_rng(args.seed)

    def respond(text: str, seed: int) -> str:
        ids = tok.encode(text)[-(cfg.max_seq - args.max_new_tokens):]
        out = generate(
            model, [ids], prompt_len=len(ids), max_new_tokens=args.max_new_tokens,
            generator=torch.Generator(device=dev).manual_seed(seed), temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, eos_id=getattr(tok, "eos_id", None),
        )
        return tok.decode(out[0, len(ids):].tolist())

    if args.prompt is not None:
        print(respond(args.prompt, args.seed))
        return

    while True:
        try:
            text = input(">>> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not text.strip():
            continue
        print(respond(text, int(rng.integers(0, 1 << 30))))


if __name__ == "__main__":
    interact()
