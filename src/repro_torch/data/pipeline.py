"""Deterministic, *resumable* synthetic token pipeline (port of
``repro.data.pipeline``).

The pipeline state is part of the checkpoint (exact resume after failure)
and is itself a scrutinize() target.  Its leaves and ring-buffer semantics
are the reference's: ``key`` (2,) and ``step``, ``cursor`` (0-d) int32,
``buffer`` (PREFETCH, B, T) int32; ``next_batch`` pops slot
``cursor % PREFETCH`` and refills it with the batch of step
``step + PREFETCH``.

Draws come from a ``torch.Generator`` on the state's device, seeded from
``key`` and a step number, where the reference folds the step into a
threefry key: the port's tokens differ from the reference's, as its probe
cotangents do, and follow the same rules.  The key is held as int32
``[0, seed]``, the words of the reference's ``PRNGKey(seed)`` (uint32
there).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Tuple

import torch

from repro_torch._tensors import resolve_device

PREFETCH = 4  # batches held in the ring buffer


def _generator(key: torch.Tensor, step: int) -> torch.Generator:
    """The generator of one step's draws, from the key's words and the
    step (the counterpart of ``jax.random.fold_in(key, step)``)."""
    words = ",".join(str(int(w)) for w in key.tolist())
    digest = hashlib.blake2b(f"{words}:{int(step)}".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=key.device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


def init_state(cfg, batch: int, seq: int, seed: int = 0, *,
               device=None) -> Dict[str, Any]:
    """The pipeline at step 0 on ``device``: the card unless the caller
    asks for the CPU."""
    device = resolve_device(device)
    key = torch.tensor([0, seed], dtype=torch.int32, device=device)
    return {
        "key": key,
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "buffer": _fill(cfg, key, 0, batch, seq, PREFETCH),
        "cursor": torch.zeros((), dtype=torch.int32, device=device),
    }


def _synth_tokens(cfg, gen: torch.Generator, batch: int, seq: int,
                  device) -> torch.Tensor:
    """Learnable synthetic stream: successor runs with random restarts.

    90 % of positions follow t+1 = t + 1 (mod V); 10 % jump to a random
    token.  A model that learns the successor rule reaches ≪ uniform
    cross-entropy, so training-loss decrease is a meaningful signal."""
    jumps = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                          device=device, dtype=torch.int64)
    is_jump = torch.rand((batch, seq), generator=gen, device=device) < 0.1
    start = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                          device=device, dtype=torch.int64)
    # segment-wise: token = (value at last jump) + distance since jump
    idx = torch.arange(seq, device=device)[None, :]
    jump_pos = torch.where(is_jump, idx, torch.full_like(idx, -1))
    last_jump = torch.cummax(jump_pos, dim=1).values
    since = torch.clamp(last_jump, min=0)
    seg_val = torch.where(last_jump >= 0, torch.gather(jumps, 1, since),
                          start)
    return ((seg_val + (idx - since)) % cfg.vocab).to(torch.int32)


def _fill(cfg, key, start_step, batch, seq, n):
    return torch.stack([_synth_tokens(cfg, _generator(key, start_step + i),
                                      batch, seq, key.device)
                        for i in range(n)])


def _slot(state) -> torch.Tensor:
    """The ring-buffer slot under the cursor, as a (1,) index on the
    state's device (no host read, so a traced step can hold it)."""
    return state["cursor"].remainder(PREFETCH).reshape(1).long()


def peek_batch(cfg, state) -> Dict[str, torch.Tensor]:
    """The batch ``next_batch`` pops, without the refill: the one part of
    the pipeline a training step's loss reads."""
    del cfg
    tokens = state["buffer"].index_select(0, _slot(state))[0]
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def next_batch(cfg, state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Pop one batch; refill the consumed slot deterministically.  The
    state passed in is not written."""
    batch = peek_batch(cfg, state)
    tokens = batch["tokens"]
    step = state["step"] + 1
    gen = _generator(state["key"], int(step) + PREFETCH - 1)
    new_slot = torch.randint(0, cfg.vocab, tuple(tokens.shape),
                             generator=gen, device=tokens.device,
                             dtype=torch.int32)
    buf = state["buffer"].index_copy(0, _slot(state), new_slot[None])
    cur = state["cursor"]
    return batch, {"key": state["key"], "step": step, "buffer": buf,
                   "cursor": cur + 1}


def consume_resume_fn(cfg, n_steps: int):
    """Returns fn(state) -> outputs for scrutinize(): 'the rest of the
    program' consumes ``n_steps`` batches."""

    def fn(state):
        s = state
        outs = []
        for _ in range(n_steps):
            b, s = next_batch(cfg, s)
            outs.append(b["tokens"])
        return {"consumed": torch.stack(outs)}

    return fn
