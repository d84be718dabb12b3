"""Batched decode engine with a scrutinizable, checkpointable state (port
of ``repro.serve.engine``).

The engine state ``{"cache", "pos" (0-d int32), "tokens" ((B, 1) int32)}``
is the paper's "variables necessary for checkpointing" for serving:
restarting a long decode from a mid-stream failure.  ``resume_fn`` exposes
"the rest of the program" (N more decode steps) to ``scrutinize``, which
proves the cache slots beyond ``pos`` uncritical.

The engine runs on the card unless ``device="cpu"`` is asked for; its
parameters must lie there.  It keeps one copy of the parameters with every
matrix cast to the compute dtype (``models.compute_params``), made once:
the cast is exact, so the numbers are those of casting at every matmul.
Every call is functional: a step returns a new state and never writes the
old one (the cache is rebuilt out of place), as the reference's does and
as ``torch.func`` needs for ``resume_fn``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch._tensors import check_on, resolve_device
from repro_torch.models import model


def _next_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy choice as (B, 1) int32 (argmax gives int64)."""
    return logits.argmax(-1)[:, None].to(torch.int32)


class Engine:
    def __init__(self, cfg, params, max_len: int, device=None):
        self.device = resolve_device(device)
        want = model.init_params(cfg, None, device="meta")
        got = _tree.flatten_with_names(params)[0]
        shapes = {n: tuple(l.shape) for n, l in
                  _tree.flatten_with_names(want)[0]}
        if {n: tuple(l.shape) for n, l in got} != shapes:
            raise ValueError(f"Engine: parameters do not match the tree of "
                             f"init_params for {cfg.name}")
        for name, leaf in got:
            check_on(leaf, self.device, f"Engine parameter {name!r}")
        self.cfg = cfg
        self.params = params
        self.max_len = int(max_len)
        self._compute = model.compute_params(cfg, params)
        self._resume_fns: Dict[int, Any] = {}

    def prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill ``batch`` (``tokens`` (B, T) int32, and ``frames`` for
        an encoder-decoder, ``patch_embeds`` (B, P, d) and ``positions``
        for a VLM) → (last-position logits (B, V), the engine state at
        the prefilled length with the greedy first token).

        ``pos`` is the length of the sequence the cache holds, P + T for a
        VLM batch, whose patches the prefill puts ahead of the text; the
        reference's engine sets the text length T (``serve/engine.py:
        39-41``), so its first decode step overwrites slot T and attends to
        T + 1 slots (ROADMAP Queue 3)."""
        for name, t in batch.items():
            check_on(t, self.device, f"Engine.prefill {name}")
        with torch.no_grad():
            logits, cache = model.prefill(self.cfg, self._compute, batch,
                                          self.max_len)
        length = batch["tokens"].shape[1]
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            length += batch["patch_embeds"].shape[1]
        return logits, {"cache": cache,
                        "pos": torch.tensor(length, dtype=torch.int32,
                                            device=self.device),
                        "tokens": _next_tokens(logits)}

    def start(self, batch) -> Dict[str, Any]:
        """The engine state after prefilling ``batch``."""
        return self.prefill(batch)[1]

    def decode(self, state, tokens: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step → (logits (B, V), next state).  It feeds
        ``tokens`` (B, 1) when given (forced), else ``state["tokens"]``;
        the next state's ``tokens`` are the greedy choice."""
        fed = state["tokens"] if tokens is None else tokens
        with torch.no_grad():
            logits, cache = model.decode_step(self.cfg, self._compute,
                                              state["cache"], fed,
                                              state["pos"])
        return logits, {"cache": cache, "pos": state["pos"] + 1,
                        "tokens": _next_tokens(logits)}

    def step(self, state) -> Tuple[Dict[str, Any], torch.Tensor]:
        """One greedy step → (next state, its tokens (B,))."""
        _, nxt = self.decode(state)
        return nxt, nxt["tokens"][:, 0]

    def generate(self, batch, n_tokens: int,
                 forced: Optional[torch.Tensor] = None):
        """Prefill, then decode up to ``n_tokens`` tokens in all.  Returns
        (greedy tokens (B, n_tokens), final state, logits (n_tokens, B, V)).
        With ``forced`` (B, n_tokens - 1) the i-th decode step feeds
        ``forced[:, i]`` instead of the greedy token, so two engines can be
        compared logit by logit without argmax near-ties steering them
        apart."""
        logits, state = self.prefill(batch)
        toks, all_logits = [state["tokens"][:, 0]], [logits]
        for i in range(n_tokens - 1):
            fed = None if forced is None else forced[:, i:i + 1]
            logits, state = self.decode(state, fed)
            toks.append(state["tokens"][:, 0])
            all_logits.append(logits)
        return torch.stack(toks, dim=1), state, torch.stack(all_logits)

    # --- checkpoint integration ---------------------------------------

    def resume_fn(self, n_steps: int):
        """(engine state) → decode outputs; the scrutiny target.  Pure:
        ``torch.func.vjp`` differentiates it with respect to the cache.
        The outputs are the steps' logits and, where the model has
        Mamba-2 layers, their state after the last step
        (``model.carried_state``).

        The cache enters in f32.  Every value a decode step writes is
        computed in the compute dtype and stored exactly either way, so the
        logits are the engine's; but autograd sums the gradient a slot gets
        from each step that reads it in the cache's dtype, and in bf16 (8
        significant bits) two such terms cancel to exactly zero often
        enough that, among the millions of elements of a full-width cache,
        some critical element reads as uncritical in every probe.  In f32
        the sum is rounded once, at the leaf.

        One function per ``n_steps`` for the engine's life, so caches kept
        per function (the shared trace) hit across scrutinies."""
        if n_steps in self._resume_fns:
            return self._resume_fns[n_steps]
        cfg, compute = self.cfg, self._compute    # no cycle through self

        def fn(state):
            named, treedef = _tree.flatten_with_names(state["cache"])
            s = dict(state, cache=_tree.unflatten(
                treedef, [c.float() for _, c in named]))
            logits_all = []
            for _ in range(n_steps):
                logits, cache = model.decode_step(
                    cfg, compute, s["cache"], s["tokens"], s["pos"])
                s = {"cache": cache, "pos": s["pos"] + 1,
                     "tokens": _next_tokens(logits)}
                logits_all.append(logits)
            out = {"logits": torch.stack(logits_all)}
            carried = model.carried_state(cfg, s["cache"])
            if carried:         # Mamba-2 state, read whole past the horizon
                out["carried"] = carried
            return out

        self._resume_fns[n_steps] = fn
        return fn
