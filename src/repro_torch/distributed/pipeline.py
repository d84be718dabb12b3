"""GPipe-style pipeline parallelism over homogeneous block stacks (port of
``repro.distributed.pipeline``).

One process per stage, in a ``torch.distributed`` group whose ranks are
the stages in order; each holds its stage's parameters.  Microbatches
stream through the stages tick by tick: at tick t stage s runs microbatch
t - s when that index lies in [0, M), and hands its activation to stage
s + 1.  The run takes M + S - 1 ticks, and each stage idles S - 1 of them:
the bubble fraction is (S - 1) / (M + S - 1).

The hand-offs are autograd Functions: the forward sends an activation
downstream, the backward sends its cotangent upstream, so
``loss.backward()`` on every rank gives each stage its parameters'
gradients and stage 0 the gradient of ``x``.  Each stage's hand-offs are
chained in tick order by a token (a 0-d tensor that carries no value), so
its backward runs them in reverse tick order whatever order autograd
would pick: every stage sends and receives the cotangents in the same
order, microbatch M - 1 first.  On a gloo group the activations and
cotangents cross through pinned host memory (``distributed/exchange.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import exchange


def bubble_fraction(n_stages: int, n_microbatch: int) -> float:
    return (n_stages - 1) / (n_microbatch + n_stages - 1)


class _Send(torch.autograd.Function):
    """Forward: send ``act`` to ``dst``; backward: receive its cotangent
    from ``dst``.  Returns the next token."""

    @staticmethod
    def forward(ctx, act, token, dst, tag, group):
        exchange.send(act.detach(), dst, tag, group)
        ctx.meta = (act.shape, act.dtype, act.device, dst, tag, group)
        return token.detach().clone()

    @staticmethod
    def backward(ctx, g_token):
        shape, dtype, device, dst, tag, group = ctx.meta
        g = exchange.recv(shape, dtype, device, dst, tag, group)
        return g, g_token, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation from ``src``; backward: send its
    cotangent to ``src``.  Returns (activation, next token)."""

    @staticmethod
    def forward(ctx, token, like, src, tag, group):
        ctx.meta = (src, tag, group)
        act = exchange.recv(like.shape, like.dtype, like.device, src, tag,
                            group)
        return act, token.detach().clone()

    @staticmethod
    def backward(ctx, g_act, g_token):
        src, tag, group = ctx.meta
        exchange.send(g_act.contiguous(), src, tag, group)
        return g_token, None, None, None, None


class _Gather(torch.autograd.Function):
    """The last stage's outputs onto every rank.  Backward: the last
    stage takes the cotangent of its own outputs; the others pass a zero
    to their token, which sets off their chain of hand-offs."""

    @staticmethod
    def forward(ctx, outs, token, src, group):
        ctx.is_src = dist.get_rank() == src
        result = outs.detach().clone()
        dist.broadcast(result, src=src, group=group)
        return result

    @staticmethod
    def backward(ctx, g_out):
        if ctx.is_src:
            return g_out, None, None, None
        return None, torch.zeros(()), None, None


def gpipe_apply(group, block_fn: Callable, stage_params, x: torch.Tensor,
                n_microbatch: int) -> torch.Tensor:
    """Run the S stages of ``group`` over ``x`` (M, mb, T, d) → the last
    stage's outputs (M, mb, T, d) in microbatch order, on every rank.

    ``stage_params``: this rank's stage's parameters; ``block_fn(params,
    x) -> x`` keeps the activation's shape and dtype.  ``x`` is passed on
    every rank; only stage 0 reads it.  ``group``: the stages' group (the
    default group for None), stage s its rank s.  Gradients: the last
    stage's cotangent of the outputs flows back through every stage (the
    other ranks' cotangents of their copies are not used: every rank sees
    the same outputs, as one replicated result)."""
    S = exchange.group_size(group)
    M = int(n_microbatch)
    if x.shape[0] != M:
        raise ValueError(f"x holds {x.shape[0]} microbatches, not {M}")
    s = exchange.rank_of(group) or 0
    ranks = ([dist.get_global_rank(group, r) if group is not None else r
              for r in range(S)] if S > 1 else [0])
    token = torch.zeros((), requires_grad=True)
    like = x[0]
    outs = [None] * M
    for t in range(M + S - 1):
        mb = t - s
        if not 0 <= mb < M:
            continue
        if s == 0:
            inp = x[mb]
        else:
            inp, token = _Recv.apply(token, like, ranks[s - 1], mb, group)
        out = block_fn(stage_params, inp)
        if s < S - 1:
            token = _Send.apply(out, token, ranks[s + 1], mb, group)
        else:
            outs[mb] = out
    if S == 1:
        return torch.stack(outs)
    full = (torch.stack(outs) if s == S - 1
            else torch.empty_like(x))
    return _Gather.apply(full, token, ranks[S - 1], group)
