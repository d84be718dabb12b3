"""Public entry for flash attention: K6 on the card, the plain version on
the CPU.

``flash_attention(q, k, v, *, window, causal, scale, attn_cap)`` serves
the train/prefill contract (positions are arange).  CUDA tensors that
autograd can reach go through :class:`FlashAttention`, whose forward is
K6's forward kernel and whose backward is K6's backward kernels, and the
others through the forward kernel alone; CPU tensors take
``flash_attention_ref`` and autograd's gradient through it.  There is no
fallback between the two.  Unlike ``repro``'s entry
(``kernels/flash_attention/ops.py:36-49``) there is no padding step and no
small-T branch: the kernel takes any T >= 1 and masks the ragged edge
itself, so a non-causal call never attends to padded keys.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionBackward(torch.autograd.Function):
    """K6's backward kernels as a Function of their own, so that
    :class:`FlashAttention`'s backward is made of Functions that
    ``torch.func`` can run at any transform level (its forward always sees
    plain tensors).  No second derivative is taken through it."""

    @staticmethod
    def forward(q, k, v, o, lse, do, scale, causal, window, attn_cap):
        return K.flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), scale=scale, causal=causal,
            window=window, attn_cap=attn_cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention: no second derivative through "
                           "K6")


class FlashAttention(torch.autograd.Function):
    """K6 forward, saving its row log-sum-exp and its output in f32; the
    backward is :class:`FlashAttentionBackward`.  Written in the forward /
    ``setup_context`` form, which lets ``torch.func.vjp`` (the scrutiny)
    run it."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, attn_cap):
        return K.flash_attention(q, k, v, scale=scale, causal=causal,
                                 window=window, attn_cap=attn_cap,
                                 with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale, ctx.causal, ctx.window, ctx.attn_cap = inputs
        o, lse, o32 = output
        ctx.mark_non_differentiable(lse, *([] if o32 is None else [o32]))
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, lse)

    @staticmethod
    def backward(ctx, do, _dlse, _do32):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(
            q, k, v, o, lse, do, ctx.scale, ctx.causal, ctx.window,
            ctx.attn_cap)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, causal: bool = True,
                    scale: Optional[float] = None,
                    attn_cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Tq,H,D) k: (B,Tk,K,D) v: (B,Tk,K,Dv) → (B,Tq,H,Dv) in
    q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_ref(q, k, v, window=window, causal=causal,
                                   scale=scale, attn_cap=attn_cap)
    if kinds == {"cuda"}:
        return _on_card(q.contiguous(), k.contiguous(), v.contiguous(),
                        scale, causal, window, attn_cap)
    raise RuntimeError(f"flash_attention: tensors on {sorted(kinds)}; it "
                       "takes CUDA tensors (kernel) or CPU tensors (plain "
                       "version), not a mix")


def _on_card(q, k, v, scale, causal, window, attn_cap):
    """K6 where autograd can reach the call (grad mode on and an input
    that requires grad, as under ``torch.func.vjp``) goes through
    :class:`FlashAttention`, whose forward also writes the row
    log-sum-exp (and, for 16-bit inputs, the f32 output) that the backward
    reads; otherwise the forward kernel runs alone, as in the serving
    prefill under ``no_grad``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, causal, window,
                                    attn_cap)[0]
    return K.flash_attention(q, k, v, scale=scale, causal=causal,
                             window=window, attn_cap=attn_cap)
