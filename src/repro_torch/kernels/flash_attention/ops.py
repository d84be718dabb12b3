"""Public entry for flash attention: K6 on the card, the plain version on
the CPU.

``flash_attention(q, k, v, *, window, causal, scale, attn_cap)`` serves
the train/prefill contract (positions are arange).  Unlike ``repro``'s
entry (``kernels/flash_attention/ops.py:36-49``) there is no padding step
and no small-T branch: the kernel takes any T >= 1 and masks the ragged
edge itself, so a non-causal call never attends to padded keys.

The forward and the backward are custom ops,
``repro_torch::flash_attention`` and ``repro_torch::flash_attention_
backward``: their CUDA implementations launch K6's kernels, their CPU
implementations run the plain version (``flash_attention_ref``; the
backward: autograd's gradient through it).  So a traced step
(``core/taint.py``) holds one node per call on either device instead of a
kernel it cannot see.  A call that autograd can reach goes through
:class:`FlashAttention`, whose forward also has the card write the row
log-sum-exp (and, for 16-bit inputs, the f32 output) that its backward
reads; the others (the serving prefill under ``no_grad``) call the
forward op alone.  There is no fallback between the devices.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _none(q: torch.Tensor) -> torch.Tensor:
    """An absent output: custom ops return tensors, each its own."""
    return q.new_empty(0, dtype=torch.float32)


# The ops are defined on the dispatcher directly (``torch.library.Library``):
# ``torch.library.custom_op`` adds Python layers to every call and imports
# ``torch._dynamo`` at a process's first call.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, float scale, "
            "bool causal, int? window, float? attn_cap, bool with_lse) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("flash_attention_backward(Tensor q, Tensor k, Tensor v, "
            "Tensor o, Tensor lse, Tensor do, float scale, bool causal, "
            "int? window, float? attn_cap) -> (Tensor, Tensor, Tensor)")


def _attention_card(q, k, v, scale, causal, window, attn_cap, with_lse):
    """K6 forward → (o, lse, o32).  ``with_lse``: the card also writes the
    row log-sum-exp (B,H,Tq) f32 and, for 16-bit inputs, o in f32 before
    its rounding, what the backward reads; otherwise, and for o32 of f32
    inputs, they are empty."""
    if not with_lse:
        return (K.flash_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, attn_cap=attn_cap),
                _none(q), _none(q))
    o, lse, o32 = K.flash_attention(q, k, v, scale=scale, causal=causal,
                                    window=window, attn_cap=attn_cap,
                                    with_lse=True)
    return o, lse, _none(q) if o32 is None else o32


def _attention_plain(q, k, v, scale, causal, window, attn_cap, with_lse):
    return (flash_attention_ref(q, k, v, window=window, causal=causal,
                                scale=scale, attn_cap=attn_cap),
            _none(q), _none(q))


def _attention_fake(q, k, v, scale, causal, window, attn_cap, with_lse):
    B, Tq, H, _ = q.shape
    o = q.new_empty((B, Tq, H, v.shape[-1]))
    card = with_lse and q.device.type == "cuda"
    lse = q.new_empty((B, H, Tq) if card else (0,), dtype=torch.float32)
    o32 = q.new_empty(o.shape if card and q.dtype != torch.float32
                      else (0,), dtype=torch.float32)
    return o, lse, o32


def _attention_backward_card(q, k, v, o, lse, do, scale, causal, window,
                             attn_cap):
    """K6 backward → (dq, dk, dv), from the forward's o (in f32) and lse."""
    return K.flash_attention_backward(
        q, k, v, o, lse, do, scale=scale, causal=causal, window=window,
        attn_cap=attn_cap)


def _attention_backward_plain(q, k, v, o, lse, do, scale, causal, window,
                              attn_cap):
    def ref(q, k, v):
        return flash_attention_ref(q, k, v, window=window, causal=causal,
                                   scale=scale, attn_cap=attn_cap)

    with _functorch_keys(), torch.enable_grad():
        grads = torch.func.vjp(ref, q, k, v)[1](do)
    return tuple(g.detach() for g in grads)


def _functorch_keys():
    """Inside a ``TorchDispatchMode``'s handler (an accounting or tracing
    mode that runs the op) every dispatch key above Python is excluded,
    functorch's and autograd's among them, and ``torch.func.vjp`` fails;
    there, let those through again (the Python keys stay excluded, so the
    plain backward's own ops reach no mode).  Elsewhere nothing changes."""
    C = torch._C
    if not C._dispatch_tls_is_dispatch_key_excluded(
            C.DispatchKey.FuncTorchDynamicLayerFrontMode):
        return contextlib.nullcontext()
    exclude = C._dispatch_tls_local_exclude_set()
    for key in _VJP_KEYS:
        exclude = exclude.remove(key)
    return C._ForceDispatchKeyGuard(C._dispatch_tls_local_include_set(),
                                    exclude)


_VJP_KEYS = tuple(getattr(torch._C.DispatchKey, k) for k in (
    "FuncTorchDynamicLayerFrontMode", "FuncTorchDynamicLayerBackMode",
    "FuncTorchGradWrapper", "ADInplaceOrView", "AutogradOther",
    "AutogradFunctionality"))


def _attention_backward_fake(q, k, v, o, lse, do, scale, causal, window,
                             attn_cap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


for _name, _card, _plain, _fake in (
        ("flash_attention", _attention_card, _attention_plain,
         _attention_fake),
        ("flash_attention_backward", _attention_backward_card,
         _attention_backward_plain, _attention_backward_fake)):
    _LIB.impl(_name, _card, "CUDA")
    _LIB.impl(_name, _plain, "CPU")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)
attention_op = torch.ops.repro_torch.flash_attention.default
attention_backward_op = torch.ops.repro_torch.flash_attention_backward.default


# FLOP formulas, so that any ``FlopCounterMode`` (and the dry run's
# accounting, ``launch/graph_analysis.py``) counts K6.  The context a
# query attends to is ``model_flops``'s: ``min(window, Tk)`` keys for a
# windowed call, ``Tk / 2`` for a causal one, ``Tk`` otherwise; not the
# exact count of unmasked pairs, nor the kernel's whole tiles.  The
# forward is QKᵀ and PV; the backward follows the registry's formula for
# SDPA's backward: the recomputed QKᵀ, dP = dO·Vᵀ, dV, dQ and dK.
def _pair_flops(q_shape, k_shape, causal, window) -> int:
    """2 × (query, key) pairs attended, per unit of head width."""
    B, Tq, H, _ = q_shape
    Tk = k_shape[1]
    if window:
        return 2 * B * H * Tq * min(window, Tk)
    if causal:
        return B * H * Tq * Tk
    return 2 * B * H * Tq * Tk


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _attention_flops(q, k, v, scale, causal, window, attn_cap, with_lse,
                     *args, out_shape=None, **kwargs) -> int:
    return _pair_flops(q, k, causal, window) * (q[-1] + v[-1])


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _attention_backward_flops(q, k, v, o, lse, do, scale, causal, window,
                              attn_cap, *args, out_shape=None,
                              **kwargs) -> int:
    return _pair_flops(q, k, causal, window) * (3 * q[-1] + 2 * v[-1])


class FlashAttentionBackward(torch.autograd.Function):
    """K6's backward kernels as a Function of their own, so that
    :class:`FlashAttention`'s backward is made of Functions that
    ``torch.func`` can run at any transform level (its forward always sees
    plain tensors).  No second derivative is taken through it."""

    @staticmethod
    def forward(q, k, v, o, lse, do, scale, causal, window, attn_cap):
        return attention_backward_op(q, k, v, o, lse, do.contiguous(),
                                     scale, causal, window, attn_cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention: no second derivative through "
                           "K6")


class FlashAttention(torch.autograd.Function):
    """The forward op with the row log-sum-exp (and, for 16-bit inputs, the
    f32 output) saved for the backward, which is
    :class:`FlashAttentionBackward`.  Written in the forward /
    ``setup_context`` form, which lets ``torch.func.vjp`` (the scrutiny)
    run it.  It returns the forward op's (o, lse, o32)."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, attn_cap):
        return attention_op(q, k, v, scale, causal, window, attn_cap, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale, ctx.causal, ctx.window, ctx.attn_cap = inputs
        o, lse, o32 = output
        ctx.mark_non_differentiable(lse, o32)
        ctx.save_for_backward(q, k, v, o if o32.numel() == 0 else o32, lse)

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
    if kinds not in ({"cpu"}, {"cuda"}):
        raise RuntimeError(f"flash_attention: tensors on {sorted(kinds)}; "
                           "it takes CUDA tensors (kernel) or CPU tensors "
                           "(plain version), not a mix")
    return _route(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                  causal, window, attn_cap)


def _route(q, k, v, scale, causal, window, attn_cap):
    """A call autograd can reach (grad mode on and an input that requires
    grad, as under ``torch.func.vjp``) goes through
    :class:`FlashAttention`, whose forward also writes what the backward
    reads; otherwise the forward op runs alone, as in the serving prefill
    under ``no_grad``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, causal, window,
                                    attn_cap)[0]
    return attention_op(q, k, v, scale, causal, window, attn_cap, False)[0]
