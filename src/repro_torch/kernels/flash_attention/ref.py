"""Plain PyTorch version of K6 (port of
``repro.kernels.flash_attention.ref.flash_attention_ref``).

The CPU tests use it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.  It repeats the reference's arithmetic: scores in f32,
the tanh softcap, the finite ``_NEG`` mask and one softmax over the row.

Beside it, the controls in K6's order of summation
(:func:`flash_attention_tiled`, :class:`TiledAttention`): the same
function over the kernels' key tiles, in f32.  ``chip_smoke.py`` bounds
K6's distance from the plain version by a multiple of theirs.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -2.3819763e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: Optional[int] = None, causal: bool = True,
                        scale: Optional[float] = None,
                        attn_cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Tq,H,D) k: (B,Tk,K,D) v: (B,Tk,K,Dv); positions are arange
    (train/prefill contract).  Returns (B,Tq,H,Dv) in q.dtype."""
    B, Tq, H, D = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = D ** -0.5
    qf = (q.float() * scale).reshape(B, Tq, K, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if attn_cap is not None:
        s = attn_cap * torch.tanh(s / attn_cap)
    qi = torch.arange(Tq, device=q.device)[:, None]
    ki = torch.arange(Tk, device=q.device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (qi >= ki)
    if window is not None:
        ok = ok & (qi - ki < window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


# The controls below repeat K6's order of summation in plain f32 torch ops:
# their key tiles are the bf16 kernels' (csrc/flash_attention.cu:
# kTcFwdKeys for the forward; kTcDqKeys, and the dK/dV pass's 64 keys a
# block, for the backward).
FWD_KEY_TILE = 64
BWD_KEY_TILE = 64


def _tile_mask(Tq: int, k0: int, k1: int, window: Optional[int],
               causal: bool, device) -> torch.Tensor:
    qi = torch.arange(Tq, device=device)[:, None]
    ki = torch.arange(k0, k1, device=device)[None, :]
    ok = torch.ones((Tq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (qi >= ki)
    if window is not None:
        ok = ok & (qi - ki < window)
    return ok


def flash_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: Optional[int] = None,
                          causal: bool = True, scale: Optional[float] = None,
                          attn_cap: Optional[float] = None,
                          stats: bool = False):
    """flash_attention_ref's function in K6's order: S = (q . k^T) * scale
    in f32, an online softmax over ``FWD_KEY_TILE``-key tiles, l floored
    at 1e-37.  → (B,Tq,H,Dv) in q.dtype; with ``stats`` → (o in f32, row
    log-sum-exp (B,H,Tq)), what K6's backward reads."""
    B, Tq, H, D = q.shape
    Tk, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Tq, K, H // K, D)
    m = torch.full((B, K, H // K, Tq), _NEG, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (Dv,), device=dev)
    for k0 in range(0, Tk, FWD_KEY_TILE):
        kt = k[:, k0:k0 + FWD_KEY_TILE].float()
        vt = v[:, k0:k0 + FWD_KEY_TILE].float()
        s = torch.einsum("btkgd,bskd->bkgts", qf, kt) * scale
        if attn_cap is not None:
            s = attn_cap * torch.tanh(s / attn_cap)
        ok = _tile_mask(Tq, k0, k0 + kt.shape[1], window, causal, dev)
        s = torch.where(ok, s, torch.full((), _NEG, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgts,bskd->bkgtd", p,
                                                   vt)
        m = m_new
    denom = l.clamp_min(1e-37)
    o = (acc / denom[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Tq, H,
                                                                Dv)
    if stats:
        return o, (m + torch.log(denom)).reshape(B, H, Tq)
    return o.to(q.dtype)


class TiledAttention(torch.autograd.Function):
    """:func:`flash_attention_tiled` with K6's backward in the same plain
    f32 ops: P from the row log-sum-exp, Dl = dO . O from the f32 output,
    dQ summed over ``BWD_KEY_TILE``-key tiles in order, dK and dV per key
    tile, scale applied to dQ and dK at the end.  The control that
    ``chip_smoke.py`` holds K6's gradients against; in the forward /
    ``setup_context`` form that ``torch.func.vjp`` runs."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, attn_cap):
        o32, lse = flash_attention_tiled(q, k, v, window=window,
                                         causal=causal, scale=scale,
                                         attn_cap=attn_cap, stats=True)
        # a copy even in f32, or marking o32 non-differentiable would mark
        # the output too
        return o32.to(q.dtype, copy=True), lse, o32

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale, ctx.causal, ctx.window, ctx.cap = inputs
        _, lse, o32 = output
        ctx.mark_non_differentiable(lse, o32)
        ctx.save_for_backward(q, k, v, o32, lse)

    @staticmethod
    def backward(ctx, do, _dlse, _do32):
        q, k, v, o32, lse = ctx.saved_tensors
        B, Tq, H, D = q.shape
        Tk, K = k.shape[1], k.shape[2]
        G = H // K
        dev = q.device
        qf = q.float().reshape(B, Tq, K, G, D)
        dof = do.float().reshape(B, Tq, K, G, -1)
        lse = lse.reshape(B, K, G, Tq)
        dl = (do.float() * o32).sum(-1).permute(0, 2, 1).reshape(B, K, G, Tq)
        dq = torch.zeros(qf.shape, device=dev)
        dk = torch.zeros(k.shape, device=dev)
        dv = torch.zeros(v.shape, device=dev)
        for k0 in range(0, Tk, BWD_KEY_TILE):
            kt = k[:, k0:k0 + BWD_KEY_TILE].float()
            vt = v[:, k0:k0 + BWD_KEY_TILE].float()
            s = torch.einsum("btkgd,bskd->bkgts", qf, kt) * ctx.scale
            dtanh = 1.0
            if ctx.cap is not None:
                th = torch.tanh(s / ctx.cap)
                s, dtanh = ctx.cap * th, 1 - th * th
            ok = _tile_mask(Tq, k0, k0 + kt.shape[1], ctx.window, ctx.causal,
                            dev)
            p = torch.where(ok, torch.exp(s - lse[..., None]),
                            torch.zeros((), device=dev))
            dp = torch.einsum("btkgd,bskd->bkgts", dof, vt)
            ds = p * (dp - dl[..., None]) * dtanh
            dq += torch.einsum("bkgts,bskd->btkgd", ds, kt)
            dk[:, k0:k0 + BWD_KEY_TILE] = torch.einsum(
                "bkgts,btkgd->bskd", ds, qf) * ctx.scale
            dv[:, k0:k0 + BWD_KEY_TILE] = torch.einsum("bkgts,btkgd->bskd",
                                                       p, dof)
        dq = (dq * ctx.scale).reshape(q.shape)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def tiled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, causal: bool = True,
                    scale: Optional[float] = None,
                    attn_cap: Optional[float] = None) -> torch.Tensor:
    """:class:`TiledAttention`'s output, with its gradient in K6's order."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return TiledAttention.apply(q, k, v, scale, causal, window, attn_cap)[0]
