"""Plain PyTorch version of K6 (port of
``repro.kernels.flash_attention.ref.flash_attention_ref``).

The CPU tests use it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.  It repeats the reference's arithmetic: scores in f32,
the tanh softcap, the finite ``_NEG`` mask and one softmax over the row.
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
        ok &= qi >= ki
    if window is not None:
        ok &= qi - ki < window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)
