"""GQA/MQA attention with sliding window and logit softcap (port of the GQA
part of ``repro.models.attention``).

Two execution paths:
- ``_dispatch_attend`` (training forward and prefill) always calls the
  port's ``flash_attention``: K6 on the card, its plain version on the
  CPU.  It is the port's counterpart of ``set_attn_impl("pallas")``; the
  reference's auto/full/chunked switch and ``_FULL_THRESHOLD`` tune XLA on
  a TPU and are not ported.
- ``_attend_full``: einsum attention against the cache for one decode
  token, plain tensor code as in the reference (``attention.py:285``).

Caches:
- global layers: ``{"k": (B, S, K, D), "v": (B, S, K, D)}``
- local (window) layers: same layout with S = window (ring buffer)

Decode writes the new token's K/V out of place (``index_copy``), so the
engine's ``resume_fn`` stays functional for ``torch.func``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._tensors import alloc_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       softcap)

_NEG = -2.3819763e38  # finite big-negative (bf16-safe), as the reference
_POS_NONE = 2 ** 31 - 1  # int32 max: the position of a slot never attended


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_attention(cfg, gen, *, lead: Tuple[int, ...] = (),
                   device=None) -> Dict[str, Any]:
    pdt = dtype_of(cfg.param_dtype)
    hd = cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, pdt, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, pdt, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, pdt, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, pdt, **kw),
    }
    if cfg.qkv_bias:
        dev = device or gen.device
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(lead + (n * hd,), dtype=pdt, device=dev)
    return p


# --------------------------------------------------------------------------
# core attention maths
# --------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int], causal: bool) -> torch.Tensor:
    """(..., Tq, Tk) additive f32 bias from position tensors."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, _NEG)


def _attend_full(q, k, v, bias, scale, attn_cap):
    """q: (B,Tq,H,D) k: (B,Tk,K,D) v: (B,Tk,K,Dv) bias: (B,Tq,Tk) fp32."""
    B, Tq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = (q.float() * scale).reshape(B, Tq, K, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    s = softcap(s, attn_cap)
    s = s + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


def _dispatch_attend(q, k, v, window, causal, scale, attn_cap):
    """Sequence attention under the train/prefill contract (positions are
    arange): K6 on the card, the plain version on the CPU."""
    return flash_attention(q, k, v, window=window, causal=causal,
                           scale=scale, attn_cap=attn_cap)


# --------------------------------------------------------------------------
# GQA layer entry points
# --------------------------------------------------------------------------

def _project_qkv(cfg, p, x, positions):
    dt = x.dtype
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(cfg, p, x, positions, *, window=None, causal=True):
    """Full-sequence self-attention (training / prefill without cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = _dispatch_attend(q, k, v, window, causal,
                         cfg.resolved_head_dim ** -0.5, cfg.attn_softcap)
    B, T = x.shape[:2]
    return o.reshape(B, T, -1) @ p["wo"].to(x.dtype)


def init_cache(cfg, batch: int, max_len: int, *, window=None, dtype=None,
               lead: Tuple[int, ...] = (), device=None):
    """Zero K/V caches on ``device``: the card unless the caller asks for
    the CPU."""
    device = alloc_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    S = min(window, max_len) if window else max_len
    shape = lead + (batch, S, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(cfg, p, x, cache, pos, *, window=None):
    """One-token decode against a (possibly ring-buffered) cache.

    x: (B, 1, d); pos: 0-d int32 tensor — current position (same across
    batch, standard batched-decode contract).  Returns (out, new_cache);
    the cache is never written in place.
    """
    B = x.shape[0]
    positions = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    q, k, v = _project_qkv(cfg, p, x, positions)
    S = cache["k"].shape[1]
    slot = (pos % S) if window else pos
    idx = slot.reshape(1).long()
    ck = cache["k"].index_copy(1, idx, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, idx, v.to(cache["v"].dtype))
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    none = torch.full((), _POS_NONE, dtype=torch.int32, device=x.device)
    if window:
        # ring buffer: absolute position of slot s given write head at pos.
        # Slots not yet written (pos < S) resolve to negative positions —
        # mask them or they'd attend to zero vectors.
        k_pos = pos - ((slot - ar) % S)
        k_pos = torch.where(k_pos >= 0, k_pos, none)
    else:
        k_pos = torch.where(ar <= pos, ar, none)
    k_pos = k_pos[None, :].expand(B, S).to(torch.int32)
    o = _attend_full(q, ck, cv, _mask_bias(positions, k_pos, window, True),
                     cfg.resolved_head_dim ** -0.5, cfg.attn_softcap)
    out = o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, {"k": ck, "v": cv}
