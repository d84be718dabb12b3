"""Attention (port of ``repro.models.attention``): GQA/MQA with sliding
window, logit softcap and M-RoPE, and DeepSeek-style MLA with a
compressed-latent KV cache for decode.

Two execution paths:
- ``_dispatch_attend`` (training forward and prefill) always calls the
  port's ``flash_attention``: K6 on the card, its plain version on the
  CPU.  It is the port's counterpart of ``set_attn_impl("pallas")``; the
  reference's auto/full/chunked switch and ``_FULL_THRESHOLD`` tune XLA on
  a TPU and are not ported.  K6 masks by index, as the reference's Pallas
  entry does (``kernels/flash_attention/ops.py:27``): where a batch gives
  ``positions``, their first (temporal) axis must increase along the
  sequence, so that the reference's position mask is the index mask.
- ``_attend_full``: einsum attention against the cache for one decode
  token, plain tensor code as in the reference (``attention.py:285``);
  MLA's latent decode is plain tensor code too (``mla_decode``).

Caches:
- global layers: ``{"k": (B, S, K, D), "v": (B, S, K, D)}``
- local (window) layers: same layout with S = window (ring buffer)
- MLA layers: ``{"c_kv": (B, S, R), "k_pe": (B, S, Dr)}`` — the latent
  cache; decode absorbs the up-projections (the paper's W_UK/W_UV trick).

Decode writes the new token's K/V (or latent row) out of place
(``index_copy``), so the engine's ``resume_fn`` stays functional for
``torch.func``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._tensors import alloc_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       dot, dtype_of, softcap)

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
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        H = cfg.n_heads
        return {
            "wq_a": dense_init(gen, cfg.d_model, m.q_lora_rank, pdt, **kw),
            "wq_b": dense_init(gen, m.q_lora_rank, H * qk_dim, pdt, **kw),
            "wkv_a": dense_init(gen, cfg.d_model,
                                m.kv_lora_rank + m.qk_rope_head_dim, pdt,
                                **kw),
            "wk_b": dense_init(gen, m.kv_lora_rank,
                               H * m.qk_nope_head_dim, pdt, **kw),
            "wv_b": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, pdt,
                               **kw),
            "wo": dense_init(gen, H * m.v_head_dim, cfg.d_model, pdt, **kw),
        }
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
    q = dot(x, p["wq"].to(dt))
    k = dot(x, p["wk"].to(dt))
    v = dot(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.mrope:
        pos3 = (positions if positions.dim() == 3
                else positions[..., None].expand(B, T, 3))
        q = apply_mrope(q, pos3, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.rope_theta)
    else:
        pos = _text_positions(positions)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _text_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, T) positions: the temporal axis of M-RoPE's (B, T, 3)."""
    return positions[..., 0] if positions.dim() == 3 else positions


def attention_train(cfg, p, x, positions, *, window=None, causal=True):
    """Full-sequence self-attention (training / prefill without cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = _dispatch_attend(q, k, v, window, causal,
                         cfg.resolved_head_dim ** -0.5, cfg.attn_softcap)
    B, T = x.shape[:2]
    return dot(o.reshape(B, T, -1), p["wo"].to(x.dtype))


def init_cache(cfg, batch: int, max_len: int, *, window=None, dtype=None,
               lead: Tuple[int, ...] = (), device=None):
    """Zero K/V caches on ``device``: the card unless the caller asks for
    the CPU."""
    device = alloc_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros(lead + (batch, max_len, m.kv_lora_rank),
                                    dtype=dt, device=device),
                "k_pe": torch.zeros(lead + (batch, max_len,
                                            m.qk_rope_head_dim),
                                    dtype=dt, device=device)}
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
    out = dot(o.reshape(B, 1, -1), p["wo"].to(x.dtype))
    return out, {"k": ck, "v": cv}


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------

def mla_latent(cfg, p, x, positions):
    """The latent row of each position: (c_kv (B,T,R), k_pe (B,T,Dr) with
    RoPE applied), in x's dtype: what the cache keeps."""
    m = cfg.mla
    kv_a = dot(x, p["wkv_a"].to(x.dtype))
    c_kv, k_pe = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    k_pe = apply_rope(k_pe[:, :, None, :], _text_positions(positions),
                      cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_train(cfg, p, x, positions, latent=None):
    """Full-sequence MLA: the latent expanded to per-head K and V, then K6
    with D = qk_nope + qk_rope and Dv = v_head_dim.  ``latent``: the
    ``mla_latent`` of ``x``, when the caller has it (the prefill keeps it
    as the cache)."""
    m = cfg.mla
    dt = x.dtype
    B, T, _ = x.shape
    H = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim

    q = dot(dot(x, p["wq_a"].to(dt)), p["wq_b"].to(dt))
    q = q.reshape(B, T, H, qk_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_kv, k_pe = latent if latent is not None else mla_latent(cfg, p, x,
                                                              positions)
    k_nope = dot(c_kv, p["wk_b"].to(dt)).reshape(B, T, H,
                                                 m.qk_nope_head_dim)
    v = dot(c_kv, p["wv_b"].to(dt)).reshape(B, T, H, m.v_head_dim)
    q_pe = apply_rope(q_pe, _text_positions(positions), cfg.rope_theta)

    q_full = torch.cat([q_nope, q_pe], -1)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, T, H, m.qk_rope_head_dim)], -1)               # shared rope head
    o = _dispatch_attend(q_full, k_full, v, None, True, qk_dim ** -0.5, None)
    return dot(o.reshape(B, T, H * m.v_head_dim), p["wo"].to(dt))


def mla_decode(cfg, p, x, cache, pos):
    """Latent-cache decode: scores in the compressed space (absorbed W_UK);
    the cache stores (c_kv, k_pe) — (R + Dr) per token instead of
    2·H·head_dim.  Scores and softmax in f32, slots past ``pos`` masked.
    The new latent row is written out of place."""
    m = cfg.mla
    dt = x.dtype
    B = x.shape[0]
    H = cfg.n_heads
    positions = pos.reshape(1, 1).expand(B, 1).to(torch.int32)

    q = dot(dot(x, p["wq_a"].to(dt)), p["wq_b"].to(dt))
    q = q.reshape(B, 1, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    c_new, kpe_new = mla_latent(cfg, p, x, positions)
    idx = pos.reshape(1).long()
    c_kv = cache["c_kv"].index_copy(1, idx, c_new.to(cache["c_kv"].dtype))
    k_pe = cache["k_pe"].index_copy(1, idx, kpe_new.to(cache["k_pe"].dtype))

    # absorb W_UK into the query: (B,1,H,R)
    wk_b = p["wk_b"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope, wk_b)

    S = c_kv.shape[1]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c_kv.float())
         + torch.einsum("bthd,bsd->bhts", q_pe.float(), k_pe.float())) * scale
    ar = torch.arange(S, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(ar <= pos, zero, _NEG)[None, None, None, :]
    prob = torch.softmax(s + mask, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", prob, c_kv.float())  # (B,1,H,R)
    wv_b = p["wv_b"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bthr,rhd->bthd", o_lat.to(dt), wv_b)
    out = dot(o.reshape(B, 1, H * m.v_head_dim), p["wo"].to(dt))
    return out, {"c_kv": c_kv, "k_pe": k_pe}
