"""Model assembly, serving part (port of ``repro.models.model``): layer
planning, init, prefill and decode for the dense GQA family.

The tree layout is the reference's: layers are planned into homogeneous
*segments* and each segment's parameters and caches are stacked over its
layers (``segments/seg0/u0/mixer/wq`` of shape ``(count, d, H*hd)``,
``seg0/u0/k`` of shape ``(count, B, S, K, D)``), so scrutiny masks and step
directories carry the reference's leaf names and shapes, and converted
parameters need no renaming.  The reference's ``lax.scan`` over a segment
becomes a Python loop over per-layer views (``_unstack``).

Served: flavours ``g`` (global) and ``l`` (windowed) attention with a
dense FFN, text input (phi4-mini, gemma-7b, gemma2-27b, qwen1.5-32b).
Recurrent layers, MLA, MoE, encoder-decoder and M-RoPE raise
``NotImplementedError``: they come with the training slice (ROADMAP
Queue 1 item 9), as do ``loss_fn`` and ``_chunked_loss``.

Batch contracts:
  prefill: {"tokens": (B,T) int32} → (last-position logits, cache)
  decode:  tokens (B,1) int32 + cache + pos (0-d int32) → (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_ffn, apply_norm, dtype_of,
                                       embed_init, init_ffn, init_norm,
                                       softcap)

# --------------------------------------------------------------------------
# layer planning
# --------------------------------------------------------------------------

Kind = Tuple[str, str]  # (flavour: g|l|r|m|s, ffn: d|e|n)


def layer_kinds(cfg) -> List[Kind]:
    kinds = []
    for l in range(cfg.n_layers):
        fl = cfg.pattern_at(l)
        if cfg.moe_at(l):
            f = "e"
        elif cfg.d_ff and cfg.d_ff > 0:
            f = "d"
        else:
            f = "n"
        kinds.append((fl, f))
    return kinds


def _check_served(cfg) -> None:
    """Raise for what the serving slice does not port yet."""
    what = []
    flavours = sorted({fl for fl, _ in layer_kinds(cfg)} - {"g", "l"})
    if flavours:
        what.append(f"layer flavours {flavours}")
    for name, on in (("MoE", cfg.moe is not None),
                     ("MLA", cfg.mla is not None),
                     ("encoder-decoder", cfg.enc_dec),
                     ("M-RoPE", cfg.mrope)):
        if on:
            what.append(name)
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported yet; repro_torch "
            "serves the dense GQA family (g/l attention, dense FFN) and "
            "the rest comes with the training slice (ROADMAP Queue 1 "
            "item 9)")


def plan_segments(kinds: List[Kind]) -> List[Tuple[Tuple[Kind, ...], int]]:
    """Segment layers into (unit, count) stacks: cyclic unit detection
    first, maximal identical runs as fallback."""
    n = len(kinds)
    for ulen in range(1, 9):
        cnt = n // ulen
        if cnt < 2:
            break
        if all(kinds[i] == kinds[i % ulen] for i in range(cnt * ulen)):
            segs = [(tuple(kinds[:ulen]), cnt)]
            if n % ulen:
                segs.append((tuple(kinds[cnt * ulen:]), 1))
            return segs
    segs: List[Tuple[Tuple[Kind, ...], int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    return segs


def _unstack(tree) -> List[Any]:
    """Per-layer views of a stacked parameter or cache tree.  One
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a full-size gradient per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        count = len(next(iter(per.values())))
        return [{k: v[l] for k, v in per.items()} for l in range(count)]
    return list(torch.unbind(tree, 0))


def _stack(layers: List[Any]):
    """Per-layer trees → one tree stacked over layers (a new tensor)."""
    if isinstance(layers[0], dict):
        return {k: _stack([t[k] for t in layers]) for k in layers[0]}
    return torch.stack(layers)


# --------------------------------------------------------------------------
# block init/apply
# --------------------------------------------------------------------------

def init_block(cfg, kind: Kind, gen, *, lead: Tuple[int, ...] = (),
               device=None) -> Dict[str, Any]:
    ff = kind[1]
    device = device or gen.device
    p: Dict[str, Any] = {
        "norm1": init_norm(cfg, lead=lead, device=device),
        "mixer": attn.init_attention(cfg, gen, lead=lead, device=device),
    }
    if cfg.post_norm:
        p["norm1_post"] = init_norm(cfg, lead=lead, device=device)
    if ff == "d":
        p["norm2"] = init_norm(cfg, lead=lead, device=device)
        p["ffn"] = init_ffn(cfg, gen, lead=lead, device=device)
        if cfg.post_norm:
            p["norm2_post"] = init_norm(cfg, lead=lead, device=device)
    return p


def _ffn_half(cfg, p, x):
    if "ffn" in p:
        h = apply_norm(cfg, p["norm2"], x)
        h = apply_ffn(cfg, p["ffn"], h)
        if cfg.post_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        x = x + h
    return x


def apply_block_train(cfg, kind, p, x, positions):
    """Block forward over a whole sequence (no cache)."""
    window = cfg.window if kind[0] == "l" else None
    h = apply_norm(cfg, p["norm1"], x)
    h = attn.attention_train(cfg, p["mixer"], h, positions, window=window)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, x + h)


# --- decode ----------------------------------------------------------------

def init_layer_cache(cfg, kind: Kind, batch: int, max_len: int, *,
                     lead: Tuple[int, ...] = (), device="cpu"):
    window = cfg.window if kind[0] == "l" else None
    return attn.init_cache(cfg, batch, max_len, window=window, lead=lead,
                           device=device)


def apply_block_decode(cfg, kind, p, x, cache, pos):
    window = cfg.window if kind[0] == "l" else None
    h = apply_norm(cfg, p["norm1"], x)
    h, upd = attn.attention_decode(cfg, p["mixer"], h,
                                   {k: cache[k] for k in ("k", "v")}, pos,
                                   window=window)
    new_cache = dict(cache)
    new_cache.update(upd)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, x + h), new_cache


# --------------------------------------------------------------------------
# whole-model init
# --------------------------------------------------------------------------

def init_params(cfg, gen, *, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on its device (or ``device``); on
    ``device="meta"`` (``gen`` may be None) shapes only."""
    _check_served(cfg)
    device = torch.device(device) if device is not None else gen.device
    pdt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, pdt, device=device),
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model, pdt,
                                       device=device).t().contiguous()
    params["segments"] = {
        f"seg{si}": {f"u{ui}": init_block(cfg, kind, gen, lead=(count,),
                                          device=device)
                     for ui, kind in enumerate(unit)}
        for si, (unit, count) in enumerate(plan_segments(layer_kinds(cfg)))}
    return params


def compute_params(cfg, params) -> Dict[str, Any]:
    """``params`` with every matrix (and qkv bias) cast once to the compute
    dtype, norm parameters as they are.  The model casts each matrix to
    the compute dtype at use, so this copy gives the same numbers and
    spares a fresh cast per matmul; an autograd trace through the model
    (scrutiny) then saves no cast copy of the weights either."""
    dt = dtype_of(cfg.dtype)
    named, treedef = _tree.flatten_with_names(params)
    out = []
    for name, leaf in named:
        keys = name.split("/")
        norm = any(k.startswith("norm") or k == "final_norm" for k in keys)
        out.append(leaf if norm else leaf.to(dt))
    return _tree.unflatten(treedef, out)


# --------------------------------------------------------------------------
# embeddings / positions / head
# --------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=x.dtype,
                             device=x.device)
    return x


def _input_sequence(cfg, params, batch):
    """tokens (text only) → (x, positions (B, T) int32 arange)."""
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(B, T)
    return x, positions


def lm_head_logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w.to(h.dtype)
    return softcap(logits, cfg.logit_softcap)


# --------------------------------------------------------------------------
# forward: prefill & decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, device="cpu"):
    _check_served(cfg)
    return {f"seg{si}": {f"u{ui}": init_layer_cache(cfg, kind, batch,
                                                    max_len, lead=(count,),
                                                    device=device)
                         for ui, kind in enumerate(unit)}
            for si, (unit, count) in enumerate(
                plan_segments(layer_kinds(cfg)))}


def _prefill_block(cfg, kind, p, x, positions, max_len):
    """Block forward that also captures the decode cache."""
    window = cfg.window if kind[0] == "l" else None
    B, T = x.shape[:2]
    dt = dtype_of(cfg.dtype)
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn._project_qkv(cfg, p["mixer"], h, positions)
    o = attn._dispatch_attend(q, k, v, window, True,
                              cfg.resolved_head_dim ** -0.5,
                              cfg.attn_softcap)
    h = o.reshape(B, T, -1) @ p["mixer"]["wo"].to(h.dtype)
    S = min(window, max_len) if window else max_len
    if window and T >= S:
        # ring buffer: position t lives in slot t % S
        cache = {"k": torch.roll(k[:, T - S:], shifts=T % S, dims=1),
                 "v": torch.roll(v[:, T - S:], shifts=T % S, dims=1)}
    else:
        cache = {}
        for name, t in (("k", k), ("v", v)):
            c = torch.zeros((B, S) + t.shape[2:], dtype=dt, device=t.device)
            c[:, :T] = t.to(dt)
            cache[name] = c
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, x + h), cache


def prefill(cfg, params, batch, max_len: int):
    """Run the prompt through the model; return (last logits, cache at
    position T)."""
    _check_served(cfg)
    x, positions = _input_sequence(cfg, params, batch)
    max_len = max(max_len, x.shape[1])
    caches = {}
    for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg))):
        per_layer = []
        for p_l in _unstack(params["segments"][f"seg{si}"]):
            cache_l = {}
            for ui, kind in enumerate(unit):
                x, cache_l[f"u{ui}"] = _prefill_block(
                    cfg, kind, p_l[f"u{ui}"], x, positions, max_len)
            per_layer.append(cache_l)
        caches[f"seg{si}"] = _stack(per_layer)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head_logits(cfg, params, x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg, params, cache, tokens, pos):
    """One decode step.  tokens: (B, 1) int32; pos: 0-d int32 tensor.
    Returns (logits (B, V), new cache); ``cache`` is not written."""
    x = _embed_tokens(cfg, params, tokens)
    new_caches = {}
    for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg))):
        per_layer = []
        for p_l, c_l in zip(_unstack(params["segments"][f"seg{si}"]),
                            _unstack(cache[f"seg{si}"])):
            new_c = {}
            for ui, kind in enumerate(unit):
                x, new_c[f"u{ui}"] = apply_block_decode(
                    cfg, kind, p_l[f"u{ui}"], x, c_l[f"u{ui}"], pos)
            per_layer.append(new_c)
        new_caches[f"seg{si}"] = _stack(per_layer)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head_logits(cfg, params, x)
    return logits[:, 0], new_caches


def count_params(params) -> int:
    return sum(leaf.numel() for leaf in _tree.leaves(params))
