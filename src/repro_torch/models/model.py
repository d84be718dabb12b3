"""Model assembly (port of ``repro.models.model``): layer planning, init,
the training loss, prefill and decode.

The tree layout is the reference's: layers are planned into homogeneous
*segments* and each segment's parameters and caches are stacked over its
layers (``segments/seg0/u0/mixer/wq`` of shape ``(count, d, H*hd)``,
``seg0/u0/k`` of shape ``(count, B, S, K, D)``), so scrutiny masks and step
directories carry the reference's leaf names and shapes, and converted
parameters need no renaming.  The reference's ``lax.scan`` over a segment
becomes a Python loop over per-layer views (``_unstack``).

Ported: flavours ``g`` (global) and ``l`` (windowed) attention, ``r``
(RG-LRU), ``m`` (mLSTM) and ``s`` (sLSTM), with a dense FFN or none, and
text input (phi4-mini, gemma-7b, gemma2-27b, qwen1.5-32b,
recurrentgemma-2b, xlstm-125m).  MoE, MLA, encoder-decoder and M-RoPE
raise ``NotImplementedError``: they come with a later slice (ROADMAP
Queue 1 item 9).  Rematerialization (``cfg.remat``) is the reference's XLA
knob and is not ported: the backward keeps every layer's activations.

Batch contracts:
  train:   {"tokens": (B,T) int32, "labels": (B,T) int32, ["mask"]} →
           mean next-token cross-entropy (``loss_fn``)
  prefill: {"tokens": (B,T) int32} → (last-position logits, cache)
  decode:  tokens (B,1) int32 + cache + pos (0-d int32) → (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._tensors import alloc_device
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
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
    """Raise for what the port does not have yet."""
    what = [name for name, on in (("MoE", cfg.moe is not None),
                                  ("MLA", cfg.mla is not None),
                                  ("encoder-decoder", cfg.enc_dec),
                                  ("M-RoPE", cfg.mrope)) if on]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported yet; repro_torch "
            "runs the g/l/r/m/s layer flavours with a dense FFN and text "
            "input, and the rest comes with a later slice (ROADMAP Queue 1 "
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

def _init_mixer(cfg, flavour: str, gen, **kw):
    if flavour in ("g", "l"):
        return attn.init_attention(cfg, gen, **kw)
    return {"r": rec.init_rglru, "m": rec.init_mlstm,
            "s": rec.init_slstm}[flavour](cfg, gen, **kw)


def init_block(cfg, kind: Kind, gen, *, lead: Tuple[int, ...] = (),
               device=None) -> Dict[str, Any]:
    fl, ff = kind
    device = device or gen.device
    p: Dict[str, Any] = {
        "norm1": init_norm(cfg, lead=lead, device=device),
        "mixer": _init_mixer(cfg, fl, gen, lead=lead, device=device),
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


def _mixer_train(cfg, kind, p, x, positions):
    fl = kind[0]
    if fl in ("g", "l"):
        window = cfg.window if fl == "l" else None
        return attn.attention_train(cfg, p, x, positions, window=window)
    return {"r": rec.rglru_train, "m": rec.mlstm_train,
            "s": rec.slstm_train}[fl](cfg, p, x)


def apply_block_train(cfg, kind, p, x, positions):
    """Block forward over a whole sequence (no cache)."""
    h = apply_norm(cfg, p["norm1"], x)
    h = _mixer_train(cfg, kind, p["mixer"], h, positions)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, x + h)


# --- decode ----------------------------------------------------------------

_STATE_INIT = {"r": rec.rglru_init_state, "m": rec.mlstm_init_state,
               "s": rec.slstm_init_state}
_DECODE = {"r": rec.rglru_decode, "m": rec.mlstm_decode,
           "s": rec.slstm_decode}
_PREFILL = {"r": rec.rglru_prefill, "m": rec.mlstm_prefill,
            "s": rec.slstm_prefill}


def init_layer_cache(cfg, kind: Kind, batch: int, max_len: int, *,
                     lead: Tuple[int, ...] = (), device=None):
    device = alloc_device(device)
    fl = kind[0]
    if fl in ("g", "l"):
        window = cfg.window if fl == "l" else None
        return attn.init_cache(cfg, batch, max_len, window=window, lead=lead,
                               device=device)
    return _STATE_INIT[fl](cfg, batch, lead=lead, device=device)


def apply_block_decode(cfg, kind, p, x, cache, pos):
    fl = kind[0]
    h = apply_norm(cfg, p["norm1"], x)
    if fl in ("g", "l"):
        window = cfg.window if fl == "l" else None
        h, upd = attn.attention_decode(cfg, p["mixer"], h,
                                       {k: cache[k] for k in ("k", "v")},
                                       pos, window=window)
    else:
        h, upd = _DECODE[fl](cfg, p["mixer"], h, cache)
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
    dtype, norm parameters and ``_F32_AT_USE`` as they are.  The model
    casts each matrix to the compute dtype at use, so this copy gives the
    same numbers and spares a fresh cast per matmul; an autograd trace
    through the model (scrutiny) then saves no cast copy of the weights
    either."""
    dt = dtype_of(cfg.dtype)
    named, treedef = _tree.flatten_with_names(params)
    out = []
    for name, leaf in named:
        keys = name.split("/")
        norm = any(k.startswith("norm") or k == "final_norm" for k in keys)
        out.append(leaf if norm or keys[-1] in _F32_AT_USE else leaf.to(dt))
    return _tree.unflatten(treedef, out)


# Recurrent parameters the model reads in f32 (``.float()``), not in the
# compute dtype: compute_params keeps them as they are.
_F32_AT_USE = frozenset({"lambda", "rz", "ri", "rf", "ro"})


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
# forward: train loss
# --------------------------------------------------------------------------

_LOSS_CHUNK = 512


def _chunked_loss(cfg, params, h, labels, mask):
    """Cross-entropy without materializing (B, T, V) at once: the
    reference's scan over 512-position chunks as a loop.  Each chunk casts
    the head's weight afresh, as the reference's scan body does, so the
    chunks' gradients of a tied embedding add up in f32."""
    T = h.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, _LOSS_CHUNK):
        logits = lm_head_logits(cfg, params,
                                h[:, c0:c0 + _LOSS_CHUNK]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + _LOSS_CHUNK, None].long())[..., 0]
        tot = tot + ((lse - gold) * mask[:, c0:c0 + _LOSS_CHUNK]).sum()
    return tot / torch.clamp(mask.sum(), min=1.0)


def _run_layers(cfg, params, x, positions):
    for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg))):
        for p_l in _unstack(params["segments"][f"seg{si}"]):
            for ui, kind in enumerate(unit):
                x = apply_block_train(cfg, kind, p_l[f"u{ui}"], x, positions)
    return x


def loss_fn(cfg, params, batch):
    """Mean next-token cross-entropy over ``batch["mask"]`` (all ones if
    absent)."""
    _check_served(cfg)
    x, positions = _input_sequence(cfg, params, batch)
    x = _run_layers(cfg, params, x, positions)
    x = apply_norm(cfg, params["final_norm"], x)
    labels = batch["labels"]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    return _chunked_loss(cfg, params, x, labels, mask)


# --------------------------------------------------------------------------
# forward: prefill & decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zero decode caches on ``device``: the card unless the caller asks
    for the CPU."""
    _check_served(cfg)
    device = alloc_device(device)
    return {f"seg{si}": {f"u{ui}": init_layer_cache(cfg, kind, batch,
                                                    max_len, lead=(count,),
                                                    device=device)
                         for ui, kind in enumerate(unit)}
            for si, (unit, count) in enumerate(
                plan_segments(layer_kinds(cfg)))}


def _prefill_block(cfg, kind, p, x, positions, max_len):
    """Block forward that also captures the decode cache."""
    fl = kind[0]
    h = apply_norm(cfg, p["norm1"], x)
    if fl in ("g", "l"):
        h, cache = _attention_prefill(cfg, fl, p["mixer"], h, positions,
                                      max_len)
    else:
        h, cache = _PREFILL[fl](cfg, p["mixer"], h)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, x + h), cache


def _attention_prefill(cfg, fl, p, h, positions, max_len):
    window = cfg.window if fl == "l" else None
    B, T = h.shape[:2]
    dt = dtype_of(cfg.dtype)
    q, k, v = attn._project_qkv(cfg, p, h, positions)
    o = attn._dispatch_attend(q, k, v, window, True,
                              cfg.resolved_head_dim ** -0.5,
                              cfg.attn_softcap)
    out = o.reshape(B, T, -1) @ p["wo"].to(h.dtype)
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
    return out, cache


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
