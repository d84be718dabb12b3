"""Model assembly (port of ``repro.models.model``): layer planning, init,
the training loss, prefill and decode.

The tree layout is the reference's: layers are planned into homogeneous
*segments* and each segment's parameters and caches are stacked over its
layers (``segments/seg0/u0/mixer/wq`` of shape ``(count, d, H*hd)``,
``seg0/u0/k`` of shape ``(count, B, S, K, D)``), so scrutiny masks and step
directories carry the reference's leaf names and shapes, and converted
parameters need no renaming.  The reference's ``lax.scan`` over a segment
becomes a Python loop over per-layer views (``_unstack``).

Every architecture of ``configs/`` is served: flavours ``g`` (global) and
``l`` (windowed) attention, GQA or MLA (deepseek), ``r`` (RG-LRU), ``m``
(mLSTM), ``s`` (sLSTM) and ``M`` (Mamba-2, ``mamba2.py``); a dense FFN,
MoE (olmoe, deepseek) or none; the muP multipliers of the embeddings, the
residual branches and the logits (``cfg.embed_mult``, ``residual_mult``,
``logits_div``: 1 leaves the arithmetic as it is);
M-RoPE with a patch-embedding prefix (qwen2-vl); and the encoder-decoder
(whisper: a non-causal encoder over ``frames``, cross attention in every
decoder block).  Rematerialization (``cfg.remat``, the reference's per-
layer ``jax.checkpoint``) wraps each layer of a segment (one unit of its
stack) in ``torch.utils.checkpoint`` when autograd records the forward
(``set_remat_policy``: "dots" keeps the outputs of the products with a
weight matrix, ``layers.dot``; "full" keeps nothing); under ``torch.func``
transforms and with autograd off it does not run (``_remat_active``).

Batch contracts:
  train:   {"tokens": (B,T) int32, "labels": (B,T) int32, ["mask"],
            ["positions" (B,P+T,3) int32], ["patch_embeds" (B,P,d) for
            vlm], ["frames" (B,F,d) audio]} → mean next-token
           cross-entropy plus the MoE aux loss (``loss_fn``)
  prefill: the same minus labels → (last-position logits, cache at
           position P + T: a VLM's patches come first)
  decode:  tokens (B,1) int32 + cache + pos (0-d int32) → (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch._tensors import alloc_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (KeptProducts, apply_ffn, apply_norm,
                                       dot, dtype_of, embed_init, init_ffn,
                                       init_norm, softcap)

# --------------------------------------------------------------------------
# layer planning
# --------------------------------------------------------------------------

Kind = Tuple[str, str]  # (flavour: g|l|r|m|s|M, ffn: d|e|n)


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
            "s": rec.init_slstm, "M": mamba2.init_mamba2}[flavour](
                cfg, gen, **kw)


def init_block(cfg, kind: Kind, gen, *, lead: Tuple[int, ...] = (),
               device=None, cross: bool = False) -> Dict[str, Any]:
    fl, ff = kind
    device = device or gen.device
    kw = dict(lead=lead, device=device)
    p: Dict[str, Any] = {
        "norm1": init_norm(cfg, **kw),
        "mixer": _init_mixer(cfg, fl, gen, **kw),
    }
    if cfg.post_norm:
        p["norm1_post"] = init_norm(cfg, **kw)
    if cross:
        p["norm_x"] = init_norm(cfg, **kw)
        p["cross"] = attn.init_attention(cfg, gen, **kw)
    if ff in ("d", "e"):
        p["norm2"] = init_norm(cfg, **kw)
        if ff == "d":
            p["ffn"] = init_ffn(cfg, gen, **kw)
        else:
            p["moe"] = moe_mod.init_moe(cfg, gen, **kw)
        if cfg.post_norm:
            p["norm2_post"] = init_norm(cfg, **kw)
    return p


def _add_branch(cfg, x, h):
    """The residual add of one branch: ``x + h``, times the muP residual
    multiplier where the configuration has one."""
    if cfg.residual_mult != 1.0:
        h = h * cfg.residual_mult
    return x + h


def _ffn_half(cfg, p, x, train=False):
    """The FFN (or MoE) residual half → (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p or "moe" in p:
        h = apply_norm(cfg, p["norm2"], x)
        if "moe" in p:
            h, aux = moe_mod.apply_moe(cfg, p["moe"], h, train=train)
        else:
            h = apply_ffn(cfg, p["ffn"], h)
        if cfg.post_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        x = _add_branch(cfg, x, h)
    return x, aux


def _cross_half(cfg, p, x, enc_out, kv=None):
    """Cross attention's residual half (whisper's decoder blocks); ``kv``:
    the encoder output's cross K and V when the caller has them."""
    if "cross" not in p:
        return x
    h = apply_norm(cfg, p["norm_x"], x)
    return _add_branch(cfg, x, _cross_attend(cfg, p["cross"], h, enc_out,
                                             kv))


def _cross_kv(cfg, p, enc_out):
    """The encoder output's cross K and V, (B, F, K, hd) each, in its
    dtype."""
    B, S = enc_out.shape[:2]
    hd = cfg.resolved_head_dim
    dt = enc_out.dtype
    return tuple(dot(enc_out, p[w].to(dt)).reshape(B, S, cfg.n_kv_heads,
                                                   hd)
                 for w in ("wk", "wv"))


def _cross_attend(cfg, p, x, enc_out, kv=None):
    """Encoder-decoder cross attention (whisper): plain einsum attention
    with no mask, as the reference's (which never sends it to Pallas).
    ``kv``: the encoder output's (K, V) when the caller has them (the
    prefill keeps them as the cache, the decode reads them from it)."""
    dt = x.dtype
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dot(x, p["wq"].to(dt)).reshape(B, T, cfg.n_heads, hd)
    k, v = kv if kv is not None else _cross_kv(cfg, p, enc_out)
    bias = torch.zeros((B, T, k.shape[1]), dtype=torch.float32,
                       device=x.device)
    o = attn._attend_full(q, k, v, bias, hd ** -0.5, None)
    return dot(o.reshape(B, T, -1), p["wo"].to(dt))


def _mixer_train(cfg, kind, p, x, positions):
    fl = kind[0]
    if fl in ("g", "l"):
        if cfg.mla is not None:
            return attn.mla_train(cfg, p, x, positions)
        window = cfg.window if fl == "l" else None
        return attn.attention_train(cfg, p, x, positions, window=window)
    return {"r": rec.rglru_train, "m": rec.mlstm_train,
            "s": rec.slstm_train, "M": mamba2.mamba2_train}[fl](cfg, p, x)


def apply_block_train(cfg, kind, p, x, positions, enc_out=None,
                      train=False):
    """Block forward over a whole sequence (no cache) → (x, MoE aux)."""
    h = apply_norm(cfg, p["norm1"], x)
    h = _mixer_train(cfg, kind, p["mixer"], h, positions)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    return _ffn_half(cfg, p, _cross_half(cfg, p, _add_branch(cfg, x, h),
                                         enc_out), train)


# --- decode ----------------------------------------------------------------

_STATE_INIT = {"r": rec.rglru_init_state, "m": rec.mlstm_init_state,
               "s": rec.slstm_init_state, "M": mamba2.mamba2_init_state}
_DECODE = {"r": rec.rglru_decode, "m": rec.mlstm_decode,
           "s": rec.slstm_decode, "M": mamba2.mamba2_decode}
_PREFILL = {"r": rec.rglru_prefill, "m": rec.mlstm_prefill,
            "s": rec.slstm_prefill, "M": mamba2.mamba2_prefill}


def init_layer_cache(cfg, kind: Kind, batch: int, max_len: int, *,
                     cross_len: int = 0, lead: Tuple[int, ...] = (),
                     device=None):
    device = alloc_device(device)
    fl = kind[0]
    if fl in ("g", "l"):
        window = cfg.window if fl == "l" else None
        c = attn.init_cache(cfg, batch, max_len, window=window, lead=lead,
                            device=device)
    else:
        c = _STATE_INIT[fl](cfg, batch, lead=lead, device=device)
    if cross_len:
        shape = lead + (batch, cross_len, cfg.n_kv_heads,
                        cfg.resolved_head_dim)
        for name in ("xk", "xv"):
            c[name] = torch.zeros(shape, dtype=dtype_of(cfg.dtype),
                                  device=device)
    return c


_MIXER_CACHE = ("k", "v", "c_kv", "k_pe")


def apply_block_decode(cfg, kind, p, x, cache, pos):
    fl = kind[0]
    h = apply_norm(cfg, p["norm1"], x)
    if fl in ("g", "l"):
        mine = {k: v for k, v in cache.items() if k in _MIXER_CACHE}
        if cfg.mla is not None:
            h, upd = attn.mla_decode(cfg, p["mixer"], h, mine, pos)
        else:
            window = cfg.window if fl == "l" else None
            h, upd = attn.attention_decode(cfg, p["mixer"], h, mine, pos,
                                           window=window)
    else:
        h, upd = _DECODE[fl](cfg, p["mixer"], h, cache)
    new_cache = dict(cache)
    new_cache.update(upd)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    kv = (cache["xk"], cache["xv"]) if "cross" in p else None
    x = _cross_half(cfg, p, _add_branch(cfg, x, h), None, kv)
    return _ffn_half(cfg, p, x)[0], new_cache


# --------------------------------------------------------------------------
# whole-model init
# --------------------------------------------------------------------------

def init_params(cfg, gen, *, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on its device (or ``device``); on
    ``device="meta"`` (``gen`` may be None) shapes only."""
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
                                          device=device, cross=cfg.enc_dec)
                     for ui, kind in enumerate(unit)}
        for si, (unit, count) in enumerate(plan_segments(layer_kinds(cfg)))}
    if cfg.enc_dec:
        params["encoder"] = {
            "blocks": {"u0": init_block(cfg, ("g", "d"), gen,
                                        lead=(cfg.n_encoder_layers,),
                                        device=device)},
            "final_norm": init_norm(cfg, device=device)}
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
_F32_AT_USE = frozenset({"lambda", "rz", "ri", "rf", "ro", "A_log", "D",
                         "dt_bias"})


# --------------------------------------------------------------------------
# embeddings / positions / head
# --------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=x.dtype,
                             device=x.device)
    if cfg.embed_mult != 1.0:
        x = x * cfg.embed_mult
    return x


def _input_sequence(cfg, params, batch):
    """tokens (+ a VLM's patch embeddings in front) → (x, positions,
    text offset): ``batch["positions"]`` when given ((B, L, 3) for
    M-RoPE), else arange (B, L) int32."""
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    B = tokens.shape[0]
    offset = 0
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        offset = pe.shape[1]
    L = x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32,
                                 device=tokens.device).expand(B, L)
    return x, positions, offset


def lm_head_logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w.to(h.dtype)
    if cfg.logits_div != 1.0:
        logits = logits / cfg.logits_div
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


def _run_encoder(cfg, params, frames):
    """Whisper's encoder: non-causal self attention (K6 with
    ``causal=False``) and the FFN in every block, then its final norm."""
    x = frames.to(dtype_of(cfg.dtype))
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for p_l in _unstack(params["encoder"]["blocks"]):
        p = p_l["u0"]
        h = apply_norm(cfg, p["norm1"], x)
        x = x + attn.attention_train(cfg, p["mixer"], h, positions,
                                     causal=False)
        h = apply_norm(cfg, p["norm2"], x)
        x = x + apply_ffn(cfg, p["ffn"], h)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


def _encode(cfg, params, batch):
    """The encoder output for an encoder-decoder batch, else None."""
    return _run_encoder(cfg, params, batch["frames"]) if cfg.enc_dec \
        else None


_REMAT_POLICY = "dots"  # dots (keep the products' outputs) | full (nothing)


def set_remat_policy(mode: str) -> None:
    """What a rematerialized layer keeps for its backward: "dots" the
    outputs of its products with a weight matrix (``layers.dot``: the
    products with no batch dimension, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``),
    recomputing the rest (K6's and K7's forwards included) and not the
    products; "full" nothing, recomputing the whole layer."""
    global _REMAT_POLICY
    if mode not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {mode!r}")
    _REMAT_POLICY = mode


def _remat_active(cfg, x, p_l) -> bool:
    """Remat runs where autograd records the layer's forward: grad mode
    on and ``x`` or a parameter of the layer requiring grad.  It does not
    run under ``torch.func`` transforms (the scrutiny's ``vjp``), which
    refuse the saved-tensor hooks that checkpointing installs, nor with
    autograd off (prefill, decode, ``make_fx`` traces): there it would
    change nothing, since remat moves memory, not values."""
    if not (cfg.remat and torch.is_grad_enabled()) or \
            torch._C._are_functorch_transforms_active():
        return False
    return x.requires_grad or any(t.requires_grad for t in _tree.leaves(p_l))


def _run_layers(cfg, params, x, positions, enc_out=None, train=False):
    """Every decoder block → (x, the MoE aux losses summed in f32).  Each
    layer of a segment (one unit of its stack) runs under
    ``torch.utils.checkpoint`` where remat is active (``_remat_active``),
    as the reference wraps its scan body in ``jax.checkpoint``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg))):
        def body(x, aux, p_l, unit=unit):
            for ui, kind in enumerate(unit):
                x, a = apply_block_train(cfg, kind, p_l[f"u{ui}"], x,
                                         positions, enc_out, train)
                aux = aux + a
            return x, aux

        for p_l in _unstack(params["segments"][f"seg{si}"]):
            if _remat_active(cfg, x, p_l):
                x, aux = _checkpointed(body, x, aux, p_l)
            else:
                x, aux = body(x, aux, p_l)
    return x, aux


def _checkpointed(body, *args):
    kw = {}
    if _REMAT_POLICY == "dots":
        kept = KeptProducts()
        kw["context_fn"] = lambda: (kept.recording(), kept.replaying())
    return checkpoint(body, *args, use_reentrant=False, **kw)


def full_logits(cfg, params, batch):
    """The train path's forward without the loss → logits (B, T, V) at
    every text position (MoE dropless, as prefill and decode run it)."""
    x, positions, offset = _input_sequence(cfg, params, batch)
    x, _ = _run_layers(cfg, params, x, positions,
                       _encode(cfg, params, batch))
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_head_logits(cfg, params, x[:, offset:])


def loss_fn(cfg, params, batch):
    """Mean next-token cross-entropy over ``batch["mask"]`` (all ones if
    absent), plus the MoE aux loss; MoE runs with its training capacity
    (``train=True``), as the reference's loss does."""
    x, positions, offset = _input_sequence(cfg, params, batch)
    x, aux = _run_layers(cfg, params, x, positions,
                         _encode(cfg, params, batch), train=True)
    x = apply_norm(cfg, params["final_norm"], x)
    if offset:
        x = x[:, offset:]
    labels = batch["labels"]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    return _chunked_loss(cfg, params, x, labels, mask) + aux


# --------------------------------------------------------------------------
# forward: prefill & decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zero decode caches on ``device``: the card unless the caller asks
    for the CPU."""
    device = alloc_device(device)
    cross_len = cfg.encoder_len if cfg.enc_dec else 0
    return {f"seg{si}": {f"u{ui}": init_layer_cache(cfg, kind, batch,
                                                    max_len,
                                                    cross_len=cross_len,
                                                    lead=(count,),
                                                    device=device)
                         for ui, kind in enumerate(unit)}
            for si, (unit, count) in enumerate(
                plan_segments(layer_kinds(cfg)))}


def _prefill_block(cfg, kind, p, x, positions, max_len, enc_out):
    """Block forward that also captures the decode cache."""
    fl = kind[0]
    h = apply_norm(cfg, p["norm1"], x)
    if fl in ("g", "l") and cfg.mla is not None:
        h, cache = _mla_prefill(cfg, p["mixer"], h, positions, max_len)
    elif fl in ("g", "l"):
        h, cache = _attention_prefill(cfg, fl, p["mixer"], h, positions,
                                      max_len)
    else:
        h, cache = _PREFILL[fl](cfg, p["mixer"], h)
    if cfg.post_norm:
        h = apply_norm(cfg, p["norm1_post"], h)
    kv = None
    if "cross" in p:
        kv = _cross_kv(cfg, p["cross"], enc_out)
        cache["xk"], cache["xv"] = (t.to(dtype_of(cfg.dtype)) for t in kv)
    x = _cross_half(cfg, p, _add_branch(cfg, x, h), enc_out, kv)
    return _ffn_half(cfg, p, x)[0], cache


def _into_cache(t, max_len):
    """(B, T, ...) → zeros (B, max_len, ...) in the cache dtype with t in
    the first T slots."""
    c = t.new_zeros((t.shape[0], max_len) + t.shape[2:])
    c[:, :t.shape[1]] = t
    return c


def _mla_prefill(cfg, p, x, positions, max_len):
    dt = dtype_of(cfg.dtype)
    latent = attn.mla_latent(cfg, p, x, positions)
    out = attn.mla_train(cfg, p, x, positions, latent=latent)
    return out, {name: _into_cache(t.to(dt), max_len)
                 for name, t in zip(("c_kv", "k_pe"), latent)}


def _attention_prefill(cfg, fl, p, h, positions, max_len):
    window = cfg.window if fl == "l" else None
    B, T = h.shape[:2]
    dt = dtype_of(cfg.dtype)
    q, k, v = attn._project_qkv(cfg, p, h, positions)
    o = attn._dispatch_attend(q, k, v, window, True, attn.scale_of(cfg),
                              cfg.attn_softcap)
    out = dot(o.reshape(B, T, -1), p["wo"].to(h.dtype))
    S = min(window, max_len) if window else max_len
    if window and T >= S:
        # ring buffer: position t lives in slot t % S
        cache = {"k": torch.roll(k[:, T - S:], shifts=T % S, dims=1),
                 "v": torch.roll(v[:, T - S:], shifts=T % S, dims=1)}
    else:
        cache = {name: _into_cache(t.to(dt), S)
                 for name, t in (("k", k), ("v", v))}
    return out, cache


def prefill(cfg, params, batch, max_len: int):
    """Run the prompt through the model; return (last logits, cache at
    position L = P + T, the prefilled sequence's length)."""
    x, positions, _ = _input_sequence(cfg, params, batch)
    enc_out = _encode(cfg, params, batch)
    max_len = max(max_len, x.shape[1])  # modality stubs extend the sequence
    caches = {}
    for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg))):
        per_layer = []
        for p_l in _unstack(params["segments"][f"seg{si}"]):
            cache_l = {}
            for ui, kind in enumerate(unit):
                x, cache_l[f"u{ui}"] = _prefill_block(
                    cfg, kind, p_l[f"u{ui}"], x, positions, max_len,
                    enc_out)
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


def carried_state(cfg, cache) -> Dict[str, Any]:
    """The segments of ``cache`` that hold Mamba-2 layers: state that every
    decode step reads whole and hands on, so that a step past any horizon
    still reads it.  A scrutiny of a few steps' logits alone can find an
    element of it unread (a C channel that is exactly 0 in those steps
    leaves its column of the SSM state out of every logit); a scrutiny
    target that returns it too holds all of it critical."""
    return {f"seg{si}": cache[f"seg{si}"]
            for si, (unit, _) in enumerate(plan_segments(layer_kinds(cfg)))
            if any(kind[0] == "M" for kind in unit)}


def count_params(params) -> int:
    return sum(leaf.numel() for leaf in _tree.leaves(params))
