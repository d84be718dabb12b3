"""Shared model layers (port of ``repro.models.layers``): norms,
projections, embeddings, RoPE/M-RoPE and FFNs, and ``dot``, the product
with a weight matrix that every layer's projections go through.

Pure functions over nested-dict params.  Initializers draw from an
explicit ``torch.Generator`` on its device (the reference's ``jax.random``
keys give other numbers, so the parity tests carry parameters across with
``convert.params_from_numpy``); on the meta device they make shapes only.
``lead`` prepends a segment's layer count, so a segment's parameters are
made stacked, as the reference's ``vmap`` over layer keys makes them.
Compute dtype and param dtype come from ArchConfig.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --- initializers ----------------------------------------------------------

def normal(gen: Optional[torch.Generator], shape: Tuple[int, ...],
           device) -> torch.Tensor:
    """Standard-normal f32 draws from ``gen`` on ``device``; an empty
    tensor of that shape on the meta device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# --------------------------------------------------------------------------
# products with a weight matrix, and remat's "dots" policy
# --------------------------------------------------------------------------

_KEEPING = threading.local()


class KeptProducts:
    """The outputs of one rematerialized layer's weight products, in call
    order (``models/model.py``'s remat policy "dots").  The layer's
    forward records each product's output; when the backward recomputes
    the layer, each ``dot`` takes its output back instead of multiplying
    again, so the recompute runs only the rest (norms, K6, K7, the
    elementwise ops).  Both passes save the same tensors, the product's
    operands, as non-reentrant checkpointing requires."""

    def __init__(self):
        self.outs: list = []
        self.next: Optional[int] = None   # the index to take when replaying

    @contextlib.contextmanager
    def _active(self, next_index):
        self.next = next_index
        _KEEPING.kept = self
        try:
            yield
        finally:
            _KEEPING.kept = None

    def recording(self):
        return self._active(None)

    def replaying(self):
        return self._active(0)


class _KeptDot(torch.autograd.Function):
    """``x @ w`` whose output ``kept`` records, or hands back when it
    replays; the backward is ``aten.mm``'s (``grad @ w.T`` and ``x.T @
    grad`` on the rows folded), so the gradients are bit for bit those of
    ``x @ w``."""

    @staticmethod
    def forward(ctx, x, w, kept):
        ctx.save_for_backward(x, w)
        if kept.next is None:
            out = x.reshape(-1, x.shape[-1]).mm(w).reshape(
                *x.shape[:-1], w.shape[-1])
            kept.outs.append(out.detach())
            return out
        out, kept.outs[kept.next] = kept.outs[kept.next], None
        kept.next += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g.mm(w.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).t().mm(g)
        return gx, gw, None


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight matrix ``w`` (a product with no batch
    dimension, as ``jax.checkpoint_policies.dots_with_no_batch_dims_
    saveable`` names them).  Inside a layer under remat "dots" its output
    is kept for the backward (``KeptProducts``)."""
    kept = getattr(_KEEPING, "kept", None)
    return x @ w if kept is None else _KeptDot.apply(x, w, kept)


def dense_init(gen, d_in: int, d_out: int, dtype: torch.dtype, *,
               lead: Tuple[int, ...] = (), device=None) -> torch.Tensor:
    w = normal(gen, lead + (d_in, d_out), device or gen.device)
    return w.mul_(1.0 / np.sqrt(d_in)).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype: torch.dtype, *,
               device=None) -> torch.Tensor:
    return normal(gen, (vocab, d), device or gen.device).mul_(0.02).to(dtype)


# --- norms -----------------------------------------------------------------

def init_norm(cfg, d: Optional[int] = None, *, lead: Tuple[int, ...] = (),
              device):
    d = d or cfg.d_model
    pdt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones(lead + (d,), dtype=pdt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=pdt, device=device)
    return p


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm (gemma-style: scale is a +1 offset)
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * (1.0 + p["scale"].float())
    return y.to(x.dtype)


# --- rotary embeddings -----------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """float64, as the reference computes them; cast to f32 at use."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) int32."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)                                             # (D/2,)
    angles = positions[..., None].float() * freqs             # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, T, H, D); positions3: (B, T, 3) — temporal/height/width position
    ids.  Frequency channels are split across the three axes in proportion
    ``sections`` (t gets half, h/w a quarter each by default), the split
    computed with numpy as the reference computes it.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)                                             # (half,)
    total = sum(sections)
    bounds = np.cumsum([half * s // total for s in sections])
    chan_axis = np.zeros(half, np.int64)
    chan_axis[bounds[0]:bounds[1]] = 1
    chan_axis[bounds[1]:] = 2
    # angle per channel uses the position id of its assigned axis
    idx = torch.from_numpy(chan_axis).to(x.device)
    pos = positions3.float().index_select(-1, idx)            # (B, T, half)
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- FFN -------------------------------------------------------------------

def init_ffn(cfg, gen, d_ff: Optional[int] = None, *,
             lead: Tuple[int, ...] = (), device=None):
    d_ff = d_ff or cfg.d_ff
    pdt = dtype_of(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    if cfg.ffn in ("swiglu", "geglu"):
        return {
            "wi": dense_init(gen, cfg.d_model, d_ff, pdt, **kw),
            "wg": dense_init(gen, cfg.d_model, d_ff, pdt, **kw),
            "wo": dense_init(gen, d_ff, cfg.d_model, pdt, **kw),
        }
    return {  # plain gelu MLP (whisper)
        "wi": dense_init(gen, cfg.d_model, d_ff, pdt, **kw),
        "wo": dense_init(gen, d_ff, cfg.d_model, pdt, **kw),
    }


def apply_ffn(cfg, p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = dot(x, p["wi"].to(dt))
    if cfg.ffn == "swiglu":
        h = F.silu(dot(x, p["wg"].to(dt))) * h
    elif cfg.ffn == "geglu":
        h = F.gelu(dot(x, p["wg"].to(dt)), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dot(h, p["wo"].to(dt))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
