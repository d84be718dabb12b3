"""Plain float32 forward of the benchmark's hybrid model: Mamba-2 layers
and attention without positional encoding, each followed by a SwiGLU MLP,
with the muP multipliers (granite-4.0-h).

Written from the configuration file's equations alone, one layer at a time
over the whole sequence, with no cache, no kernel and no batching trick;
it imports nothing of the program (``fp8_round``, ``rms_norm``, ``swiglu``
and ``_linear`` come from this package's ``model.py``).  The parameters are
the tensors the benchmark drew from the seed, named as the program's
checkpoint tree names them: the layers of each run of one kind in
``layer_types`` stacked as one segment (``segments/seg<s>/u0/...``).

Widths come from the parameters' shapes; the file gives only what no shape
holds: ``layer_types[:num_hidden_layers]``, the multipliers
(``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier``, ``logits_scaling``), ``rms_norm_eps``,
``mamba_n_groups`` and ``mamba_d_conv``.

A Mamba-2 layer, over a sequence u (L, d)::

    [z | xBC | dt] = u @ w_in
    xBC = silu(causal depthwise conv(xBC) + conv_bias) -> x (H, P), B, C
    dt = softplus(dt + dt_bias),  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,  y_t = h_t . C_t + D x_t
    out = rmsnorm(y * silu(z)) @ w_out

The SSM is computed in its quadratic (dual) form in blocks of ``BLOCK``
positions, the state carried from block to block (``ssm_blocked``), so
that thousands of positions judge in seconds; ``ssm_steps`` is the
recurrence itself, one position at a time, that the tests hold it to.
The departures from the published model are the configuration file's
(``departures``): RMSNorm's weight stored as an offset from 1.

``quant="fp8"``: the control, as in ``model.py``: every operand of every
product with a weight matrix rounded to float8 e4m3 under one scale.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from .model import _linear, _plain_precision, rms_norm, swiglu

BLOCK = 256          # positions of a block of the SSM's dual form
QUERY_BLOCK = 512    # query rows of attention at a time


def layers(cfg: dict) -> Iterator[Tuple[int, int, str]]:
    """(segment, index in it, kind) of each layer: a run of layers of one
    kind is one segment."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    seg, i = -1, 0
    for n, kind in enumerate(kinds):
        if n == 0 or kind != kinds[n - 1]:
            seg, i = seg + 1, 0
        else:
            i += 1
        yield seg, i, kind


def _layer(params: Dict[str, torch.Tensor], seg: int, i: int):
    prefix = f"segments/seg{seg}/u0/"
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}


def _sub(p: Dict[str, torch.Tensor], prefix: str):
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def ssm_steps(x, dt, a, b, c):
    """The recurrence, one position at a time: x (L, H, P), dt (L, H),
    a (H,), b and c (L, H, N) → y (L, H, P), the last state (H, P, N)."""
    L, H, P = x.shape
    h = x.new_zeros((H, P, b.shape[-1]))
    ys = []
    for t in range(L):
        h = torch.exp(dt[t] * a)[:, None, None] * h \
            + (dt[t][:, None] * x[t])[..., None] * b[t][:, None, :]
        ys.append((h * c[t][:, None, :]).sum(-1))
    return torch.stack(ys), h


def ssm_blocked(x, dt, a, b, c, block: int = BLOCK):
    """The same recurrence in its dual form, block by block: inside a block
    ``y = (exp(segsum) * (C B^T)) (dt x)`` plus the carried state's share;
    the state after each block from its inputs, decayed to its end."""
    L, H, P = x.shape
    h = x.new_zeros((H, P, b.shape[-1]))
    y = torch.empty_like(x)
    for t0 in range(0, L, block):
        t1 = min(t0 + block, L)
        la = dt[t0:t1] * a                                   # (Q, H)
        cum = torch.cumsum(la, 0)
        seg = cum[:, None, :] - cum[None, :, :]              # (i, j, H)
        lower = torch.tril(torch.ones(t1 - t0, t1 - t0, dtype=torch.bool,
                                      device=x.device))[..., None]
        decay = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)),
                            0.0)
        scores = torch.einsum("ihn,jhn->ijh", c[t0:t1], b[t0:t1]) * decay
        u = dt[t0:t1][..., None] * x[t0:t1]                  # (Q, H, P)
        y[t0:t1] = torch.einsum("ijh,jhp->ihp", scores, u) \
            + torch.einsum("ihn,hpn->ihp", c[t0:t1], h) \
            * torch.exp(cum)[..., None]
        tail = torch.exp(cum[-1][None, :] - cum)             # (Q, H)
        h = torch.exp(cum[-1])[:, None, None] * h \
            + torch.einsum("jh,jhp,jhn->hpn", tail, u, b[t0:t1])
    return y, h


def mamba_inputs(cfg: dict, p: Dict[str, torch.Tensor], u, quant):
    """(z, x (L, H, P), dt (L, H), a (H,), b, c (L, H, N)) of one layer."""
    H = p["A_log"].shape[-1]
    d_inner = p["w_out"].shape[0]
    P = d_inner // H
    G, W = cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    conv_dim = p["conv"].shape[-1]
    N = (conv_dim - d_inner) // (2 * G)
    L = u.shape[0]
    zxbcdt = _linear(u, p["w_in"], quant)
    z, xbc, dt = zxbcdt.split([d_inner, conv_dim, H], dim=-1)
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    w = p["conv"].float()                                    # (W, conv_dim)
    conv = sum(padded[k:k + L] * w[k] for k in range(W))
    xbc = F.silu(conv + p["conv_bias"].float())
    x, b, c = xbc.split([d_inner, G * N, G * N], dim=-1)
    rep = H // G
    b = b.reshape(L, G, N).repeat_interleave(rep, dim=1)
    c = c.reshape(L, G, N).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    return z, x.reshape(L, H, P), dt, a, b, c


def mamba(cfg: dict, p: Dict[str, torch.Tensor], u, quant):
    z, x, dt, a, b, c = mamba_inputs(cfg, p, u, quant)
    y, _ = ssm_blocked(x, dt, a, b, c)
    y = (y + p["D"].float()[:, None] * x).reshape(u.shape[0], -1)
    g = rms_norm(y * F.silu(z), p["norm/scale"], cfg["rms_norm_eps"])
    return _linear(g, p["w_out"], quant)


def attention(cfg: dict, p: Dict[str, torch.Tensor], x, quant):
    """Causal GQA over x (L, d) with no positional encoding, scores scaled
    by ``attention_multiplier``, QUERY_BLOCK query rows at a time."""
    L = x.shape[0]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["head_dim"]
    q = _linear(x, p["wq"], quant).view(L, H, D)
    k = _linear(x, p["wk"], quant).view(L, K, D)
    v = _linear(x, p["wv"], quant).view(L, K, D)
    k = k.repeat_interleave(H // K, dim=1)              # head h reads h // G
    v = v.repeat_interleave(H // K, dim=1)
    o = torch.empty_like(q)
    for q0 in range(0, L, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, L)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) \
            * cfg["attention_multiplier"]
        rows = torch.arange(q0, q1, device=x.device)[:, None]
        cols = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        o[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:q1])
    return _linear(o.reshape(L, H * D), p["wo"], quant)


def forward_logits(cfg: dict, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, first: int,
                   quant: Optional[str] = None) -> torch.Tensor:
    """Logits (L - first, V) in float32 at positions first.. of one
    sequence ``tokens`` (L,)."""
    if cfg.get("position_embedding_type", "nope") != "nope":
        raise ValueError("the hybrid reference has no positional encoding")
    _plain_precision()
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = params["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    for seg, i, kind in layers(cfg):
        lp = _layer(params, seg, i)
        h = rms_norm(x, lp["norm1/scale"], eps)
        mixer = mamba if kind == "mamba" else attention
        x = x + res * mixer(cfg, _sub(lp, "mixer/"), h, quant)
        h = rms_norm(x, lp["norm2/scale"], eps)
        x = x + res * swiglu(h, lp["ffn/wi"], lp["ffn/wg"], lp["ffn/wo"],
                             quant)
    h = rms_norm(x[first:], params["final_norm/scale"], eps)
    head = (params["embed"].t() if cfg["tie_word_embeddings"]
            else params["lm_head"])
    return _linear(h, head, quant) / cfg["logits_scaling"]


def served_logits(cfg: dict, params: Dict[str, torch.Tensor],
                  prompts: torch.Tensor, served: torch.Tensor,
                  quant: Optional[str] = None) -> torch.Tensor:
    """For prompts (B, T) and the tokens served after them (B, N): the
    reference's logits (B, N, V) at the positions that chose them, the
    prompt's last and each served one but the last."""
    B, T = prompts.shape
    return torch.stack([
        forward_logits(cfg, params, torch.cat([prompts[b], served[b, :-1]]),
                       T - 1, quant) for b in range(B)])
