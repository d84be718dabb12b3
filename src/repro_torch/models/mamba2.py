"""Mamba-2 mixer (the state-space layers of granite-4.0-h): a port-only
layer, with no counterpart in the reference package.

Per layer, from ``cfg.mamba`` (H heads of P channels, d_inner = H * P, G
groups of an N-wide state, a causal conv of width W over the
``conv_dim = d_inner + 2 G N`` channels of ``xBC``)::

    [z | xBC | dt] = u @ w_in                     widths d_inner | conv_dim | H
    xBC = silu(causal_depthwise_conv(xBC) + conv_bias) -> x (H, P), B, C (G, N)
    dt  = softplus(dt + dt_bias),  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,  y_t = h_t C_t + D x_t
    out = RMSNorm(y * silu(z)) (1 + norm/scale) @ w_out

(head h reads group h // (H / G)).  The prefill and the training forward
compute the recurrence in the chunked SSD form (``cfg.mamba.chunk``
positions a chunk): within a chunk the quadratic (dual) form, across chunks
the state carried chunk by chunk, in float32.  The decode step is the
recurrence itself.  Serving state, one layer: the SSM state ``ssm``
(B, H, P, N) in float32 and the conv history ``conv`` (B, W - 1, conv_dim),
the last W - 1 inputs of the conv, in the compute dtype (the RG-LRU's
convention, ``recurrent.py``); the decode step reads both whole.  The
decode's conv is an einsum over the history, so the aten graph that
participation walks attributes it element by element, and it runs in
float64 (``mamba2_decode``), so that no element of the history the step
reads gets an exactly zero derivative from silu's stationary point.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.models.layers import dense_init, dot, dtype_of, normal


def init_mamba2(cfg, gen, *, lead: Tuple[int, ...] = (),
                device=None) -> Dict[str, Any]:
    m = cfg.mamba
    pdt = dtype_of(cfg.param_dtype)
    device = device or gen.device
    kw = dict(lead=lead, device=device)
    H = m.n_heads
    # A in [1, 16) and dt in [1e-3, 0.1) at init, as Mamba-2 draws them
    a = np.linspace(1.0, 16.0, H, endpoint=False, dtype=np.float32)
    dt = np.exp(np.linspace(np.log(1e-3), np.log(0.1), H, dtype=np.float32))

    def per_head(v):
        return torch.from_numpy(v.astype(np.float32)).to(
            device=device, dtype=pdt).expand(lead + (H,)).contiguous()

    return {
        "w_in": dense_init(gen, cfg.d_model,
                           2 * m.d_inner + 2 * m.n_groups * m.d_state + H,
                           pdt, **kw),
        "conv": normal(gen, lead + (m.conv_width, m.conv_dim), device)
        .mul_(m.conv_width ** -0.5).to(pdt),
        "conv_bias": torch.zeros(lead + (m.conv_dim,), dtype=pdt,
                                 device=device),
        "dt_bias": per_head(dt + np.log(-np.expm1(-dt))),  # softplus^-1
        "A_log": per_head(np.log(a)),
        "D": torch.ones(lead + (H,), dtype=pdt, device=device),
        "norm": {"scale": torch.zeros(lead + (m.d_inner,), dtype=pdt,
                                      device=device)},
        "w_out": dense_init(gen, m.d_inner, cfg.d_model, pdt, **kw),
    }


def _split(cfg, zxbcdt: torch.Tensor):
    m = cfg.mamba
    return torch.split(zxbcdt, [m.d_inner, m.conv_dim, m.n_heads], dim=-1)


def _conv_out(p, conv: torch.Tensor) -> torch.Tensor:
    """The conv's output (…, conv_dim) with its bias, through silu."""
    return F.silu(conv + p["conv_bias"].to(conv.dtype))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C), w: (W, C): out_t = sum_k w[k] x_{t - W + 1 + k}."""
    W = w.shape[0]
    out = x * w[W - 1]
    for j in range(1, W):
        out = out + F.pad(x, (0, 0, j, 0))[:, :-j] * w[W - 1 - j]
    return out


def _xbc_groups(cfg, xbc: torch.Tensor):
    """xBC (..., conv_dim) → x (..., G, R, P) with R = H / G heads a group,
    B and C (..., G, N), in f32 (the conv runs in f32 in the prefill, in
    f64 in the decode)."""
    m = cfg.mamba
    x, b, c = torch.split(xbc.float(), [m.d_inner, m.n_groups * m.d_state,
                                        m.n_groups * m.d_state], dim=-1)
    lead = xbc.shape[:-1]
    G = m.n_groups
    return (x.reshape(lead + (G, m.n_heads // G, m.head_dim)),
            b.reshape(lead + (G, m.d_state)),
            c.reshape(lead + (G, m.d_state)))


def _per_head(cfg, v: torch.Tensor) -> torch.Tensor:
    """(..., H) → (..., G, R)."""
    G = cfg.mamba.n_groups
    return v.reshape(v.shape[:-1] + (G, v.shape[-1] // G))


def _dt_a(cfg, p, dt_raw: torch.Tensor):
    """dt (..., G, R) and A (G, R), f32."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return (_per_head(cfg, dt),
            _per_head(cfg, -torch.exp(p["A_log"].float())))


def _gated_out(cfg, p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)) over d_inner, then ``w_out``; y (B, T, d_inner)
    in f32, z in the compute dtype."""
    g = y * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + cfg.norm_eps)
    g = (g * (1.0 + p["norm"]["scale"].float())).to(z.dtype)
    return dot(g, p["w_out"].to(z.dtype))


def ssd_scan(x, dt, a, b, c, chunk: int, h0=None):
    """The SSM over a sequence in the chunked SSD form, in f32.

    x (B, T, G, R, P) (R heads of group g: heads g R .. g R + R - 1), dt
    (B, T, G, R), a (G, R), b and c (B, T, G, N); ``h0`` (B, G, R, P, N) or
    zeros.  Returns y (B, T, G, R, P) without the D skip, and the state
    after the last position.  Within a chunk of Q positions:
    ``y_i = sum_{j<=i} exp(s_i - s_j) (c_i . b_j) dt_j x_j
    + exp(s_i) c_i . h`` with ``s`` the cumulative sum of ``dt a`` over the
    chunk and ``h`` the state carried in; then
    ``h <- exp(s_last) h + sum_j exp(s_last - s_j) dt_j x_j (x) b_j``.
    """
    Bsz, T, G, R, P = x.shape
    h = (x.new_zeros((Bsz, G, R, P, b.shape[-1])) if h0 is None
         else h0.float())
    ys = []
    for t0 in range(0, T, chunk):
        xs, dts = x[:, t0:t0 + chunk], dt[:, t0:t0 + chunk]
        bs, cs = b[:, t0:t0 + chunk], c[:, t0:t0 + chunk]
        Q = xs.shape[1]
        s = torch.cumsum(dts * a, dim=1)                     # (B, Q, G, R)
        s_h = s.permute(0, 2, 3, 1)                          # (B, G, R, Q)
        causal = torch.ones(Q, Q, dtype=torch.bool,
                            device=x.device).tril()
        decay = torch.exp(torch.where(
            causal, s_h[..., :, None] - s_h[..., None, :],
            torch.full((), float("-inf"), device=x.device)))
        cb = torch.einsum("bign,bjgn->bgij", cs, bs)         # (B, G, Q, Q)
        u = xs * dts[..., None]                              # dt_j x_j
        y = torch.einsum("bgrij,bjgrp->bigrp", decay * cb[:, :, None], u)
        y = y + torch.einsum("bign,bgrpn->bigrp", cs, h) \
            * torch.exp(s)[..., None]
        last = s[:, -1]                                      # (B, G, R)
        w = torch.exp(last[:, None] - s)                     # (B, Q, G, R)
        h = h * torch.exp(last)[..., None, None] + torch.einsum(
            "bjgr,bjgrp,bjgn->bgrpn", w, u, bs)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _run(cfg, p, u: torch.Tensor):
    """The mixer over a sequence u (B, T, d) → (output, ssm state, the
    conv's input (B, T, conv_dim) in the compute dtype)."""
    m = cfg.mamba
    dt_ = u.dtype
    Bsz, T, _ = u.shape
    z, xbc_in, dt_raw = _split(cfg, dot(u, p["w_in"].to(dt_)))
    xbc = _conv_out(p, _causal_conv(xbc_in.float(), p["conv"].float()))
    x, b, c = _xbc_groups(cfg, xbc)
    dt, a = _dt_a(cfg, p, dt_raw)
    with obs.get_obs().tracer.span("ssm.scan", batch=Bsz, tokens=T,
                                   chunk=m.chunk):
        y, h = ssd_scan(x, dt, a, b, c, m.chunk)
    y = y + x * _per_head(cfg, p["D"].float())[..., None]
    return (_gated_out(cfg, p, y.reshape(Bsz, T, m.d_inner), z),
            h.reshape(Bsz, m.n_heads, m.head_dim, m.d_state), xbc_in)


def mamba2_train(cfg, p, u: torch.Tensor) -> torch.Tensor:
    return _run(cfg, p, u)[0]


def mamba2_prefill(cfg, p, u: torch.Tensor):
    """Block output and the decode state at T.  A prompt shorter than the
    conv history gets zero rows in front, the history the conv pads
    with."""
    out, h, xbc_in = _run(cfg, p, u)
    hist = xbc_in[:, -(cfg.mamba.conv_width - 1):]
    hist = F.pad(hist, (0, 0, cfg.mamba.conv_width - 1 - hist.shape[1], 0))
    return out, {"ssm": h, "conv": hist.to(dtype_of(cfg.dtype))}


def mamba2_init_state(cfg, batch: int, *, lead: Tuple[int, ...] = (),
                      device):
    m = cfg.mamba
    return {"ssm": torch.zeros(lead + (batch, m.n_heads, m.head_dim,
                                       m.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, m.conv_width - 1, m.conv_dim),
                                dtype=dtype_of(cfg.dtype), device=device)}


def mamba2_decode(cfg, p, u: torch.Tensor, state):
    """u: (B, 1, d) → (out (B, 1, d), the new state)."""
    m = cfg.mamba
    dt_ = u.dtype
    Bsz = u.shape[0]
    with obs.get_obs().tracer.span("ssm.step", batch=Bsz):
        z, xbc_new, dt_raw = _split(cfg, dot(u[:, 0], p["w_in"].to(dt_)))
        # the history, the conv and its silu in float64, so that the AD
        # scrutiny finds every element of the history the step reads: silu
        # is stationary at x = -1.2785, and an output that lands there in
        # the compute dtype gives the history it read an exactly zero
        # derivative (in bf16 about 1 channel in 1,000 a step, in f32 1 in
        # 10^7); and the two steps' derivatives of one history row, summed
        # in bf16, cancel to exactly zero about once in 10^6
        f64 = torch.float64
        hist = torch.cat([state["conv"].to(f64), xbc_new.to(f64)[:, None]],
                         dim=1)
        xbc = _conv_out(p, torch.einsum("bwc,wc->bc", hist,
                                        p["conv"].to(f64)))
        x, b, c = _xbc_groups(cfg, xbc)          # (B, G, R, P), (B, G, N)
        dt, a = _dt_a(cfg, p, dt_raw)             # (B, G, R), (G, R)
        h = state["ssm"].float().reshape(x.shape + (m.d_state,))
        h = h * torch.exp(dt * a)[..., None, None] \
            + (x * dt[..., None])[..., None] * b[:, :, None, None, :]
        y = torch.einsum("bgrpn,bgn->bgrp", h, c) \
            + x * _per_head(cfg, p["D"].float())[..., None]
        out = _gated_out(cfg, p, y.reshape(Bsz, 1, m.d_inner), z[:, None])
    return out, {"ssm": h.reshape(Bsz, m.n_heads, m.head_dim, m.d_state),
                 "conv": hist[:, 1:].to(state["conv"].dtype)}
