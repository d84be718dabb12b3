"""Recurrent blocks (port of ``repro.models.recurrent``): RG-LRU
(RecurrentGemma/Griffin), mLSTM and sLSTM (xLSTM).

Training runs the diagonal RG-LRU recurrence through the port's
``lru_scan`` (K7 on the card, its plain loop on the CPU), where the
reference uses ``lax.associative_scan``: the same recurrence in another
association order, so the two agree to f32 rounding, not to the bit.  The
matrix and scalar LSTM cells are plain loops over T, as the reference's
``lax.scan``.  Decode carries an explicit recurrent state, the
constant-size serving cache.

Initializers draw from a ``torch.Generator`` (the reference's
``jax.random`` keys give other numbers; the parity tests carry parameters
across with ``convert.params_from_numpy``); ``lead`` prepends a segment's
layer count.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.models.layers import dense_init, dot, dtype_of, normal

_CONV_W = 4  # temporal conv width (griffin / xlstm)
_LRU_C = 8.0
_M_INIT = -1e30  # the LSTM stabilizer's start value


# --------------------------------------------------------------------------
# RG-LRU (griffin) block
# --------------------------------------------------------------------------

def init_rglru(cfg, gen, *, lead: Tuple[int, ...] = (),
               device=None) -> Dict[str, Any]:
    pdt = dtype_of(cfg.param_dtype)
    d, r = cfg.d_model, cfg.lru_dim or cfg.d_model
    device = device or gen.device
    kw = dict(lead=lead, device=device)
    # Λ init so that a = sigmoid(Λ)^(c) spreads over (0.9, 0.999)
    lam = torch.from_numpy(np.log(np.expm1(
        np.linspace(0.9, 0.999, r, dtype=np.float32) ** (1.0 / _LRU_C)))
        .astype(np.float32))
    return {
        "w_in": dense_init(gen, d, r, pdt, **kw),
        "w_gate": dense_init(gen, d, r, pdt, **kw),
        "conv": normal(gen, lead + (_CONV_W, r), device).mul_(0.1).to(pdt),
        "w_a": dense_init(gen, r, r, pdt, **kw),
        "w_x": dense_init(gen, r, r, pdt, **kw),
        "lambda": lam.to(device=device, dtype=pdt).expand(lead + (r,))
        .contiguous(),
        "w_out": dense_init(gen, r, d, pdt, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, r), w: (W, r) depthwise causal conv."""
    W = w.shape[0]
    out = x * w[W - 1]
    for j in range(1, W):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[W - 1 - j]
    return out


def _rglru_hidden(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The RG-LRU's hidden sequence h (B, T, r), f32."""
    dt = x.dtype
    u = dot(x, p["w_in"].to(dt))                       # (B,T,r)
    u = _causal_conv(u, p["conv"].to(dt))
    r_gate = torch.sigmoid(dot(u, p["w_a"].to(dt)).float())
    i_gate = torch.sigmoid(dot(u, p["w_x"].to(dt)).float())
    log_a = -_LRU_C * F.softplus(p["lambda"].float()) * r_gate
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i_gate * u.float())
    return lru_scan(torch.exp(log_a), b)


def _rglru_out(p, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = F.gelu(dot(x, p["w_gate"].to(dt)), approximate="tanh")
    return dot(h.to(dt) * gate, p["w_out"].to(dt))


def rglru_train(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return _rglru_out(p, x, _rglru_hidden(cfg, p, x))


def rglru_prefill(cfg, p, x: torch.Tensor):
    """Block output and the decode state at T from one scan: the
    reference's prefill scans twice (``model.py:538-541``), once inside
    ``rglru_train`` and once more for the last hidden state.  A prompt
    shorter than the conv history gets zero rows in front, the history
    ``_causal_conv`` pads with, so its state decodes (the reference keeps
    T rows there and its next decode step fails)."""
    dt = dtype_of(cfg.dtype)
    h = _rglru_hidden(cfg, p, x)
    u = dot(x, p["w_in"].to(x.dtype))
    conv = u[:, -(_CONV_W - 1):]
    conv = F.pad(conv, (0, 0, _CONV_W - 1 - conv.shape[1], 0))
    state = {"h": h[:, -1].float(), "conv": conv.to(dt)}
    return _rglru_out(p, x, h), state


def rglru_init_state(cfg, batch: int, *, lead: Tuple[int, ...] = (),
                     device):
    dt = dtype_of(cfg.dtype)
    r = cfg.lru_dim or cfg.d_model
    return {"h": torch.zeros(lead + (batch, r), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, _CONV_W - 1, r), dtype=dt,
                                device=device)}


def rglru_decode(cfg, p, x: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
    """x: (B, 1, d)."""
    dt = x.dtype
    u = dot(x, p["w_in"].to(dt))[:, 0]                 # (B,r)
    hist = torch.cat([state["conv"], u[:, None]], dim=1)   # (B,W,r)
    u_c = torch.einsum("bwr,wr->br", hist, p["conv"].to(dt))
    r_gate = torch.sigmoid(dot(u_c, p["w_a"].to(dt)).float())
    i_gate = torch.sigmoid(dot(u_c, p["w_x"].to(dt)).float())
    log_a = -_LRU_C * F.softplus(p["lambda"].float()) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (
        i_gate * u_c.float())
    h = a * state["h"] + b
    gate = F.gelu(dot(x[:, 0], p["w_gate"].to(dt)), approximate="tanh")
    out = dot(h.to(dt) * gate, p["w_out"].to(dt))
    return out[:, None], {"h": h, "conv": hist[:, 1:]}


# --------------------------------------------------------------------------
# mLSTM (xLSTM) block — matrix memory, exponential gating with stabilizer
# --------------------------------------------------------------------------

def _heads(cfg) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, (cfg.lru_dim or cfg.d_model) // H


def init_mlstm(cfg, gen, *, lead: Tuple[int, ...] = (),
               device=None) -> Dict[str, Any]:
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    H, hd = _heads(cfg)
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, d, H * hd, pdt, **kw),
        "wk": dense_init(gen, d, H * hd, pdt, **kw),
        "wv": dense_init(gen, d, H * hd, pdt, **kw),
        "wi": dense_init(gen, d, H, pdt, **kw),
        "wf": dense_init(gen, d, H, pdt, **kw),
        "wz": dense_init(gen, d, H * hd, pdt, **kw),   # output gate branch
        "wo": dense_init(gen, H * hd, d, pdt, **kw),
    }


def time_loop(step, consts, carry, xs):
    """The cell ``step(consts, carry, x_t) -> (carry, h_t)`` over axis 1 of
    each of ``xs`` → (final carry, the h_t stacked on axis 1): the
    reference's ``lax.scan`` as a Python loop, one set of nodes a step in
    a traced graph.  The dry run (``launch/dryrun.py``) accounts it as one
    step T times."""
    hs = []
    for t in range(xs[0].shape[1]):
        carry, h = step(consts, carry, tuple(x[:, t] for x in xs))
        hs.append(h)
    return carry, torch.stack(hs, dim=1)


def _mlstm_qkvif(cfg, p, x):
    dt = x.dtype
    B, T, _ = x.shape
    H, hd = _heads(cfg)
    q = dot(x, p["wq"].to(dt)).reshape(B, T, H, hd).float()
    k = dot(x, p["wk"].to(dt)).reshape(B, T, H, hd).float()
    v = dot(x, p["wv"].to(dt)).reshape(B, T, H, hd).float()
    logi = dot(x, p["wi"].to(dt)).float()                # (B,T,H)
    logf = F.logsigmoid(dot(x, p["wf"].to(dt)).float())
    k = k / float(np.sqrt(np.float32(hd)))
    return q, k, v, logi, logf


def _mlstm_step(_consts, carry, inp):
    C, n, m = carry            # (B,H,hd,hd), (B,H,hd), (B,H)
    q, k, v, logi, logf = inp  # (B,H,hd) ×3, (B,H) ×2
    m_new = torch.maximum(logf + m, logi)
    i_p = torch.exp(logi - m_new)[..., None]
    f_p = torch.exp(logf + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * (v[..., :, None] * k[..., None, :])
    n = f_p * n + i_p * k
    h_num = torch.einsum("bhij,bhj->bhi", C, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                        min=1.0)
    return (C, n, m_new), h_num / h_den[..., None]


def mlstm_init_state(cfg, batch: int, *, lead: Tuple[int, ...] = (),
                     device):
    H, hd = _heads(cfg)
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (batch, H, hd, hd), **z),
            "n": torch.zeros(lead + (batch, H, hd), **z),
            "m": torch.full(lead + (batch, H), _M_INIT, **z)}


def _mlstm_run(cfg, p, x):
    """The cell over the sequence → (block output, final state)."""
    B, T, _ = x.shape
    H, hd = _heads(cfg)
    q, k, v, logi, logf = _mlstm_qkvif(cfg, p, x)
    s = mlstm_init_state(cfg, B, device=x.device)
    carry, h = time_loop(_mlstm_step, None, (s["C"], s["n"], s["m"]),
                         (q, k, v, logi, logf))
    h = h.reshape(B, T, H * hd).to(x.dtype)
    z = F.silu(dot(x, p["wz"].to(x.dtype)))
    out = dot(h * z, p["wo"].to(x.dtype))
    return out, {"C": carry[0], "n": carry[1], "m": carry[2]}


def mlstm_train(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return _mlstm_run(cfg, p, x)[0]


def mlstm_prefill(cfg, p, x: torch.Tensor):
    return _mlstm_run(cfg, p, x)


def mlstm_decode(cfg, p, x, state):
    q, k, v, logi, logf = _mlstm_qkvif(cfg, p, x)      # T = 1
    carry = (state["C"], state["n"], state["m"])
    carry, h = _mlstm_step(None, carry, (q[:, 0], k[:, 0], v[:, 0],
                                         logi[:, 0], logf[:, 0]))
    B = x.shape[0]
    h = h.reshape(B, 1, -1).to(x.dtype)
    z = F.silu(dot(x, p["wz"].to(x.dtype)))
    out = dot(h * z, p["wo"].to(x.dtype))
    return out, {"C": carry[0], "n": carry[1], "m": carry[2]}


# --------------------------------------------------------------------------
# sLSTM (xLSTM) block — scalar memory with recurrent head mixing
# --------------------------------------------------------------------------

def init_slstm(cfg, gen, *, lead: Tuple[int, ...] = (),
               device=None) -> Dict[str, Any]:
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    H, hd = _heads(cfg)
    device = device or gen.device
    kw = dict(lead=lead, device=device)
    p = {"wo": dense_init(gen, H * hd, d, pdt, **kw)}
    for g in ("z", "i", "f", "o"):
        p[f"w{g}"] = dense_init(gen, d, H * hd, pdt, **kw)
        # recurrent mixing is block-diagonal per head
        p[f"r{g}"] = normal(gen, lead + (H, hd, hd), device).mul_(
            1.0 / np.sqrt(hd)).to(pdt)
    return p


def _slstm_step(p32, carry, inp):
    c, n, m, h = carry          # all (B,H,hd)
    xz, xi, xf, xo = inp

    def rec(name, hh):
        return torch.einsum("bhj,hjk->bhk", hh, p32[name])

    z = torch.tanh(xz + rec("rz", h))
    logi = xi + rec("ri", h)
    logf = F.logsigmoid(xf + rec("rf", h))
    o = torch.sigmoid(xo + rec("ro", h))
    m_new = torch.maximum(logf + m, logi)
    i_p = torch.exp(logi - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h = o * c / torch.clamp(n, min=1.0)
    return (c, n, m_new, h), h


def _slstm_inputs(cfg, p, x):
    dt = x.dtype
    B, T, _ = x.shape
    H, hd = _heads(cfg)

    def proj(name):
        return dot(x, p[name].to(dt)).reshape(B, T, H, hd).float()

    return proj("wz"), proj("wi"), proj("wf"), proj("wo")


def _slstm_p32(p):
    return {k: p[k].float() for k in ("rz", "ri", "rf", "ro")}


def slstm_init_state(cfg, batch: int, *, lead: Tuple[int, ...] = (),
                     device):
    H, hd = _heads(cfg)
    z = dict(dtype=torch.float32, device=device)
    shape = lead + (batch, H, hd)
    return {"c": torch.zeros(shape, **z), "n": torch.zeros(shape, **z),
            "m": torch.full(shape, _M_INIT, **z),
            "h": torch.zeros(shape, **z)}


def _slstm_run(cfg, p, x):
    B, T, _ = x.shape
    H, hd = _heads(cfg)
    xz, xi, xf, xo = _slstm_inputs(cfg, p, x)
    p32 = _slstm_p32(p)
    s = slstm_init_state(cfg, B, device=x.device)
    carry, h = time_loop(_slstm_step, p32,
                         (s["c"], s["n"], s["m"], s["h"]), (xz, xi, xf, xo))
    h = h.reshape(B, T, H * hd).to(x.dtype)
    out = dot(h, p["wo"].to(x.dtype))
    return out, {"c": carry[0], "n": carry[1], "m": carry[2], "h": carry[3]}


def slstm_train(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return _slstm_run(cfg, p, x)[0]


def slstm_prefill(cfg, p, x: torch.Tensor):
    return _slstm_run(cfg, p, x)


def slstm_decode(cfg, p, x, state):
    xz, xi, xf, xo = _slstm_inputs(cfg, p, x)
    carry = (state["c"], state["n"], state["m"], state["h"])
    carry, h = _slstm_step(_slstm_p32(p), carry,
                           (xz[:, 0], xi[:, 0], xf[:, 0], xo[:, 0]))
    B = x.shape[0]
    out = dot(h.reshape(B, 1, -1).to(x.dtype), p["wo"].to(x.dtype))
    return out, {"c": carry[0], "n": carry[1], "m": carry[2], "h": carry[3]}
