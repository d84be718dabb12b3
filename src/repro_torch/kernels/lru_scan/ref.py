"""Plain PyTorch version of K7 (port of
``repro.kernels.lru_scan.ref.lru_scan_ref``).

The CPU tests and the model on the CPU use it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card; its gradient is autograd's through
the loop.  Unlike the reference's oracle it carries ``h`` in f32 for every
input dtype, as the reference's kernel and entry point do
(``lru_scan/kernel.py:35``), and writes each step in ``a``'s dtype.

Beside it, the CPU models of K7's two kernels, which nothing on the main
path calls: :func:`lru_scan_chunked_ref`, the forward in the forward
kernel's order (chunks walked from a zero carry, the carries chained from
the first chunk to the last, each chunk walked again from its true carry),
and :func:`lru_scan_backward_chunked_ref`, the backward in the backward
kernel's order (the same, from the last chunk to the first).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1; a, b: (B, T, R); h0: (B, R)
    initial state (zeros if None).  Returns h: (B, T, R) in a.dtype."""
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device) if h0 is None else h0.float())
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out.append(h.to(a.dtype))
    return torch.stack(out, dim=1)


def lru_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                          h0: Optional[torch.Tensor], dh: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """The backward of :func:`lru_scan_ref` step by step, from the
    forward's ``h`` as K7's backward reads it: (da, db, dh0) in a's dtype
    with an f32 carry, dh0 None without h0.  With g_t = dh_t +
    a_{t+1} g_{t+1}: db_t = g_t, da_t = g_t h_{t-1}, dh0 = a_0 g_0.  For f32
    and f64 inputs ``h`` holds the carry exactly, so this is autograd's
    gradient through :func:`lru_scan_ref`."""
    g = torch.zeros(a[:, 0].shape, dtype=torch.float32, device=a.device)
    a_next = torch.zeros_like(g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh[:, t].float() + a_next * g
        db[:, t] = g.to(a.dtype)
        h_prev = h[:, t - 1].float() if t else (
            torch.zeros_like(g) if h0 is None else h0.float())
        da[:, t] = (g * h_prev).to(a.dtype)
        a_next = a[:, t].float()
    return da, db, None if h0 is None else (a_next * g).to(h0.dtype)


# Time steps per chunk in K7's forward and backward kernels
# (csrc/lru_scan.cu kSteps).
FWD_CHUNK = 8
BWD_CHUNK = 8


def lru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         chunk: int = FWD_CHUNK) -> torch.Tensor:
    """:func:`lru_scan_ref` in chunks of ``chunk`` steps: h (B, T, R) in
    a's dtype with an f32 carry.

    A chunk [s, e) walked from h = 0 gives c^ (its last h) and
    Q = a_s ... a_{e-1}; its true last h is c^ + Q h_{s-1}, with h0 (or 0)
    before the first chunk.  Chunks start at multiples of ``chunk``; steps
    past T act as a = 1, b = 0.  Each step rounds a h and + b separately,
    as the plain version does, so the first chunk is bit for bit
    :func:`lru_scan_ref`'s, and later chunks differ by the chain's one
    rounding a chunk."""
    B, T, R = a.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    f = torch.float32

    def chunks(t, fill):
        t = torch.nn.functional.pad(t.to(f), (0, 0, 0, pad), value=fill)
        return t.view(B, n, chunk, R)

    av, bv = chunks(a, 1.0), chunks(b, 0.0)
    # 1. every chunk from a zero carry
    x = torch.zeros((B, n, R), dtype=f, device=a.device)
    q = torch.ones_like(x)
    for u in range(chunk):
        x = av[:, :, u] * x + bv[:, :, u]
        q = q * av[:, :, u]
    # 2. the carries, from the first chunk to the last
    carry = (torch.zeros((B, R), dtype=f, device=a.device) if h0 is None
             else h0.to(f))
    c_in = torch.empty_like(x)
    for k in range(n):
        c_in[:, k] = carry
        carry = q[:, k] * carry + x[:, k]
    # 3. every chunk again from its true carry
    x = c_in
    h = torch.empty_like(av)
    for u in range(chunk):
        x = av[:, :, u] * x + bv[:, :, u]
        h[:, :, u] = x
    return h.view(B, n * chunk, R)[:, :T].to(a.dtype)


def lru_scan_backward_chunked_ref(a: torch.Tensor, h: torch.Tensor,
                                  h0: Optional[torch.Tensor],
                                  dh: torch.Tensor, chunk: int = BWD_CHUNK
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             Optional[torch.Tensor]]:
    """The backward of :func:`lru_scan_ref` in chunks of ``chunk`` steps:
    (da, db, dh0) from a, the forward's h, h0 (or None) and dh, in a's
    dtype with an f32 carry; dh0 None without h0.

    With x_t = a_t g_t, the carry into step t - 1 (g_t = dh_t + x_{t+1},
    x_T = 0), a chunk [s, e) walked with x_e = 0 gives c^ = x_s and
    Q = a_s ... a_{e-1}; its true carry out is x_s = c^ + Q x_e.  Chunks
    start at multiples of ``chunk``; steps past T act as a = 1, dh = 0,
    which pass a carry through exactly.  Each step rounds x = a g and
    g = dh + x separately, as autograd through the plain version does."""
    B, T, R = a.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    f = torch.float32

    def chunks(t, fill):
        t = torch.nn.functional.pad(t.to(f), (0, 0, 0, pad), value=fill)
        return t.view(B, n, chunk, R)

    h_init = (torch.zeros((B, 1, R), dtype=f, device=a.device)
              if h0 is None else h0.to(f)[:, None])
    av, dv = chunks(a, 1.0), chunks(dh, 0.0)
    hp = chunks(torch.cat([h_init, h[:, :-1].to(f)], dim=1), 0.0)
    # 1. every chunk with a zero carry
    x = torch.zeros((B, n, R), dtype=f, device=a.device)
    q = torch.ones_like(x)
    for u in range(chunk - 1, -1, -1):
        x = av[:, :, u] * (dv[:, :, u] + x)
        q = q * av[:, :, u]
    # 2. the carries, from the last chunk to the first
    carry = torch.zeros((B, R), dtype=f, device=a.device)
    c_in = torch.empty_like(x)
    for k in range(n - 1, -1, -1):
        c_in[:, k] = carry
        carry = x[:, k] + q[:, k] * carry
    # 3. every chunk again with its true carry
    x = c_in
    da, db = torch.empty_like(av), torch.empty_like(av)
    for u in range(chunk - 1, -1, -1):
        g = dv[:, :, u] + x
        db[:, :, u] = g
        da[:, :, u] = g * hp[:, :, u]
        x = av[:, :, u] * g
    da, db = (t.view(B, n * chunk, R)[:, :T].to(a.dtype) for t in (da, db))
    return da, db, None if h0 is None else carry.to(h0.dtype)
