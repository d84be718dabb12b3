"""Mixture-of-Experts (port of ``repro.models.moe``): top-k router, per-row
capacity in training, dropless inference, shared experts.

The routing is the reference's, decision for decision: router logits in
x's dtype, then f32 softmax, top-k with ties to the lower expert index
(``lax.top_k``'s order: the first K of a stable descending sort; ``torch.
topk`` promises no order on ties), renormalised weights, the Switch aux
loss, and in training a per-row capacity ``C = max(1, int(S/E · cf))``
that keeps each expert's first C slots in the order of a stable per-row
sort of the slots' expert ids.

The dispatch is not the reference's (B, E, S, d) buffer, which holds
every expert's capacity whether routed or not (dropless, S = T·K: 8.6 GB
a layer for olmoe at B=4, T=1024, and 64 times the routed products):
each expert that a slot routes to gathers its kept slots' rows
(``nonzero`` of its id: one host sync per expert), runs its three
products with ``torch.matmul`` on its own weights (a view; a cast, where
the parameters are not in the compute dtype, of that expert only), and
writes its outputs into a (B·T·K, d) buffer of slots, zero for dropped
slots; the buffer is combined with the router weights in f32 as the
reference combines it (``moe.py:141-142``).  The same function in
another summation order: it equals the reference's within a tolerance.
An expert no kept slot routes to adds no node to a traced step, so
participation finds its weights uncritical, as the reference's taint
does through its einsum's expert batch dimension.

The reference's ``set_dispatch("global")`` / ``_apply_moe_global`` is its
XLA resharding baseline (one argsort over every slot of the batch) and is
not ported, as the attention module's auto/full/chunked switch is not.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dot, dtype_of

CAPACITY_FACTOR = 1.25


def init_moe(cfg, gen, *, lead: Tuple[int, ...] = (),
             device=None) -> Dict[str, Any]:
    """The router (d, E) and the experts' stacked ``wi``/``wg`` (E, d, f)
    and ``wo`` (E, f, d); ``shared`` likewise for the always-on experts."""
    m = cfg.moe
    pdt = dtype_of(cfg.param_dtype)
    E, d, f = m.num_experts, cfg.d_model, m.d_expert
    kw = dict(device=device)

    def stack(din, dout, n):
        return dense_init(gen, din, dout, pdt, lead=lead + (n,), **kw)

    p = {"router": dense_init(gen, d, E, pdt, lead=lead, **kw),
         "wi": stack(d, f, E), "wg": stack(d, f, E), "wo": stack(f, d, E)}
    if m.num_shared:
        p["shared"] = {"wi": stack(d, f, m.num_shared),
                       "wg": stack(d, f, m.num_shared),
                       "wo": stack(f, d, m.num_shared)}
    return p


def _experts_ffn(wi, wg, wo, x):  # x: (E, C, d)
    dt = x.dtype
    h = torch.einsum("ecd,edf->ecf", x, wi.to(dt))
    g = torch.einsum("ecd,edf->ecf", x, wg.to(dt))
    h = F.silu(g) * h
    return torch.einsum("ecf,efd->ecd", h, wo.to(dt))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index, as ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def kept_slots(flat_e: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """(B, S) bool: slot s of row b is kept when fewer than C slots of row
    b before it in a stable sort of the row's expert ids go to its
    expert."""
    B, S = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = flat_e.gather(1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=flat_e.device)
    counts = counts.scatter_add(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    slot = (torch.arange(S, device=flat_e.device)[None, :]
            - starts.gather(1, e_sorted))
    return torch.zeros((B, S), dtype=torch.bool,
                       device=flat_e.device).scatter(1, order, slot < C)


def apply_moe(cfg, p, x: torch.Tensor, *,
              capacity_factor: float = CAPACITY_FACTOR, train: bool = False):
    """x: (B, T, d) → (out (B, T, d), aux_loss 0-d f32).

    ``train`` turns on the per-row capacity; inference runs dropless (the
    reference's reason: a token's output must not depend on the row
    length, or prefill + decode could never reproduce the forward)."""
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.num_experts, m.top_k
    S = T * K                                             # slots per row
    dt = x.dtype

    logits = dot(x, p["router"].to(dt)).float()              # (B,T,E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, K)                        # (B,T,K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # --- load-balancing aux loss (Switch-style) -------------------------
    me = probs.mean((0, 1))                               # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add(
        0, top_e.reshape(-1), torch.ones(B * S, device=x.device)) / (B * S)
    aux = m.aux_loss_coef * E * torch.sum(me * ce)

    # --- dispatch: each routed expert on its kept slots ------------------
    flat_e = top_e.reshape(B, S)
    if train:
        C = max(1, int(S / E * capacity_factor))
        flat_e = torch.where(kept_slots(flat_e, E, C), flat_e, E)
    flat_e = flat_e.reshape(-1)                           # (B·S,), E: dropped
    xf = x.reshape(B * T, d)
    # one unbind a weight: its backward stacks the experts' gradients
    # once, where indexing each expert would add a full-size one per expert
    wi, wg, wo = (torch.unbind(p[n]) for n in ("wi", "wg", "wo"))
    slots = torch.zeros((B * S, d), dtype=dt, device=x.device)
    for e in range(E):
        idx = torch.nonzero(flat_e == e)[:, 0]            # slots, in order
        if idx.shape[0] == 0:
            continue
        xe = xf.index_select(0, torch.div(idx, K, rounding_mode="floor"))
        h = xe @ wi[e].to(dt)
        g = xe @ wg[e].to(dt)
        slots = slots.index_copy(0, idx, (F.silu(g) * h) @ wo[e].to(dt))
    out = torch.einsum("nkd,nk->nd", slots.reshape(B * T, K, d).float(),
                       top_w.reshape(B * T, K)).to(dt).reshape(B, T, d)

    if m.num_shared:
        sh = p["shared"]
        s = _experts_ffn(sh["wi"], sh["wg"], sh["wo"],
                         xf.expand(m.num_shared, B * T, d))
        out = out + s.sum(0).to(dt).reshape(B, T, d)
    return out, aux
