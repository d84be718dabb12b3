"""Optimizers (port of ``repro.train.optim``): AdamW and Adafactor, plus
global-norm clipping.

Functions over nested-dict trees, with the reference's state trees (AdamW
``{"mu", "nu", "step"}``, Adafactor ``{"slots", "step"}``) so scrutiny
masks and step directories carry the same leaf names.  The reference's
updates are pure; here ``apply_opt`` writes the new parameters and
moments into the tensors it is given, leaf by leaf under
``torch.no_grad()``, and returns the same trees: a pure update would hold
the old and the new state at once (two copies of 12 B per parameter under
AdamW).  The arithmetic is the reference's, in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import _tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup: int = 100
    decay_steps: int = 10_000


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to a tenth; f32 0-d tensor."""
    s = step.float()
    warm = torch.clamp((s + 1) / max(1, oc.warmup), max=1.0)
    prog = torch.clamp((s - oc.warmup) / max(1, oc.decay_steps - oc.warmup),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in _tree.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    named, treedef = _tree.flatten_with_names(grads)
    return _tree.unflatten(treedef, [(g.float() * scale).to(g.dtype)
                                     for _, g in named]), n


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _zeros_f32(tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
                                     for _, p in named])


def adamw_init(params) -> Dict[str, Any]:
    device = _tree.leaves(params)[0].device
    return {"mu": _zeros_f32(params), "nu": _zeros_f32(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, state):
    step = state["step"] + 1
    lr = schedule(oc, step)
    t = step.float()
    bc1 = 1 - oc.b1 ** t
    bc2 = 1 - oc.b2 ** t
    for p, g, mu, nu in zip(_tree.leaves(params), _tree.leaves(grads),
                            _tree.leaves(state["mu"]),
                            _tree.leaves(state["nu"])):
        g32 = g.float()
        mu.copy_(oc.b1 * mu + (1 - oc.b1) * g32)
        nu.copy_(oc.b2 * nu + (1 - oc.b2) * g32 * g32)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + oc.eps)
        u = u + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state


# --------------------------------------------------------------------------
# Adafactor (factored second moments over the trailing two dims)
# --------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adafactor_init(params) -> Dict[str, Any]:
    def slot(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    named, treedef = _tree.flatten_with_names(params)
    device = named[0][1].device
    return {"slots": _tree.unflatten(treedef, [slot(p) for _, p in named]),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adafactor_update(oc: OptConfig, params, grads, state):
    step = state["step"] + 1
    lr = schedule(oc, step)
    beta = 1.0 - (step.float() + 1.0) ** -0.8
    named, _ = _tree.flatten_with_names(params)
    for (name, p), g in zip(named, _tree.leaves(grads)):
        slot = state["slots"]
        for key in name.split("/"):
            slot = slot[key]
        g32 = g.float()
        g2 = g32 * g32 + 1e-30
        if _factored(p):
            slot["vr"].copy_(beta * slot["vr"] + (1 - beta) * g2.mean(-1))
            slot["vc"].copy_(beta * slot["vc"] + (1 - beta) * g2.mean(-2))
            denom = slot["vr"].mean(-1, keepdim=True)[..., None]
            v = (slot["vr"][..., None] * slot["vc"][..., None, :]) / \
                torch.clamp(denom, min=1e-30)
        else:
            slot["v"].copy_(beta * slot["v"] + (1 - beta) * g2)
            v = slot["v"]
        u = g32 * torch.rsqrt(v + 1e-30)
        # update clipping (RMS <= 1) per Adafactor
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state


def init_opt(oc: OptConfig, params):
    return adamw_init(params) if oc.kind == "adamw" else adafactor_init(params)


def apply_opt(oc: OptConfig, params, grads, state):
    """One update, written into ``params`` and ``state``; returns them."""
    if oc.kind == "adamw":
        return adamw_update(oc, params, grads, state)
    return adafactor_update(oc, params, grads, state)
