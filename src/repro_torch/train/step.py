"""The train step (port of ``repro.train.step``): loss, gradients, clipping
and the optimizer, with optional microbatch accumulation.

The gradient is autograd's (``torch.autograd.grad``) through ``loss_fn``:
K6 and K7 forward and backward on the card, their plain versions on the
CPU.  The compressed data-parallel step of the reference
(``topk_ef_compress``, ``int8_allreduce``, ``make_compressed_dp_step``)
needs a data-parallel mesh and is not ported yet (ROADMAP Queue 1 item
10b).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _tree
from repro_torch.models import loss_fn
from repro_torch.train.optim import OptConfig, apply_opt, clip_by_global_norm


def loss_and_grads(cfg, params, batch):
    """(loss, gradient tree) of ``loss_fn`` at ``params``."""
    named, treedef = _tree.flatten_with_names(params)
    live = [p.detach().requires_grad_(True) for _, p in named]
    with torch.enable_grad():
        loss = loss_fn(cfg, _tree.unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def make_train_step(cfg, oc: OptConfig = OptConfig(), *,
                    microbatch: Optional[int] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``microbatch``: split the global batch into N accumulation
    chunks.  The update is written into ``params`` and ``opt_state``
    (``optim.apply_opt``); ``metrics["loss"]`` is the loss at the
    parameters the step was given."""

    def train_step(params, opt_state, batch):
        if microbatch and microbatch > 1:
            loss, grads = 0.0, None
            for i in range(microbatch):
                mb = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = loss_and_grads(cfg, params, mb)
                loss = loss + l
                named, treedef = _tree.flatten_with_names(g)
                g32 = [x.float() for _, x in named]
                grads = g32 if grads is None else [a + b for a, b in
                                                   zip(grads, g32)]
            loss = loss / microbatch
            grads = _tree.unflatten(treedef, [g / microbatch for g in grads])
        else:
            loss, grads = loss_and_grads(cfg, params, batch)

        if oc.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
        else:
            gnorm = torch.zeros((), device=loss.device)
        params, opt_state = apply_opt(oc, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
