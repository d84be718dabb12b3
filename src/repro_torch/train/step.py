"""The train step (port of ``repro.train.step``): loss, gradients, clipping
and the optimizer, with optional microbatch accumulation, and the
compressed data-parallel step (top-k error feedback and an int8
all-reduce).

The gradient is autograd's (``torch.autograd.grad``) through ``loss_fn``:
K6 and K7 forward and backward on the card, their plain versions on the
CPU.  The data-parallel step runs one process per replica in a
``torch.distributed`` group (gloo where the replicas share one card; its
all-reduce takes CUDA tensors, ``distributed/exchange.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.distributed import exchange
from repro_torch.distributed.sharding import data_axes
from repro_torch.models import loss_fn
from repro_torch.train.optim import (OptConfig, _zeros_f32, apply_opt,
                                     clip_by_global_norm)


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


# --------------------------------------------------------------------------
# gradient compression (data-parallel replicas): top-k error feedback and
# an int8 all-reduce
# --------------------------------------------------------------------------

def _topk_ef(gs: list, errors, frac: float):
    """``topk_ef_compress`` one leaf at a time: yields each leaf's (sparse
    gradient, new error) and drops ``gs[i]`` once it is compressed."""
    for i, e in enumerate(errors):
        g32 = gs[i].float() + e
        gs[i] = None
        mag = g32.abs()
        k = max(1, int(mag.numel() * frac))
        thresh = torch.topk(mag.reshape(-1), k, sorted=False).values.min()
        keep = mag >= thresh
        del mag
        sparse = torch.where(keep, g32, 0.0)
        yield sparse, g32.sub_(sparse)


def topk_ef_compress(grads, errors, frac: float = 0.01):
    """Per-leaf top-|g| selection with error feedback → (sparse grads, new
    errors), as the reference's.

    Per leaf: ``g32 = g + e`` in f32, ``k = max(1, int(n * frac))``, the
    threshold is the k-th largest ``|g32|`` and the mask ``|g32| >=
    threshold`` (ties included); the unselected mass is the new error.
    The threshold is the smallest of ``torch.topk(|g32|, k,
    sorted=False)``'s values: the smallest of the k largest is the k-th
    largest, the value ``lax.top_k(|g32|, k)[0][-1]`` reads, and which of
    several equal values it comes from does not change it.  Unsorted, the
    k values need no sort."""
    named, treedef = _tree.flatten_with_names(grads)
    pairs = list(_topk_ef([g for _, g in named], _tree.leaves(errors), frac))
    return (_tree.unflatten(treedef, [s for s, _ in pairs]),
            _tree.unflatten(treedef, [e for _, e in pairs]))


def quantize_int8(g: torch.Tensor):
    """One leaf → (int8 values, its f32 scale): ``scale = max|g| / 127 +
    1e-12``, values ``clamp(round(g / scale), -127, 127)`` (``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    g32 = g.float()
    scale = g32.abs().max() / 127.0 + 1e-12
    q = (g32 / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(total: torch.Tensor, scale_max: torch.Tensor, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """The replicas' int32 sum of int8 values → their mean in ``dtype``:
    ``total * scale_max / n``, in the reference's order of operations."""
    return (total.float() * scale_max / n).to(dtype)


def _mean(t: torch.Tensor, n: int, group) -> torch.Tensor:
    if n > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t / n


def _allreduce_mean(leaves, group, quantize: bool) -> list:
    """The replicas' mean over ``group`` of each leaf of ``leaves``, an
    iterable taken one leaf at a time.  Quantized: each leaf becomes int8
    values and a scale as it comes (the leaf is dropped), then the values
    are summed in int32 one leaf at a time, with the largest scale (one
    MAX all-reduce for all leaves), and dequantized; else each leaf is
    summed in place and divided."""
    n = exchange.group_size(group)
    if not quantize:
        return [_mean(g, n, group) for g in leaves]
    qs, scales, dtypes = [], [], []
    for g in leaves:
        q, scale = quantize_int8(g)
        qs.append(q)
        scales.append(scale)
        dtypes.append(g.dtype)
        del g
    scales = torch.stack(scales)
    if n > 1:
        dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    out = []
    for i, dtype in enumerate(dtypes):
        total = qs[i].to(torch.int32)
        qs[i] = None
        if n > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        out.append(dequantize_int8(total, scales[i], n, dtype))
    return out


def int8_allreduce(grads, group=None):
    """Quantize each leaf to int8 with its own scale, sum the values in
    int32 over ``group`` (the default group for None; a world of one
    when none is initialized), take the largest scale, and dequantize to
    the mean, as the reference's psum/pmax over the data axis.  The int32
    sum moves 4 B per element, as a dense f32 all-reduce does."""
    named, treedef = _tree.flatten_with_names(grads)
    if not named:
        return grads
    return _tree.unflatten(treedef, _allreduce_mean(
        (g for _, g in named), group, quantize=True))


def _data_replicas(mesh_shape: Dict[str, int]) -> int:
    w = 1
    for a in data_axes(mesh_shape):
        w *= mesh_shape.get(a, 1)
    return w


def local_batch(mesh_shape: Dict[str, int], batch, rank: int):
    """This replica's rows of the global ``batch``: piece ``rank`` of the
    data replicas' equal pieces of each leaf's leading axis, as the
    reference's ``P(dp)`` in_specs cut it; 0-d leaves stay whole.  A batch
    that does not split evenly over the replicas raises, as the
    reference's ``shard_map`` does."""
    w = _data_replicas(mesh_shape)
    named, treedef = _tree.flatten_with_names(batch)
    out = []
    for name, leaf in named:
        if leaf.dim() and leaf.shape[0] % w:
            raise ValueError(f"batch leaf {name!r} of {leaf.shape[0]} rows "
                             f"does not split over {w} data replicas")
        out.append(leaf.chunk(w)[rank] if leaf.dim() else leaf)
    return _tree.unflatten(treedef, out)


def make_compressed_dp_step(cfg, oc: OptConfig, mesh_shape: Dict[str, int],
                            *, group=None, frac: float = 0.01,
                            quantize: bool = True):
    """The reference's data-parallel step with an explicit compressed
    gradient exchange; ``mesh_shape`` as the partition rules take it
    (``{"data": W, "model": 1}``), the model axis of size 1.

    ``group``: the ``torch.distributed`` group of the W replicas, one
    process each (the default group for None); a world of one needs
    none, and in an initialized job of several ranks takes a group of
    one.  The returned ``step(params, opt_state, errors, batch)`` takes
    the *global* batch, runs this replica's rows (``local_batch``), and
    returns ``(params, opt_state, errors, loss)``: the loss and gradients
    of its rows, ``topk_ef_compress`` with its own error buffer, then
    ``int8_allreduce`` (or an all-reduce mean), the loss's mean over the
    group, clipping and ``apply_opt``.  Parameters and optimizer state are
    replicated: every replica applies the same update, in place.  Each
    replica keeps its own error buffer, which is what error feedback
    means; the reference returns replica 0's as if it were replicated
    (ROADMAP Queue 3).

    The step goes leaf by leaf through the same code as
    ``topk_ef_compress`` and ``int8_allreduce``: each gradient is
    compressed and quantized, and dropped, before the next, and the new
    errors are written into ``errors`` in place, so beside the state only
    one leaf's temporaries and the int8 values (1 B a parameter) are
    held at once."""
    if mesh_shape.get("model", 1) != 1:
        raise ValueError("the compressed data-parallel step is data-"
                         f"parallel only: model axis {mesh_shape['model']}")
    w = _data_replicas(mesh_shape)
    if exchange.group_size(group) != w:
        raise ValueError(f"{w} data replicas need a torch.distributed group "
                         f"of {w} ranks, not {exchange.group_size(group)}")
    rank = exchange.rank_of(group) or 0

    def step(params, opt_state, errors, batch):
        loss, grads = loss_and_grads(cfg, params,
                                     local_batch(mesh_shape, batch, rank))
        named, treedef = _tree.flatten_with_names(grads)
        gs = [g for _, g in named]
        del grads, named
        errs = _tree.leaves(errors)

        def sparse():
            for i, (s, e) in enumerate(_topk_ef(gs, errs, frac)):
                errs[i].copy_(e)
                del e
                yield s

        grads = _tree.unflatten(treedef, _allreduce_mean(sparse(), group,
                                                         quantize))
        loss = _mean(loss.float().clone(), w, group)
        if oc.clip_norm:
            grads, _ = clip_by_global_norm(grads, oc.clip_norm)
        params, opt_state = apply_opt(oc, params, grads, opt_state)
        return params, opt_state, errors, loss

    return step


def init_errors(params) -> Any:
    """Zero f32 error buffers shaped like ``params``, on their devices."""
    return _zeros_f32(params)
