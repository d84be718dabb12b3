"""Point-to-point ops of the pipeline over a ``torch.distributed`` group,
and the group's size and rank as the data-parallel step and the pipeline
read them.

The card's machine has one GPU, so the ranks of a job on it share the card
and the group is gloo: NCCL refuses two ranks on one device.  Gloo's
all-reduce and broadcast take CUDA tensors (they stage them themselves;
on the H100: int32 SUM, f32 SUM and MAX, an f32 broadcast), so callers
pass those to ``torch.distributed`` as they are.  Its send and recv take
CPU tensors only (a CUDA tensor fails in the transport's ``writev``), so
a CUDA tensor sent or received over a gloo group goes through a pinned
host buffer here: one D2H copy, the op on the host buffer, one H2D copy.
The route is chosen by the group's backend and the tensor's device alone;
nothing catches a failure to try another.  Over a NCCL group (one rank a
card) the tensor goes as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    """Ranks of ``group`` (the default group for None); 1 when no group
    is initialized, a world of one that exchanges nothing."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank_of(group=None) -> Optional[int]:
    """This process's rank within ``group``; None with no group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, dst: int, tag: int = 0, group=None) -> None:
    """Blocking send of ``t`` to global rank ``dst``."""
    if _staged(t, group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    dist.send(t.contiguous(), dst=dst, group=group, tag=tag)


def recv(shape, dtype: torch.dtype, device, src: int, tag: int = 0,
         group=None) -> torch.Tensor:
    """Blocking receive of a ``shape``/``dtype`` tensor from global rank
    ``src``, returned on ``device``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if not _staged(out, group):
        dist.recv(out, src=src, group=group, tag=tag)
        return out
    host = torch.empty(shape, dtype=dtype, pin_memory=True)
    dist.recv(host, src=src, group=group, tag=tag)
    return out.copy_(host)
