"""Scrutinized pack and scatter of one leaf (single-device subset of
``repro.distributed.sharding``).

The reference packs a leaf that is sharded along its leading axis shard by
shard on each shard's device.  This package runs on one device, so every
leaf is one flat segment: ``leaf_segments`` is always ``None`` and the
functions below pack or scatter the whole leaf; their names and returns
match the reference so the manager reads the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._tensors import from_host
from repro_torch.kernels.mask_pack import ops as mask_ops
from repro_torch.kernels.mask_pack.ref import BLOCK


def leaf_segments(leaf) -> Optional[list]:
    """Leading-axis shard tiling of a multi-device leaf; a tensor lives on
    one device, so there is none."""
    del leaf
    return None


def _flat_words(mask, device) -> torch.Tensor:
    """A bool mask (tensor or host array) as ``np.packbits`` words on
    ``device``, the form K2 reads; a host mask is packed before it moves."""
    if isinstance(mask, torch.Tensor):
        return mask_ops.mask_to_words(mask.reshape(-1).to(device))
    return torch.from_numpy(np.packbits(np.asarray(mask, dtype=bool)
                                        .reshape(-1))).to(device)


def pack_sharded_payload(leaf: torch.Tensor, mask, *, block: int = BLOCK):
    """Pack ``leaf``'s critical elements, moving only packed bytes
    device→host.  Returns ``(payload, counts, d2h_bytes)`` with ``payload``
    a host array in flat (C) order (bf16 as uint16 bits)."""
    return mask_ops.pack_critical(leaf.reshape(-1),
                                  _flat_words(mask, leaf.device), block=block)


def pack_sharded_payload_device(leaf: torch.Tensor, mask, *,
                                block: int = BLOCK):
    """Device-resident variant for the differential save path: the payload
    stays on the leaf's device as the delta base; only the per-tile counts
    cross D2H.  Returns ``(payload_dev, counts_h, d2h_bytes)``."""
    packed, counts = mask_ops.pack(leaf.reshape(-1),
                                   _flat_words(mask, leaf.device), block=block)
    counts_h = counts.cpu().numpy()                  # D2H: 4 B / tile
    total = int(counts_h.sum())
    payload = mask_ops.gather_payload(packed, counts, total=total)
    return payload, counts_h, counts_h.nbytes


def scatter_sharded_payload(payload: np.ndarray, mask: np.ndarray, shape,
                            dtype: str, device, *, fill=0,
                            block: int = BLOCK):
    """Restore inverse of :func:`pack_sharded_payload`: move only the
    critical ``payload`` (host array of dtype ``dtype``) and the mask's
    ``np.packbits`` words H2D and scatter the payload under the words into
    a fill-initialized tensor on ``device`` (K4 reads the words as they
    are).  A leaf with no critical element moves no words and runs no K4.
    Returns ``(tensor, h2d_bytes)``."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    payload = np.asarray(payload).reshape(-1)
    bits = (np.packbits(np.asarray(mask, bool).reshape(-1)) if payload.size
            else np.zeros(0, np.uint8))
    out = mask_ops.mask_scatter(from_host(payload, dtype, device),
                                torch.from_numpy(bits).to(device), n=n,
                                fill=fill, block=block)
    return out.reshape(shape), payload.nbytes + bits.nbytes
