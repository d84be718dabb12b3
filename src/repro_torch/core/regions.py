"""Run-length region encoding of criticality masks (paper §III-B).

The paper's homemade checkpoint library stores "the start and end locations of
the region of continuous critical elements" in an auxiliary file.  This module
is that auxiliary-file format, generalized:

- ``mask_to_regions``: flat bool mask → int64 ``(R, 2)`` array of half-open
  ``[start, stop)`` runs of critical elements.
- ``regions_to_mask``: inverse.
- ``RegionTable``: regions + element count + dtype, with the storage
  accounting used for Table III (critical payload bytes + aux bytes).

Everything here is plain numpy — region tables are host-side checkpoint
metadata, never traced.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Bytes per (start, stop) pair in the auxiliary file, matching the paper's
# "start and end locations" encoding at int64.
_AUX_BYTES_PER_REGION = 16


def mask_to_regions(mask: np.ndarray) -> np.ndarray:
    """Flat bool mask → (R, 2) int64 half-open [start, stop) critical runs."""
    mask = np.ascontiguousarray(np.asarray(mask).reshape(-1), dtype=bool)
    n = mask.size
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    # Interior run edges in one pass (no padded copy of the whole mask):
    # an edge sits wherever consecutive elements differ.
    edges = np.flatnonzero(mask[1:] != mask[:-1]) + 1
    if mask[0]:
        edges = np.concatenate([[0], edges])
    if mask[n - 1]:
        edges = np.concatenate([edges, [n]])
    return edges.reshape(-1, 2).astype(np.int64)


def regions_to_indices(regions: np.ndarray) -> np.ndarray:
    """(R, 2) runs → int64 indices of every covered element, in order.

    Vectorized run expansion (repeat + cumsum) — the packing hot path uses
    this to gather sparse payloads without re-scanning the full mask.
    """
    regions = np.asarray(regions, dtype=np.int64).reshape(-1, 2)
    lens = regions[:, 1] - regions[:, 0]
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    first = np.cumsum(lens) - lens              # payload slot of each run
    local = np.arange(total) - np.repeat(first, lens)
    return np.repeat(regions[:, 0], lens) + local


def regions_to_mask(regions: np.ndarray, size: int) -> np.ndarray:
    """(R, 2) runs → flat bool mask of length ``size``."""
    regions = np.asarray(regions, dtype=np.int64).reshape(-1, 2)
    if len(regions) == 0:
        return np.zeros(size, dtype=bool)
    # +1 at starts / -1 at stops, then a running sum marks interior elements.
    delta = np.zeros(size + 1, dtype=np.int32)
    np.add.at(delta, regions[:, 0], 1)
    np.add.at(delta, regions[:, 1], -1)
    return np.cumsum(delta[:size]) > 0


def pack_with_regions(flat: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Gather critical elements into one contiguous payload buffer.

    Host-side reference; the device hot path is kernels/mask_pack.
    O(covered elements), not O(array size).
    """
    flat = np.asarray(flat).reshape(-1)
    if len(regions) == 0:
        return flat[:0]
    return flat.take(regions_to_indices(regions))


def unpack_with_regions(
    payload: np.ndarray, regions: np.ndarray, size: int, fill=0
) -> np.ndarray:
    """Scatter a packed payload back into a flat buffer.

    Uncritical positions get ``fill`` — the paper's restart protocol
    tolerates *any* value there (validated by corruption tests).
    """
    out = np.full(size, fill, dtype=payload.dtype)
    mask = regions_to_mask(regions, size)
    out[mask] = payload[: int(mask.sum())]
    return out


@dataclasses.dataclass(frozen=True)
class RegionTable:
    """Criticality regions for one flat array + storage accounting."""

    regions: np.ndarray  # (R, 2) int64
    size: int  # total element count
    itemsize: int  # bytes per element

    @classmethod
    def from_mask(cls, mask: np.ndarray, itemsize: int) -> "RegionTable":
        mask = np.asarray(mask).reshape(-1)
        return cls(regions=mask_to_regions(mask), size=int(mask.size), itemsize=int(itemsize))

    @classmethod
    def from_words(cls, words: np.ndarray, n: int, itemsize: int
                   ) -> "RegionTable":
        """Region table from bit-packed mask words (np.packbits order) —
        the lazy host-materialization path of a device scrutiny report."""
        mask = np.unpackbits(np.asarray(words, np.uint8), count=n
                             ).astype(bool) if n else np.zeros(0, bool)
        return cls.from_mask(mask, itemsize)

    @property
    def num_regions(self) -> int:
        return int(len(self.regions))

    @property
    def critical_count(self) -> int:
        if self.num_regions == 0:
            return 0
        return int((self.regions[:, 1] - self.regions[:, 0]).sum())

    @property
    def uncritical_count(self) -> int:
        return self.size - self.critical_count

    @property
    def uncritical_rate(self) -> float:
        return self.uncritical_count / self.size if self.size else 0.0

    # --- storage model (Table III) -------------------------------------
    @property
    def full_bytes(self) -> int:
        return self.size * self.itemsize

    @property
    def payload_bytes(self) -> int:
        """Critical-elements-only bytes — the paper's Table III accounting
        (their auxiliary file is not charged against the saving)."""
        return self.critical_count * self.itemsize

    @property
    def region_aux_bytes(self) -> int:
        """Aux bytes under (start, stop) int64 run encoding (paper §III-B)."""
        return self.num_regions * _AUX_BYTES_PER_REGION

    @property
    def bitmap_aux_bytes(self) -> int:
        """Aux bytes under a 1-bit-per-element bitmap encoding."""
        return (self.size + 7) // 8

    @property
    def aux_encoding(self) -> str:
        """The cheaper of the two aux encodings (the checkpoint writer picks
        per-leaf; fragmented masks favour the bitmap)."""
        return "regions" if self.region_aux_bytes <= self.bitmap_aux_bytes else "bitmap"

    @property
    def aux_bytes(self) -> int:
        return min(self.region_aux_bytes, self.bitmap_aux_bytes)

    @property
    def optimized_bytes(self) -> int:
        """Engineering accounting: payload + the (cheaper) aux structure."""
        return self.payload_bytes + self.aux_bytes

    @property
    def storage_saved(self) -> float:
        if self.full_bytes == 0:
            return 0.0
        return 1.0 - self.optimized_bytes / self.full_bytes

    def to_mask(self) -> np.ndarray:
        return regions_to_mask(self.regions, self.size)

    def validate(self) -> None:
        r = self.regions
        assert r.ndim == 2 and r.shape[1] == 2, r.shape
        if len(r):
            assert (r[:, 0] < r[:, 1]).all(), "empty/inverted region"
            assert (r[1:, 0] > r[:-1, 1] - 1).all(), "unsorted/overlapping regions"
            assert r[0, 0] >= 0 and r[-1, 1] <= self.size, "region out of bounds"
