"""Leaf-level scrutinized packing: criticality mask → (payload, aux).

Two aux encodings per leaf (the cheaper wins, recorded in the manifest):
- ``regions``: the paper's (start, stop) int64 runs;
- ``bitmap``: 1 bit/element (fragmented masks).

Beyond-paper precision tiers (the paper's §VII future work): each critical
*region* is assigned a storage dtype from the |∂out/∂x| quantiles of the
leaf's sensitivity magnitudes — high-impact regions keep the native dtype,
low-impact regions are stored in bf16/f8-like truncated floats.  Tiers apply
to leaves whose host array is a numpy float (bf16 leaves, held as uint16
bits, are stored untiered).

The device-side hot path (blocked compaction) is kernels/mask_pack; this
module is the host-side format layer, a numpy copy of the reference's so
the bytes on disk are identical.  Host arrays travel with their dtype
*name* (``_tensors``: a bf16 leaf is a uint16 array of its bits).
``pack_leaf_from_payload`` assembles the identical on-disk ``PackedLeaf``
directly from a device-gathered payload so the device save path never
re-slices the full array on host — the two paths are byte-identical.

All hot loops here are vectorized numpy: payload assembly is a single
boolean gather, per-region sensitivity is one ``np.maximum.reduceat``, and
tiered encode/decode scatter whole tiers at once.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._tensors import fill_host, host_dtype
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.regions import (mask_to_regions, regions_to_indices,
                                      regions_to_mask)

# Tiered regions are subdivided to this granularity so tier quantiles bite
# even on solid masks; tier ids index the subdivided regions.
TIER_BLOCK = 256


def _truncate_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """Keep ``bits`` mantissa bits of a float32 array (f8-like storage that
    remains a real dtype on disk)."""
    assert x.dtype == np.float32
    u = x.view(np.uint32)
    drop = 23 - bits
    u = (u >> drop) << drop
    return u.view(np.float32)


@dataclasses.dataclass
class PackedLeaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    encoding: str                      # full | regions | bitmap
    aux: bytes                         # regions int64 pairs or bitmap bits
    num_regions: int
    payload: bytes
    checksum: int
    # precision tiers: per-region dtype index into tier_dtypes
    tier_dtypes: Tuple[str, ...] = ()
    region_tiers: bytes = b""          # int8 per region

    @property
    def nbytes(self) -> int:
        return len(self.payload) + len(self.aux) + len(self.region_tiers)


def _choose_aux(mask: np.ndarray, regions: np.ndarray) -> Tuple[str, bytes]:
    """Pick the cheaper aux encoding (regions vs bitmap) for ``mask``.
    Sizes are compared analytically so only the winner is materialized."""
    region_nbytes = 16 * len(regions)
    bitmap_nbytes = (mask.size + 7) // 8
    if region_nbytes <= bitmap_nbytes:
        return "regions", regions.astype(np.int64).tobytes()
    return "bitmap", np.packbits(mask).tobytes()


def _gather_critical(flat: np.ndarray, mask: np.ndarray,
                     regions: np.ndarray) -> np.ndarray:
    """Critical elements in order.  Sparse masks expand the (already
    computed) regions to indices — cheaper than re-scanning the full mask;
    dense masks use the one-pass boolean gather."""
    count = int(regions[:, 1].sum() - regions[:, 0].sum()) if len(regions) \
        else 0
    if count * 8 < mask.size:
        return flat.take(regions_to_indices(regions))
    return flat[mask]


def _subdivide_regions(regions: np.ndarray, block: int = TIER_BLOCK) -> np.ndarray:
    """Split each [s, e) run into ≤ ``block``-long sub-runs (vectorized)."""
    lengths = regions[:, 1] - regions[:, 0]
    nsub = -(-lengths // block)                       # ceil div, per region
    total = int(nsub.sum())
    if total == len(regions):                         # nothing to split
        return regions.astype(np.int64)
    first = np.cumsum(nsub) - nsub                    # index of each run's 1st sub
    local = np.arange(total) - np.repeat(first, nsub)  # sub index within run
    starts = np.repeat(regions[:, 0], nsub) + local * block
    stops = np.minimum(starts + block, np.repeat(regions[:, 1], nsub))
    return np.stack([starts, stops], axis=1).astype(np.int64)


def _region_max(magnitude: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Per-region max |grad| in one ``reduceat`` (the sentinel keeps the
    trailing stop==n index legal)."""
    mag = np.asarray(magnitude).reshape(-1)
    padded = np.concatenate([mag, [-np.inf]])
    # ravel = [s0,e0,s1,e1,...]; even slots reduce exactly [s_i, e_i).
    return np.maximum.reduceat(padded, regions.reshape(-1))[::2]


def pack_leaf(name: str, arr: np.ndarray, mask: Optional[np.ndarray],
              magnitude: Optional[np.ndarray] = None,
              precision: Optional[PrecisionPolicy] = None,
              dtype: Optional[str] = None) -> PackedLeaf:
    """arr: host array; mask: flat bool (None = checkpoint fully);
    ``dtype``: the leaf's dtype name (default ``str(arr.dtype)``; pass
    ``"bfloat16"`` for a bf16 leaf held as uint16 bits)."""
    arr = np.asarray(arr)
    dtype = str(arr.dtype) if dtype is None else str(dtype)
    flat = arr.reshape(-1)
    tiering = (precision is not None and precision.enabled
               and magnitude is not None
               and np.issubdtype(flat.dtype, np.floating))
    if mask is None or (mask.all() and not tiering):
        payload = flat.tobytes()
        return PackedLeaf(name=name, shape=tuple(arr.shape),
                          dtype=dtype, encoding="full", aux=b"",
                          num_regions=1, payload=payload,
                          checksum=zlib.crc32(payload))

    mask = np.asarray(mask, dtype=bool).reshape(-1)   # no copy if bool
    regions = mask_to_regions(mask)

    if tiering and len(regions):
        return _pack_leaf_tiered(name, arr, flat, mask, regions,
                                 magnitude, precision, dtype)

    # Payload = critical elements in order, one vectorized gather
    # (identical bytes to concatenating per-region slices).
    payload = _gather_critical(flat, mask, regions).tobytes()
    encoding, aux = _choose_aux(mask, regions)
    return PackedLeaf(name=name, shape=tuple(arr.shape), dtype=dtype,
                      encoding=encoding, aux=aux, num_regions=len(regions),
                      payload=payload, checksum=zlib.crc32(payload))


def _pack_leaf_tiered(name: str, arr: np.ndarray, flat: np.ndarray,
                      mask: np.ndarray, regions: np.ndarray,
                      magnitude: np.ndarray,
                      precision: PrecisionPolicy, dtype: str) -> PackedLeaf:
    # tiers force the regions encoding (tier ids index these regions)
    regions = _subdivide_regions(regions)
    aux = regions.tobytes()
    sens = _region_max(magnitude, regions)
    qs = np.concatenate([[np.inf],
                         [np.quantile(sens, 1.0 - t.quantile)
                          for t in precision.tiers]])
    tier_of = np.zeros(len(regions), np.int8)
    for ti, t in enumerate(precision.tiers):
        tier_of[sens < qs[ti]] = ti
    tiers = tuple(
        "native" if t.dtype is None
        else ("bf16t" if t.mantissa_bits is not None else "bf16")
        for t in precision.tiers)

    # Per-element tier + byte width → byte offset of every critical element,
    # then each tier's elements are encoded and scattered in one shot.
    lengths = regions[:, 1] - regions[:, 0]
    vals = _gather_critical(flat, mask, regions)   # critical values, in order
    elem_tier = np.repeat(tier_of, lengths)
    itemsize = flat.dtype.itemsize
    tier_width = np.array([itemsize if t.dtype is None else 2
                           for t in precision.tiers], np.int64)
    elem_width = tier_width[elem_tier]
    offsets = np.concatenate([[0], np.cumsum(elem_width)])
    buf = np.empty(int(offsets[-1]), np.uint8)
    for ti, t in enumerate(precision.tiers):
        sel = elem_tier == ti
        if not sel.any():
            continue
        seg = vals[sel]
        if t.dtype is None:
            enc = seg
            w = itemsize
        else:
            seg32 = seg.astype(np.float32)
            if t.mantissa_bits is not None:
                seg32 = _truncate_mantissa(seg32, t.mantissa_bits)
            # bf16 on disk = upper 2 bytes of big-endian f32
            enc = (seg32.view(np.uint32) >> 16).astype(np.uint16)
            w = 2
        byte_idx = offsets[:-1][sel][:, None] + np.arange(w)[None, :]
        buf[byte_idx] = np.ascontiguousarray(enc).view(np.uint8).reshape(-1, w)
    payload = buf.tobytes()

    return PackedLeaf(name=name, shape=tuple(arr.shape), dtype=dtype,
                      encoding="regions", aux=aux, num_regions=len(regions),
                      payload=payload, checksum=zlib.crc32(payload),
                      tier_dtypes=tiers, region_tiers=tier_of.tobytes())


def pack_leaf_from_payload(name: str, shape: Tuple[int, ...], dtype: str,
                           mask: Optional[np.ndarray],
                           payload_arr: np.ndarray) -> PackedLeaf:
    """Assemble the on-disk ``PackedLeaf`` from an already-gathered payload.

    ``payload_arr`` holds the critical elements of the (flattened) leaf in
    order — exactly what ``kernels/mask_pack``'s ``pack_group`` moves over
    D2H.  The result is byte-identical to ``pack_leaf`` on the full host
    array with the same mask (no precision tiering on this path; the manager
    falls back to the host path when tiers are enabled).
    """
    payload_arr = np.asarray(payload_arr).reshape(-1)
    if mask is None or bool(np.asarray(mask).all()):
        payload = payload_arr.tobytes()
        return PackedLeaf(name=name, shape=tuple(shape), dtype=dtype,
                          encoding="full", aux=b"", num_regions=1,
                          payload=payload, checksum=zlib.crc32(payload))
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    regions = mask_to_regions(mask)
    if payload_arr.size != int(mask.sum()):
        raise ValueError(
            f"payload for leaf {name} has {payload_arr.size} elements; "
            f"mask marks {int(mask.sum())} critical")
    payload = payload_arr.tobytes()
    encoding, aux = _choose_aux(mask, regions)
    return PackedLeaf(name=name, shape=tuple(shape), dtype=dtype,
                      encoding=encoding, aux=aux, num_regions=len(regions),
                      payload=payload, checksum=zlib.crc32(payload))


def packed_leaf_stub(name: str, shape: Tuple[int, ...], dtype: str,
                     mask: Optional[np.ndarray], payload_nbytes: int,
                     regions: Optional[np.ndarray] = None) -> PackedLeaf:
    """Manifest-side ``PackedLeaf`` for a payload that streams later.

    Same encoding/aux decision as :func:`pack_leaf_from_payload`, but the
    payload bytes are *not* attached — the pipelined save engine streams
    them chunk-by-chunk to the shard writer, which computes the checksum
    incrementally and finalizes the manifest entry.  ``payload`` is empty
    and ``checksum`` 0 until then.

    ``regions`` may pass the leaf's already-computed region table (the
    criticality report caches one) to skip re-scanning the mask; it must
    equal ``mask_to_regions(mask)``.
    """
    itemsize = host_dtype(dtype).itemsize
    if mask is None:
        return PackedLeaf(name=name, shape=tuple(shape), dtype=dtype,
                          encoding="full", aux=b"", num_regions=1,
                          payload=b"", checksum=0)
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    if regions is None:
        regions = mask_to_regions(mask)
    count = int(regions[:, 1].sum() - regions[:, 0].sum()) if len(regions) \
        else 0
    if count == mask.size:
        return PackedLeaf(name=name, shape=tuple(shape), dtype=dtype,
                          encoding="full", aux=b"", num_regions=1,
                          payload=b"", checksum=0)
    if payload_nbytes != count * itemsize:
        raise ValueError(
            f"payload for leaf {name} is {payload_nbytes} bytes; mask marks "
            f"{count} critical elements of {itemsize} bytes")
    encoding, aux = _choose_aux(mask, regions)
    return PackedLeaf(name=name, shape=tuple(shape), dtype=dtype,
                      encoding=encoding, aux=aux, num_regions=len(regions),
                      payload=b"", checksum=0)


# --------------------------------------------------------------------------
# Differential (delta) leaves: byte-chunk patches against a base payload
# --------------------------------------------------------------------------

# Chunk granularity of the on-disk delta format: shared with the device
# encoder so host- and device-written delta files stay byte-identical.
from repro_torch.kernels.mask_pack.ops import DELTA_CHUNK_BYTES  # noqa: E402


@dataclasses.dataclass
class DeltaLeaf:
    """Byte-chunk patch of one leaf's payload against its predecessor in a
    delta chain.  ``idx`` indexes ``chunk_bytes``-sized chunks of the
    predecessor payload (``total_bytes`` long); the final chunk may be
    shorter.  ``payload`` is the changed chunks' bytes, concatenated."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    chunk_bytes: int
    total_bytes: int
    idx: np.ndarray                    # int32 changed chunk indices
    payload: bytes
    checksum: int                      # crc32 of the delta payload bytes

    @property
    def nbytes(self) -> int:
        return len(self.payload) + self.idx.nbytes


def delta_encode_host(curr: np.ndarray, base: np.ndarray,
                      chunk_bytes: int = DELTA_CHUNK_BYTES
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of the device ``delta_encode``: compare raw bytes per
    chunk, return (changed chunk idx int32, changed bytes uint8).  Produces
    byte-identical output to the device op for the same inputs."""
    a = np.ascontiguousarray(curr).view(np.uint8).reshape(-1)
    b = np.ascontiguousarray(base).view(np.uint8).reshape(-1)
    if a.size != b.size:
        raise ValueError(f"delta size mismatch ({a.size} vs {b.size} bytes)")
    n = a.size
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.uint8)
    pad = (-n) % chunk_bytes
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    nc = a.size // chunk_bytes
    changed = np.any(a.reshape(nc, chunk_bytes) != b.reshape(nc, chunk_bytes),
                     axis=1)
    idx = np.flatnonzero(changed).astype(np.int32)
    if idx.size == 0:
        return idx, np.zeros(0, np.uint8)
    chunks = a.reshape(nc, chunk_bytes)[idx]
    tail = n - (nc - 1) * chunk_bytes
    if int(idx[-1]) == nc - 1 and tail < chunk_bytes:
        payload = np.concatenate([chunks[:-1].reshape(-1), chunks[-1][:tail]])
    else:
        payload = chunks.reshape(-1)
    return idx, payload


def apply_delta(buf: np.ndarray, idx: np.ndarray, payload: bytes,
                chunk_bytes: int) -> None:
    """Patch changed chunks into ``buf`` (flat uint8, modified in place).

    Per-chunk slice assignment: chunks are contiguous runs, so no index
    array is materialized (the payload can be GiB-scale on dense deltas).
    """
    idx = np.asarray(idx, np.int64)
    if idx.size == 0:
        return
    starts = idx * chunk_bytes
    ends = np.minimum(starts + chunk_bytes, buf.size)
    pay = np.frombuffer(payload, np.uint8)
    if int((ends - starts).sum()) != pay.size:
        raise IOError(f"delta patch length mismatch "
                      f"({int((ends - starts).sum())} vs {pay.size})")
    off = 0
    for s, e in zip(starts, ends):
        buf[s:e] = pay[off:off + e - s]
        off += e - s


def leaf_mask(p: PackedLeaf) -> Optional[np.ndarray]:
    """Decode the flat critical mask from a packed leaf's aux encoding
    (``None`` for fully-stored leaves)."""
    if p.encoding == "full":
        return None
    n = int(np.prod(p.shape)) if p.shape else 1
    if p.encoding == "regions":
        regions = np.frombuffer(p.aux, np.int64).reshape(-1, 2)
        return regions_to_mask(regions, n)
    return np.unpackbits(np.frombuffer(p.aux, np.uint8))[:n].astype(bool)


def unpack_leaf(p: PackedLeaf, fill=0) -> np.ndarray:
    dtype = host_dtype(p.dtype)
    n = int(np.prod(p.shape)) if p.shape else 1
    if zlib.crc32(p.payload) != p.checksum:
        raise IOError(f"checksum mismatch for leaf {p.name}")
    if p.encoding == "full":
        return np.frombuffer(p.payload, dtype=dtype).reshape(p.shape)

    mask = leaf_mask(p)
    regions = (np.frombuffer(p.aux, np.int64).reshape(-1, 2)
               if p.encoding == "regions" else mask_to_regions(mask))

    out = np.full(n, fill_host(fill, p.dtype), dtype=dtype)
    if p.region_tiers:
        _unpack_tiered(p, out, mask, regions, dtype)
    else:
        out[mask] = np.frombuffer(p.payload, dtype)
    return out.reshape(p.shape)


def _unpack_tiered(p: PackedLeaf, out: np.ndarray, mask: np.ndarray,
                   regions: np.ndarray, dtype: np.dtype) -> None:
    tier_of = np.frombuffer(p.region_tiers, np.int8)
    lengths = regions[:, 1] - regions[:, 0]
    elem_tier = np.repeat(tier_of, lengths)
    tier_width = np.array([2 if t.startswith("bf16") else dtype.itemsize
                           for t in p.tier_dtypes], np.int64)
    elem_width = tier_width[elem_tier]
    offsets = np.concatenate([[0], np.cumsum(elem_width)])
    raw = np.frombuffer(p.payload, np.uint8)
    positions = np.flatnonzero(mask)               # element index per payload slot
    for ti, tname in enumerate(p.tier_dtypes):
        sel = elem_tier == ti
        if not sel.any():
            continue
        w = int(tier_width[ti])
        byte_idx = offsets[:-1][sel][:, None] + np.arange(w)[None, :]
        chunk = np.ascontiguousarray(raw[byte_idx])
        if tname.startswith("bf16"):
            u16 = chunk.view(np.uint16).reshape(-1)
            vals = (u16.astype(np.uint32) << 16).view(np.float32).astype(dtype)
        else:
            vals = chunk.view(dtype).reshape(-1)
        out[positions[sel]] = vals
