"""Public mask_pack ops: shapes, padding and dispatch around the kernels.

Device-resident checkpoint path (the save hot path):

    payload, counts = pack_group(flats, words, totals)   # K2, one payload
    payload_h = fetch(payload)                          # D2H: critical bytes

K2 (``pack``, ``pack_group``), K4 (``mask_scatter``)
and K5 (``unpack``, ``unpack_group``) take the mask as
``np.packbits``-order words, (ceil(N/8),) uint8: what K1 writes, what the
scrutiny report keeps on the device and what a checkpoint's bitmap
stores.  Nothing widens them to a byte mask on the card;
``mask_to_words`` packs a bool mask for callers that hold one, and
``segment_words`` cuts the words of a flat element range out of a leaf's
(a coordinated save packs each host's owned segment of a leaf).

``unpack_group`` (K5) is the inverse of the tiled ``pack`` (K2): the
restart of the NPB programs rebuilds all of a program's leaves from their
critical-only tiles and their masks' words in one launch; ``unpack`` is
its one-leaf case.

The restore direction mirrors the save: ``mask_scatter`` (K4) moves only
the critical payload and the mask's words H2D and re-expands the payload
with ``fill`` at uncritical positions.  ``delta_encode`` (K3) compares
the current and base payloads as raw bytes per chunk on device and moves
only changed chunks D2H.
``threshold_bitpack`` (K1) turns scrutiny magnitudes into bit-packed
masks on device.

Dispatch rule: a tensor on the card goes to its CUDA kernel (``kernel``)
or the call raises; a tensor on the CPU goes to the plain version
(``ref``).  There is no fallback between the two.  The kernels move bytes,
so every dtype is served by its width (no dtype is routed elsewhere, as
the reference did for int and f64 leaves).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels.mask_pack import kernel as K
from repro_torch.kernels.mask_pack import ref
from repro_torch.kernels.mask_pack.ref import (BITPACK_BLOCK, BLOCK,
                                               expand_mask_bits,
                                               mask_to_words)

__all__ = ["DELTA_CHUNK_BYTES", "as_bytes", "delta_encode",
           "expand_mask_bits", "mask_scatter", "mask_to_words", "pack",
           "pack_group", "segment_words", "threshold_bitpack", "unpack",
           "unpack_group"]

# Chunk granularity of the delta format, in bytes — a multiple of every
# leaf itemsize so chunks never split an element.  The host encoder
# (checkpoint/packing) imports it from here, so host- and device-written
# delta files stay byte-identical.
DELTA_CHUNK_BYTES = 2048


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix."""
    if all(t.is_cuda for t in tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    raise RuntimeError(f"mask_pack: tensors on {sorted(kinds)}; the ops "
                       "take CUDA tensors (kernels) or CPU tensors (plain "
                       "versions), not a mix")


def _check_block(block: int, expected: int, on_card: bool) -> None:
    if on_card and block != expected:
        raise ValueError(f"the CUDA kernel tiles by {expected}, not {block}")


def _check_words(words: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if words.dim() != 1:
        words = words.reshape(-1)
    if words.dtype != torch.uint8 or words.shape[0] != (n + 7) // 8:
        raise ValueError(f"{what}: the mask goes in as np.packbits words, "
                         f"({(n + 7) // 8},) uint8 for {n} elements, not "
                         f"{tuple(words.shape)} {words.dtype}")
    return words


def pack(flat: torch.Tensor, words: torch.Tensor, *, block: int = BLOCK):
    """K2, tiled form.  flat: (N,) any dtype; words: the mask,
    ``np.packbits`` order, (ceil(N/8),) uint8.  Returns (packed
    ``(ceil(N/block), block)`` with a zero tail per tile, counts
    ``(ceil(N/block),)`` int32)."""
    flat = flat.reshape(-1)
    card = _on_card(flat, words)
    words = _check_words(words, flat.shape[0], "pack")
    _check_block(block, BLOCK, card)
    if not card:
        return ref.pack_blocks_ref(
            flat, ref.expand_mask_bits(words, n=flat.shape[0]), block)
    nb = -(-flat.shape[0] // block)
    packed = torch.zeros(nb * block, dtype=flat.dtype, device=flat.device)
    counts = K.pack_into(flat.contiguous(), words.contiguous(), packed,
                         tiled=True)
    return packed.view(nb, block), counts


def unpack_group(packs: Sequence[torch.Tensor],
                 words: Sequence[torch.Tensor], ns: Sequence[int], *,
                 block: int = BLOCK, fill=0) -> List[torch.Tensor]:
    """K5, the inverse of :func:`pack` for a list of leaves: each leaf's
    packed ``(nb, block)`` tiles and its mask's ``np.packbits`` words,
    (ceil(n/8),) uint8 → a list of flat (n,) tensors with ``fill`` (cast
    to each leaf's dtype) at uncritical positions.  On the card one launch
    rebuilds the whole list, whatever the leaves' dtypes.  The restart of
    the paper's §IV-C (``npb.common.verify_restart``) rebuilds each
    program's leaves this way."""
    ns = [int(n) for n in ns]
    if not (len(packs) == len(words) == len(ns)):
        raise ValueError("unpack_group: packs/words/ns length mismatch")
    if not packs:
        return []
    for p, n in zip(packs, ns):
        if p.dim() != 2 or p.shape[1] != block or p.shape[0] * block < n:
            raise ValueError(f"unpack: packed {tuple(p.shape)} does not "
                             f"hold {n} elements in tiles of {block}")
    card = _on_card(*packs, *words)
    words = [_check_words(w, n, "unpack") for w, n in zip(words, ns)]
    _check_block(block, BLOCK, card)
    if not card:
        return [ref.unpack_blocks_ref(p, ref.expand_mask_bits(w, n=n),
                                      ref.fill_tensor(fill, p.dtype, "cpu"))
                for p, w, n in zip(packs, words, ns)]
    return K.unpack_group([p.contiguous() for p in packs],
                          [w.contiguous() for w in words], ns, fill)


def unpack(packed: torch.Tensor, words: torch.Tensor, *, n: int,
           block: int = BLOCK, fill=0.0) -> torch.Tensor:
    """K5 for one leaf (:func:`unpack_group`'s one-leaf case): packed
    ``(nb, block)`` tiles + the mask's ``np.packbits`` words → (n,) tensor
    with ``fill`` (cast to the packed dtype) at uncritical positions."""
    return unpack_group([packed], [words], [n], block=block, fill=fill)[0]


def pack_group(flats: Sequence[torch.Tensor], words: Sequence[torch.Tensor],
               totals: Sequence[int], *, block: int = BLOCK):
    """Batched pack for the pipelined save engine: compacts every leaf of a
    same-dtype group into **one** dense payload (leaf order — slice with
    running ``totals`` offsets) plus the concatenated per-tile counts.

    ``words`` are the leaves' masks as ``np.packbits`` words (the
    scrutiny report's resident words); ``totals`` are the per-leaf
    critical counts from the report, so the payload is sized without any
    counts D2H.  On the card each leaf is K2's count pass, its scan and
    K2's move, writing straight into the leaf's slice of the payload."""
    totals = tuple(int(t) for t in totals)
    if len(flats) != len(words) or len(flats) != len(totals):
        raise ValueError("pack_group: flats/words/totals length mismatch")
    if not flats:
        return (torch.zeros(0, dtype=torch.float32),
                torch.zeros(0, dtype=torch.int32))
    dtype, device = flats[0].dtype, flats[0].device
    payload = torch.empty(sum(totals), dtype=dtype, device=device)
    counts, lo = [], 0
    for f, w, t in zip(flats, words, totals):
        f = f.reshape(-1)
        if f.dtype != dtype:
            raise TypeError("pack_group: leaves of one group share a dtype")
        card = _on_card(f, w, payload)
        w = _check_words(w, f.shape[0], "pack_group")
        _check_block(block, BLOCK, card)
        dst = payload[lo:lo + t]
        if t == 0:
            # no critical element: zero counts, no K2
            counts.append(torch.zeros(-(-f.shape[0] // block),
                                      dtype=torch.int32, device=device))
        elif card:
            counts.append(K.pack_into(f.contiguous(), w.contiguous(), dst,
                                      tiled=False))
        else:
            p, c = ref.pack_payload_ref(
                f, ref.expand_mask_bits(w, n=f.shape[0]), t, block)
            dst.copy_(p)
            counts.append(c)
        lo += t
    return payload, torch.cat(counts)


def mask_scatter(payload: torch.Tensor, words: torch.Tensor, *, n: int,
                 block: int = BLOCK, fill=0.0) -> torch.Tensor:
    """K4, the device restore expand: dense critical ``payload`` + the
    mask's ``np.packbits`` words, (ceil(n/8),) uint8 → (n,) tensor with
    ``fill`` (cast to the payload dtype) at uncritical positions.  The
    tile starts are counted from the words on the payload's device, so
    the only H2D inputs are the payload and 1 bit per element."""
    payload = payload.reshape(-1)
    # the fill stays on the host: the kernel takes its bytes by value, and
    # reading them from the card would wait for the stream
    fill_t = ref.fill_tensor(fill, payload.dtype, "cpu")
    if payload.shape[0] == 0:
        # no critical element: the fill, without reading the words (the
        # restore of such a leaf sends none)
        return torch.empty(n, dtype=payload.dtype,
                           device=payload.device).fill_(fill_t)
    card = _on_card(payload, words)
    words = _check_words(words, n, "mask_scatter")
    _check_block(block, BLOCK, card)
    if not card:
        return ref.mask_scatter_ref(
            payload, ref.expand_mask_bits(words, n=n), fill_t, block)
    return K.mask_scatter(payload.contiguous(), words.contiguous(), n,
                          fill_t)


def threshold_bitpack(mag: torch.Tensor, tol=0.0, *,
                      block: int = BITPACK_BLOCK):
    """K1, the scrutiny output: bit ``i`` is ``mag[i] > tol`` in
    ``np.packbits`` order, so the words are directly ``BitMask`` words,
    bitmap aux and ``expand_mask_bits`` input; tail bits are 0.

    Returns ``(words, counts)``: words ``(ceil(N/8),)`` uint8 and per-tile
    int32 critical counts ``(ceil(N/block),)``.  The kernel takes the f32
    and f64 accumulators of the scrutiny sweep."""
    mag = mag.reshape(-1)
    card = _on_card(mag)
    _check_block(block, BITPACK_BLOCK, card)
    if not card:
        return ref.bitpack_ref(mag, tol, block)
    return K.bitpack(mag.contiguous(), tol)


# --------------------------------------------------------------------------
# Differential (delta) encode: byte-chunk diff on device
# --------------------------------------------------------------------------

def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor (no copy for contiguous tensors).
    Raises TypeError for complex leaves, as the reference's bitcast does —
    callers then write a full entry, which keeps the files identical."""
    if t.is_complex():
        raise TypeError("as_bytes: complex leaves are not byte-diffed")
    t = t.reshape(-1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def _delta_flags(curr8: torch.Tensor, base8: torch.Tensor, chunk: int):
    if _on_card(curr8, base8):
        return K.delta_flags(curr8.contiguous(), base8.contiguous(), chunk)
    return ref.delta_flags_ref(curr8, base8, chunk)


def delta_encode(curr: torch.Tensor, base: torch.Tensor, *,
                 chunk_bytes: int = DELTA_CHUNK_BYTES):
    """Differential encode of ``curr`` against ``base`` (same byte size,
    any dtype), comparing raw bytes per ``chunk_bytes`` chunk on their
    device (K3 on the card).

    Returns ``(idx, payload, d2h_bytes)``: the int32 indices of changed
    chunks, the changed chunks' bytes (final chunk clipped to the true
    length) as a host uint8 array, and what crossed device→host (1 B of
    flag per chunk + the changed bytes)."""
    c8 = as_bytes(curr)
    b8 = as_bytes(base)
    total = c8.shape[0]
    if b8.shape[0] != total:
        raise ValueError(
            f"delta_encode: size mismatch ({total} vs {b8.shape[0]} bytes)")
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.uint8), 0
    flags_h = _delta_flags(c8, b8, chunk_bytes).cpu().numpy()
    d2h = flags_h.nbytes
    idx = np.flatnonzero(flags_h).astype(np.int32)
    if idx.size == 0:
        return idx, np.zeros(0, np.uint8), d2h
    nfull = total // chunk_bytes
    full = idx[idx < nfull]
    parts = []
    if full.size:
        sel = torch.from_numpy(full.astype(np.int64)).to(c8.device)
        parts.append(c8[:nfull * chunk_bytes].view(nfull, chunk_bytes)[sel]
                     .reshape(-1))
    if int(idx[-1]) >= nfull:                # the clipped tail chunk
        parts.append(c8[nfull * chunk_bytes:])
    payload = torch.cat(parts).cpu().numpy()
    return idx, payload, d2h + payload.nbytes


def segment_words(words: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The ``np.packbits`` words of elements ``[start, stop)`` of a mask
    given as ``words``, on the words' device: a view of the words when
    ``start`` is on a byte, else the bits shifted left by ``start % 8``
    across each byte pair (tail bits past ``stop`` as they fall; K2 and
    K4 ignore them).  Plain byte arithmetic, 1 bit per element read."""
    words = words.reshape(-1)
    n = int(stop) - int(start)
    nw = -(-n // 8)
    lo, s = divmod(int(start), 8)
    if s == 0:
        return words[lo:lo + nw]
    src = words[lo:lo + nw + 1].to(torch.int16)
    if src.shape[0] < nw + 1:       # the range ends in the last byte
        src = torch.cat([src, src.new_zeros(nw + 1 - src.shape[0])])
    return (((src[:nw] << s) | (src[1:] >> (8 - s))) & 0xFF).to(torch.uint8)
