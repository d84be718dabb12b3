"""Plain PyTorch versions of the mask_pack kernels (K1-K5, K8).

Each function computes exactly what its CUDA kernel in ``kernel.py``
computes, on tensors of any device: ``ops`` uses them for tensors that lie
on the CPU, and the chip smoke test holds every kernel against them on the
card.  Like the kernels they only move values (index, select, compare
bytes) and never do arithmetic on them, so they are exact for every dtype
and for non-finite values.

Format contract (shared with the reference package): arrays are processed
in fixed ``BLOCK``-element tiles; each tile is left-compacted (critical
elements first, in order) and the per-tile critical count is returned.
K2 and K4 take the mask as ``np.packbits``-order words: their plain
versions are the bool-mask ones below after :func:`expand_mask_bits`.
"""

from __future__ import annotations

import torch

BLOCK = 512

# Elements per bitpack tile (→ block/8 output bytes per tile).
BITPACK_BLOCK = 1024

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def bitpack_ref(mag: torch.Tensor, tol, block: int = BITPACK_BLOCK):
    """K1: bit ``i`` is ``mag[i] > tol`` in ``np.packbits`` order (MSB
    first); bits past ``N`` are 0.  Returns (words ``(ceil(N/8),)`` uint8,
    per-tile counts ``(ceil(N/block),)`` int32)."""
    n = mag.shape[0]
    bits = mag > torch.as_tensor(tol, dtype=mag.dtype, device=mag.device)
    nb = -(-n // block)
    padded = torch.zeros(nb * block, dtype=torch.int32, device=mag.device)
    padded[:n] = bits.to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=mag.device)
    words = (padded.view(-1, 8) * w).sum(dim=1).to(torch.uint8)
    counts = padded.view(nb, block).sum(dim=1).to(torch.int32)
    return words[:(n + 7) // 8], counts


def expand_mask_bits(bits: torch.Tensor, *, n: int) -> torch.Tensor:
    """``np.packbits``-order uint8 words → (n,) bool mask on the words'
    device; bits past ``n`` in the last byte are dropped."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    x = (bits.reshape(-1, 1) >> shifts) & 1
    return x.reshape(-1)[:n].to(torch.bool)


def regions_words_ref(regions: torch.Tensor, n: int) -> torch.Tensor:
    """K8: a sorted, disjoint ``(R, 2)`` table of ``[start, stop)`` runs →
    the words of their mask, ``np.packbits(regions_to_mask(regions, n))``,
    (ceil(n/8),) uint8 on the table's device, bits past ``n`` 0.

    Works on bytes, never on elements: the whole bytes of every run are
    set by a running sum over the bytes (+1 at a run's first whole byte, -1
    past its last), and the partial bytes at a run's two ends are added on.
    The runs are disjoint, so their bits in a shared byte are too, and a
    sum of them is their OR."""
    nbytes = (n + 7) // 8
    dev = regions.device
    r = regions.reshape(-1, 2).to(torch.int64)
    s, e = r[:, 0], r[:, 1].clamp(max=n)
    keep = e > s
    s, e = s[keep], e[keep]
    fb, fe = (s + 7) // 8, e // 8            # whole bytes [fb, fe)
    whole = fb < fe
    delta = torch.zeros(nbytes + 1, dtype=torch.int32, device=dev)
    one = torch.ones(int(whole.sum()), dtype=torch.int32, device=dev)
    delta.index_add_(0, fb[whole], one)
    delta.index_add_(0, fe[whole], -one)
    full = torch.cumsum(delta[:nbytes], 0, dtype=torch.int32) > 0
    hb, tb = s // 8, (e - 1) // 8
    head = (1 << (8 - s % 8)) - 1            # bits from s to its byte's end
    tail = 0xFF & ~((1 << (7 - (e - 1) % 8)) - 1)   # bits up to e - 1
    one_byte = (hb == tb) & ~whole
    split = hb != tb
    at_head = split & (s % 8 != 0)
    at_tail = split & (e % 8 != 0)
    part = torch.zeros(nbytes, dtype=torch.int32, device=dev)
    part.index_add_(0, hb[one_byte], (head & tail)[one_byte].to(torch.int32))
    part.index_add_(0, hb[at_head], head[at_head].to(torch.int32))
    part.index_add_(0, tb[at_tail], tail[at_tail].to(torch.int32))
    return torch.where(full, 0xFF, part).to(torch.uint8)


def mask_to_words(mask: torch.Tensor) -> torch.Tensor:
    """(N,) bool mask → its ``np.packbits``-order words, (ceil(N/8),) uint8
    on the mask's device, tail bits 0: the inverse of
    :func:`expand_mask_bits`."""
    mask = mask.reshape(-1)
    n = mask.shape[0]
    m = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=mask.device)
    m[:n] = mask
    m = m.view(-1, 8)
    words = m[:, 0] << 7
    for j in range(1, 8):
        words |= m[:, j] << (7 - j)
    return words


def tile_counts_ref(mask: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Critical elements per ``block`` tile of a flat bool mask (int32)."""
    n = mask.shape[0]
    nb = -(-n // block)
    padded = torch.zeros(nb * block, dtype=torch.int32, device=mask.device)
    padded[:n] = mask.to(torch.int32)
    return padded.view(nb, block).sum(dim=1).to(torch.int32)


def pack_blocks_ref(flat: torch.Tensor, mask: torch.Tensor,
                    block: int = BLOCK):
    """K2, tiled form: flat (N,) values, mask (N,) bool, any N.  Returns
    (packed ``(ceil(N/block), block)`` with a zero tail per tile, counts
    ``(ceil(N/block),)`` int32)."""
    n = flat.shape[0]
    nb = -(-n // block)
    vals = torch.zeros(nb * block, dtype=flat.dtype, device=flat.device)
    vals[:n] = flat
    m = torch.zeros(nb * block, dtype=torch.bool, device=flat.device)
    m[:n] = mask
    mb = m.view(nb, block)
    pos = torch.cumsum(mb.to(torch.int32), dim=1) - 1       # slot in tile
    rows, cols = torch.nonzero(mb, as_tuple=True)
    packed = torch.zeros(nb, block, dtype=flat.dtype, device=flat.device)
    packed[rows, pos[rows, cols]] = vals.view(nb, block)[rows, cols]
    counts = mb.sum(dim=1).to(torch.int32)
    return packed, counts


def gather_payload_ref(packed: torch.Tensor, counts: torch.Tensor,
                       total: int) -> torch.Tensor:
    """Inter-tile gap removal: the per-tile critical prefixes of ``packed``
    (nb, block) as one dense (total,) payload; ``total == counts.sum()``."""
    nb, block = packed.shape
    if total == 0:
        return packed.reshape(-1)[:0]
    counts = counts.to(torch.int64)
    ends = torch.cumsum(counts, dim=0)
    starts = ends - counts
    j = torch.arange(total, device=packed.device)
    tile = torch.searchsorted(ends, j, right=True)
    slot = j - starts[tile]
    return packed.reshape(-1)[tile * block + slot]


def pack_payload_ref(flat: torch.Tensor, mask: torch.Tensor, total: int,
                     block: int = BLOCK):
    """K2, dense form (what ``pack_group`` emits per leaf): (payload of the
    ``total`` critical values in order, per-tile counts)."""
    packed, counts = pack_blocks_ref(flat, mask, block)
    return gather_payload_ref(packed, counts, total), counts


def fill_tensor(fill, dtype: torch.dtype, device) -> torch.Tensor:
    """``fill`` cast to ``dtype`` as a 0-d tensor (a cast, as
    ``jnp.asarray(fill, dtype)`` is in the reference)."""
    return torch.as_tensor(fill).to(device=device, dtype=dtype)


def mask_scatter_ref(payload: torch.Tensor, mask: torch.Tensor, fill,
                     block: int = BLOCK) -> torch.Tensor:
    """K4: dense critical ``payload`` + flat bool ``mask`` → (N,) array with
    the payload in mask order and ``fill`` elsewhere.  A critical position
    past the payload's end reads its last element (the reference's clip)."""
    n = mask.shape[0]
    total = payload.shape[0]
    out = torch.empty(n, dtype=payload.dtype, device=payload.device)
    out.fill_(fill_tensor(fill, payload.dtype, payload.device))
    if total == 0 or n == 0:
        return out
    counts = tile_counts_ref(mask, block).to(torch.int64)
    starts = torch.cumsum(counts, dim=0) - counts
    nb = counts.shape[0]
    m = torch.zeros(nb * block, dtype=torch.bool, device=mask.device)
    m[:n] = mask
    mb = m.view(nb, block)
    slot = torch.cumsum(mb.to(torch.int64), dim=1) - 1
    src = (starts[:, None] + slot).reshape(-1)[:n].clamp(0, total - 1)
    out[mask] = payload[src[mask]]
    return out


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view of ``t``'s bytes with a trailing lane axis (one
    lane, or two int64 lanes for a 16-byte element): torch's CPU gather
    rewrites bf16 NaN payloads, a gather of integers cannot."""
    if t.element_size() == 16:
        return t.view(torch.int64).view(*t.shape, 2)
    return t.view(_INT_OF_WIDTH[t.element_size()]).unsqueeze(-1)


def unpack_blocks_ref(packed: torch.Tensor, mask: torch.Tensor, fill=0.0
                      ) -> torch.Tensor:
    """K5, the inverse of the tiled K2: ``packed`` (nb, block) tiles, each
    left-compacted, and the flat bool ``mask`` (N,), N <= nb*block → (N,)
    with tile ``i``'s k-th value at its k-th critical position and
    ``fill`` (cast to the packed dtype) elsewhere.  A per-tile ``cumsum``
    gives each critical element its slot, a gather fetches it and a
    ``where`` puts the fill beside it, all on the values' bits, so -0.0,
    NaN payloads and ±inf come back as they were."""
    nb, block = packed.shape
    n = mask.shape[0]
    m = torch.zeros(nb * block, dtype=torch.bool, device=mask.device)
    m[:n] = mask
    mb = m.view(nb, block, 1)
    slot = (torch.cumsum(mb.to(torch.int32), dim=1) - 1).clamp(0, block - 1)
    bits = _bits(packed)
    vals = torch.gather(bits, 1, slot.to(torch.int64).expand(bits.shape))
    fill_bits = _bits(fill_tensor(fill, packed.dtype, packed.device)
                      .reshape(1))
    out = torch.where(mb, vals, fill_bits).reshape(nb * block,
                                                   bits.shape[-1])[:n]
    return out.contiguous().view(packed.dtype).reshape(n)


def delta_flags_ref(curr8: torch.Tensor, base8: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """K3: per ``chunk``-byte chunk, int8 1 where any byte differs.  The
    tail chunk is compared over its real bytes only."""
    n = curr8.shape[0]
    nc = -(-n // chunk)
    c = torch.zeros(nc * chunk, dtype=torch.uint8, device=curr8.device)
    b = torch.zeros(nc * chunk, dtype=torch.uint8, device=curr8.device)
    c[:n] = curr8
    b[:n] = base8
    return (c.view(nc, chunk) != b.view(nc, chunk)).any(dim=1).to(torch.int8)
