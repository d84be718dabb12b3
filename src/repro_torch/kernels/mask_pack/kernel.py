"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/mask_pack.cu``.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/mask_pack-<hash>.so`` and loaded with ``ctypes``
(``kernels/_build.py``).  Nothing is built or imported at module import, so
the CPU tests import this module on a machine without ``nvcc`` or a card.

Every wrapper takes CUDA tensors only: it checks device, dtype, contiguity
and shape, allocates its outputs with ``torch.empty``/``torch.zeros``,
launches on PyTorch's current stream (``stream_of``), raises if the launch
returned an error, and adds one to its entry in :data:`LAUNCHES`.  The
plain versions live in ``ref.py``; ``ops`` picks them only for CPU tensors.

| wrapper          | TPU kernel it replaces                 | mask it reads   |
| ---------------- | -------------------------------------- | --------------- |
| ``bitpack``      | K1 ``kernel.py:bitpack_blocks_kernel`` | (writes words)  |
| ``pack_into``    | K2 ``kernel.py:pack_blocks_kernel``    | packbits words  |
| ``delta_flags``  | K3 ``kernel.py:delta_blocks_kernel``   | none            |
| ``mask_scatter`` | K4 ``kernel.py:scatter_blocks_kernel`` | packbits words  |
| ``unpack_group`` | K5 ``kernel.py:unpack_blocks_kernel``  | packbits words  |

K2, K4 and K5 take the mask as the ``np.packbits``-order words that K1
writes and a checkpoint's bitmap stores, (ceil(N/8),) uint8: 1 bit per
element read, where a bool mask costs a byte.  K5 takes a list of leaves
of any widths and rebuilds them in one launch (up to
:data:`UNPACK_GROUP_LEAVES` leaves a launch).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Dict, List, Sequence

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, stream_of

BLOCK = 512
BITPACK_BLOCK = 1024
# Leaves one K5 launch takes: the leaf table in its parameters
# (csrc/mask_pack.cu kGroupLeaves).
UNPACK_GROUP_LEAVES = 32

# Launches per wrapper since the last reset_launches(): a run reads these
# to show that its main path went through the kernels.  Several host
# threads launch at once (a coordinated save's hosts), so counts are added
# under a lock.
LAUNCHES: Dict[str, int] = {"threshold_bitpack": 0, "pack": 0,
                            "delta_flags": 0, "mask_scatter": 0,
                            "unpack": 0}
_LAUNCHES_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
LIBRARY = CudaLibrary("mask_pack", {
    "mp_bitpack_f32": (_P, ctypes.c_float, _I64, _P, _P, _P),
    "mp_bitpack_f64": (_P, ctypes.c_double, _I64, _P, _P, _P),
    "mp_word_counts": (_P, _I64, _P, _P),
    "mp_pack": (_P, _P, _I64, _P, _P, _P, _I64, _P, ctypes.c_int, _P),
    "mp_delta_flags": (_P, _P, _I64, _I64, _P, _P),
    "mp_mask_scatter": (_P, _I64, _P, _I64, _P, _P, ctypes.c_ulonglong,
                        ctypes.c_ulonglong, _P, ctypes.c_int, _P),
    "mp_unpack_group": (_P, ctypes.c_int, _P),
})

# What the last build did: {"so": path, "seconds": float, "built": bool,
# "log": compiler output}.  Filled by load_library().
BUILD_INFO = LIBRARY.info


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _require(t: torch.Tensor, what: str, dtypes=None) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        dev = getattr(t, "device", type(t).__name__)
        raise RuntimeError(f"{what}: needs a CUDA tensor, got {dev}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous 1-D tensor, got shape "
                         f"{tuple(t.shape)}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")


def bitpack(mag: torch.Tensor, tol: float):
    """K1: ``mag`` (N,) f32/f64 → (words ``(ceil(N/8),)`` uint8 in
    ``np.packbits`` order, counts ``(ceil(N/1024),)`` int32).  ``mag`` may
    be a view at any element offset: the kernel reads one that is not
    16-byte aligned with element-wide loads, so nothing is copied."""
    _require(mag, "threshold_bitpack", (torch.float32, torch.float64))
    lib = load_library()
    n = mag.shape[0]
    words = torch.empty(-(-n // 32), dtype=torch.int32, device=mag.device)
    counts = torch.empty(-(-n // BITPACK_BLOCK), dtype=torch.int32,
                         device=mag.device)
    fn = lib.mp_bitpack_f32 if mag.dtype == torch.float32 \
        else lib.mp_bitpack_f64
    check_launch(fn(mag.data_ptr(), float(tol), n, words.data_ptr(),
                    counts.data_ptr(), stream_of(mag)), "threshold_bitpack")
    _count("threshold_bitpack")
    return words.view(torch.uint8)[:(n + 7) // 8], counts


def _words(words: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """The (ceil(n/8),) uint8 words, 16-byte aligned for the kernels'
    vector loads (a fresh allocation is; a view at an odd offset is
    copied)."""
    _require(words, what, (torch.uint8,))
    if words.shape[0] != (n + 7) // 8:
        raise ValueError(f"{what}: {words.shape[0]} mask bytes for {n} "
                         f"elements, not {(n + 7) // 8}")
    return words if words.data_ptr() % 16 == 0 else words.clone()


def _counts_and_ends(lib, words: torch.Tensor, n: int):
    """K2/K4's count pass: the int32 critical count of every 512-element
    tile, and their int64 inclusive scan (a tile's values start at
    ``ends - counts``)."""
    counts = torch.empty(-(-n // BLOCK), dtype=torch.int32,
                         device=words.device)
    check_launch(lib.mp_word_counts(words.data_ptr(), n, counts.data_ptr(),
                                    stream_of(words)), "word_counts")
    return counts, torch.cumsum(counts, 0, dtype=torch.int64)


def pack_into(flat: torch.Tensor, words: torch.Tensor, dst: torch.Tensor,
              *, tiled: bool) -> torch.Tensor:
    """K2: write the critical values of ``flat`` (mask order) into ``dst``;
    ``words`` is the mask in ``np.packbits`` order, (ceil(N/8),) uint8.

    ``tiled=False``: ``dst`` is the dense (total,) payload (a count pass,
    its scan, then the move).  ``tiled=True``: ``dst`` is the zero-filled
    (ceil(N/512)*512,) tiled buffer, tile ``i``'s values at ``i*512`` (the
    move alone).  Returns the per-tile counts (int32)."""
    _require(flat, "pack")
    _require(dst, "pack", (flat.dtype,))
    n = flat.shape[0]
    words = _words(words, n, "pack")
    if words.device != flat.device or dst.device != flat.device:
        raise ValueError("pack: flat/words/dst on different devices")
    lib = load_library()
    if tiled:
        counts = torch.empty(-(-n // BLOCK), dtype=torch.int32,
                             device=flat.device)
        ends = None
    else:
        counts, ends = _counts_and_ends(lib, words, n)
    if n:
        check_launch(lib.mp_pack(
            flat.data_ptr(), words.data_ptr(), n,
            None if tiled else counts.data_ptr(),
            None if tiled else ends.data_ptr(), dst.data_ptr(),
            dst.shape[0], counts.data_ptr() if tiled else None,
            flat.element_size(), stream_of(flat)), "pack")
        _count("pack")
    return counts


def delta_flags(curr8: torch.Tensor, base8: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """K3: int8 flag per ``chunk``-byte chunk, 1 where any byte differs."""
    _require(curr8, "delta_flags", (torch.uint8,))
    _require(base8, "delta_flags", (torch.uint8,))
    if curr8.shape != base8.shape or curr8.device != base8.device:
        raise ValueError("delta_flags: curr/base differ in size or device")
    lib = load_library()
    n = curr8.shape[0]
    flags = torch.empty(-(-n // chunk), dtype=torch.int8, device=curr8.device)
    check_launch(lib.mp_delta_flags(curr8.data_ptr(), base8.data_ptr(), n,
                                    int(chunk), flags.data_ptr(),
                                    stream_of(curr8)), "delta_flags")
    _count("delta_flags")
    return flags


def _fill_words(fill: torch.Tensor):
    """The fill value's bytes as two little-endian 64-bit words."""
    raw = fill.reshape(1).cpu().view(torch.uint8).tolist()
    raw = bytes(raw) + bytes(16 - len(raw))
    return (int.from_bytes(raw[:8], "little"),
            int.from_bytes(raw[8:], "little"))


def mask_scatter(payload: torch.Tensor, words: torch.Tensor, n: int,
                 fill: torch.Tensor) -> torch.Tensor:
    """K4: (n,) tensor with ``payload`` at the mask's critical positions (in
    order) and ``fill`` (a 0-d tensor of the payload dtype) elsewhere;
    ``words`` is the mask in ``np.packbits`` order, (ceil(n/8),) uint8."""
    _require(payload, "mask_scatter")
    words = _words(words, n, "mask_scatter")
    if words.device != payload.device or payload.shape[0] == 0:
        raise ValueError("mask_scatter: needs a non-empty payload on the "
                         "words' device")
    if fill.dtype != payload.dtype:
        raise TypeError("mask_scatter: fill dtype differs from the payload's")
    out = torch.empty(n, dtype=payload.dtype, device=payload.device)
    if n == 0:
        return out
    lib = load_library()
    counts, ends = _counts_and_ends(lib, words, n)
    lo, hi = _fill_words(fill)
    check_launch(lib.mp_mask_scatter(payload.data_ptr(), payload.shape[0],
                                     words.data_ptr(), n, counts.data_ptr(),
                                     ends.data_ptr(), lo, hi, out.data_ptr(),
                                     payload.element_size(),
                                     stream_of(payload)), "mask_scatter")
    _count("mask_scatter")
    return out


# One leaf of a K5 launch as csrc/mask_pack.cu's ``UnpackArg`` lays it out:
# packed, words and out pointers, n, the fill's 16 bytes, the width.
_UNPACK_ARG = struct.Struct("<QQQq16si4x")


def _fill_bytes(fill, dtype: torch.dtype) -> bytes:
    """``fill`` cast to ``dtype`` (``torch.as_tensor(fill).to(dtype)``, as
    ``ref.fill_tensor``) as 16 little-endian bytes, zero-padded.  A Python
    number's cast is cached under its type and bits (so -0.0 is not 0.0):
    the restart asks for the same few fills leaf after leaf, and a cast
    costs more host time than a leaf (``scripts/kernel_timing.py`` times
    both on the card's host)."""
    kind = type(fill)
    if kind is float:
        return _cast_fill(dtype, kind, struct.pack("<d", fill), fill)
    if kind is complex:
        return _cast_fill(dtype, kind,
                          struct.pack("<dd", fill.real, fill.imag), fill)
    if kind in (bool, int):
        return _cast_fill(dtype, kind, fill, fill)
    return _cast_fill.__wrapped__(dtype, kind, None, fill)


@functools.lru_cache(maxsize=64)
def _cast_fill(dtype: torch.dtype, kind: type, bits, fill) -> bytes:
    lo, hi = _fill_words(torch.as_tensor(fill).to(dtype))
    return struct.pack("<QQ", lo, hi)


def unpack_group(packs: Sequence[torch.Tensor],
                 words: Sequence[torch.Tensor], ns: Sequence[int],
                 fill=0) -> List[torch.Tensor]:
    """K5 over a list of leaves: for each, its tiled pack, contiguous, of
    nb*512 elements (any shape), its mask's ``np.packbits`` words
    (ceil(n/8),) uint8 and n <= nb*512 → the (n,) tensor with tile ``i``'s
    values (from element ``i*512`` of the pack on) at its critical
    positions, in order, and ``fill`` (cast to the leaf's dtype) elsewhere.
    The leaves may have any dtypes; one launch rebuilds up to
    :data:`UNPACK_GROUP_LEAVES` of them (leaves with n = 0 take none), so a
    longer list takes several."""
    if not (len(packs) == len(words) == len(ns)):
        raise ValueError("unpack: packs/words/ns length mismatch")
    outs, rows = [], []
    dev = None
    for p, w, n in zip(packs, words, ns):
        if not (isinstance(p, torch.Tensor) and isinstance(w, torch.Tensor)
                and p.is_cuda and w.is_cuda):
            where = [getattr(t, "device", type(t).__name__) for t in (p, w)]
            raise RuntimeError(f"unpack: needs a CUDA tensor, got {where}")
        if dev is None:
            dev, index = p.device, p.get_device()
        if p.get_device() != index or w.get_device() != index:
            raise ValueError("unpack: the leaves lie on different cards")
        if not (p.is_contiguous() and w.is_contiguous()) \
                or w.dtype != torch.uint8 or w.dim() != 1:
            raise ValueError("unpack: needs contiguous packs and 1-D uint8 "
                             "words")
        if w.shape[0] != (n + 7) // 8:
            raise ValueError(f"unpack: {w.shape[0]} mask bytes for {n} "
                             f"elements, not {(n + 7) // 8}")
        size = p.numel()
        if size % BLOCK or size < n:
            raise ValueError(f"unpack: needs whole {BLOCK}-element tiles "
                             f"covering the mask, got {size} packed for {n}")
        out = torch.empty(n, dtype=p.dtype, device=dev)
        outs.append(out)
        if n:
            rows.append(_UNPACK_ARG.pack(
                p.data_ptr(), w.data_ptr(), out.data_ptr(), n,
                _fill_bytes(fill, p.dtype), p.element_size()))
    if rows:
        lib = load_library()
        stream = stream_of(packs[0])
        for lo in range(0, len(rows), UNPACK_GROUP_LEAVES):
            part = rows[lo:lo + UNPACK_GROUP_LEAVES]
            check_launch(lib.mp_unpack_group(b"".join(part), len(part),
                                             stream), "unpack")
            _count("unpack")
    return outs
