"""ctypes wrappers of the hand-written CUDA kernels in ``csrc/mask_pack.cu``.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/mask_pack-<hash>.so`` and loaded with ``ctypes``
(``kernels/_build.py``).  Nothing is built or imported at module import, so
the CPU tests import this module on a machine without ``nvcc`` or a card.

Every wrapper takes CUDA tensors only: it checks device, dtype, contiguity
and shape, allocates its outputs with ``torch.empty``/``torch.zeros``,
launches on ``torch.cuda.currentstream_of()``, raises if the launch returned
an error, and adds one to its entry in :data:`LAUNCHES`.  The plain
versions live in ``ref.py``; ``ops`` picks them only for CPU tensors.

| wrapper             | TPU kernel it replaces                        |
| ------------------- | --------------------------------------------- |
| ``bitpack``         | K1 ``kernel.py:bitpack_blocks_kernel``        |
| ``pack_into``       | K2 ``kernel.py:pack_blocks_kernel``           |
| ``delta_flags``     | K3 ``kernel.py:delta_blocks_kernel``          |
| ``mask_scatter``    | K4 ``kernel.py:scatter_blocks_kernel``        |
| ``unpack``          | K5 ``kernel.py:unpack_blocks_kernel``         |
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, stream_of

BLOCK = 512
BITPACK_BLOCK = 1024

# Launches per wrapper since the last reset_launches(): a run reads these
# to show that its main path went through the kernels.
LAUNCHES: Dict[str, int] = {"threshold_bitpack": 0, "pack": 0,
                            "delta_flags": 0, "mask_scatter": 0,
                            "unpack": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
LIBRARY = CudaLibrary("mask_pack", {
    "mp_bitpack_f32": (_P, ctypes.c_float, _I64, _P, _P, _P),
    "mp_bitpack_f64": (_P, ctypes.c_double, _I64, _P, _P, _P),
    "mp_tile_counts": (_P, _I64, _P, _P),
    "mp_pack": (_P, _P, _I64, _P, _P, _I64, ctypes.c_int, _P),
    "mp_delta_flags": (_P, _P, _I64, _I64, _P, _P),
    "mp_mask_scatter": (_P, _I64, _P, _I64, _P, ctypes.c_ulonglong,
                        ctypes.c_ulonglong, _P, ctypes.c_int, _P),
    "mp_unpack": (_P, _P, _I64, ctypes.c_ulonglong, ctypes.c_ulonglong, _P,
                  ctypes.c_int, _P),
})

# What the last build did: {"so": path, "seconds": float, "built": bool,
# "log": compiler output}.  Filled by load_library().
BUILD_INFO = LIBRARY.info


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    ``np.packbits`` order, counts ``(ceil(N/1024),)`` int32)."""
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
    LAUNCHES["threshold_bitpack"] += 1
    return words.view(torch.uint8)[:(n + 7) // 8], counts


def _tile_counts(lib, mask: torch.Tensor) -> torch.Tensor:
    n = mask.shape[0]
    counts = torch.empty(-(-n // BLOCK), dtype=torch.int32,
                         device=mask.device)
    check_launch(lib.mp_tile_counts(mask.data_ptr(), n, counts.data_ptr(),
                                    stream_of(mask)), "tile_counts")
    return counts


def _exclusive_starts(counts: torch.Tensor) -> torch.Tensor:
    c = counts.to(torch.int64)
    return torch.cumsum(c, dim=0) - c


def pack_into(flat: torch.Tensor, mask: torch.Tensor, dst: torch.Tensor,
              *, tiled: bool) -> torch.Tensor:
    """K2: write the critical values of ``flat`` (mask order) into ``dst``.

    ``tiled=False``: ``dst`` is the dense (total,) payload.  ``tiled=True``:
    ``dst`` is the zero-filled (ceil(N/512)*512,) tiled buffer, tile ``i``'s
    values at ``i*512``.  Returns the per-tile counts (int32)."""
    _require(flat, "pack")
    _require(mask, "pack", (torch.bool, torch.uint8))
    _require(dst, "pack", (flat.dtype,))
    if mask.shape[0] != flat.shape[0] or mask.device != flat.device \
            or dst.device != flat.device:
        raise ValueError("pack: flat/mask/dst disagree in length or device")
    lib = load_library()
    counts = _tile_counts(lib, mask)
    if tiled:
        starts = torch.arange(counts.shape[0], dtype=torch.int64,
                              device=flat.device) * BLOCK
    else:
        starts = _exclusive_starts(counts)
    check_launch(lib.mp_pack(flat.data_ptr(), mask.data_ptr(),
                             flat.shape[0], starts.data_ptr(),
                             dst.data_ptr(), dst.shape[0],
                             flat.element_size(), stream_of(flat)), "pack")
    LAUNCHES["pack"] += 1
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
    LAUNCHES["delta_flags"] += 1
    return flags


def _fill_words(fill: torch.Tensor):
    """The fill value's bytes as two little-endian 64-bit words."""
    raw = fill.reshape(1).cpu().view(torch.uint8).tolist()
    raw = bytes(raw) + bytes(16 - len(raw))
    return (int.from_bytes(raw[:8], "little"),
            int.from_bytes(raw[8:], "little"))


def mask_scatter(payload: torch.Tensor, mask: torch.Tensor,
                 fill: torch.Tensor) -> torch.Tensor:
    """K4: (N,) tensor with ``payload`` at the mask's critical positions (in
    order) and ``fill`` (a 0-d tensor of the payload dtype) elsewhere."""
    _require(payload, "mask_scatter")
    _require(mask, "mask_scatter", (torch.bool, torch.uint8))
    if mask.device != payload.device or payload.shape[0] == 0:
        raise ValueError("mask_scatter: needs a non-empty payload on the "
                         "mask's device")
    if fill.dtype != payload.dtype:
        raise TypeError("mask_scatter: fill dtype differs from the payload's")
    lib = load_library()
    n = mask.shape[0]
    out = torch.empty(n, dtype=payload.dtype, device=payload.device)
    starts = _exclusive_starts(_tile_counts(lib, mask))
    lo, hi = _fill_words(fill)
    check_launch(lib.mp_mask_scatter(payload.data_ptr(), payload.shape[0],
                                     mask.data_ptr(), n, starts.data_ptr(),
                                     lo, hi, out.data_ptr(),
                                     payload.element_size(),
                                     stream_of(payload)), "mask_scatter")
    LAUNCHES["mask_scatter"] += 1
    return out


def unpack(packed: torch.Tensor, mask: torch.Tensor,
           fill: torch.Tensor) -> torch.Tensor:
    """K5: the flat tiled pack ``packed`` (nb*512,) and the (N,) mask,
    N <= nb*512 → (N,) tensor with tile ``i``'s values (from
    ``packed[i*512]`` on) at its critical positions, in order, and ``fill``
    (a 0-d tensor of the packed dtype) elsewhere."""
    _require(packed, "unpack")
    _require(mask, "unpack", (torch.bool, torch.uint8))
    n = mask.shape[0]
    if mask.device != packed.device or packed.shape[0] % BLOCK \
            or packed.shape[0] < n:
        raise ValueError(f"unpack: needs whole {BLOCK}-element tiles "
                         f"covering the mask on its device, got "
                         f"{packed.shape[0]} packed for {n}")
    if fill.dtype != packed.dtype:
        raise TypeError("unpack: fill dtype differs from the packed dtype")
    lib = load_library()
    out = torch.empty(n, dtype=packed.dtype, device=packed.device)
    lo, hi = _fill_words(fill)
    check_launch(lib.mp_unpack(packed.data_ptr(), mask.data_ptr(), n, lo, hi,
                               out.data_ptr(), packed.element_size(),
                               stream_of(packed)), "unpack")
    LAUNCHES["unpack"] += 1
    return out
