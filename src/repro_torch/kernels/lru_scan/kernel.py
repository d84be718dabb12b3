"""ctypes wrapper of K7, the hand-written CUDA kernels in
``csrc/lru_scan.cu`` (forward and backward).

They replace ``repro/kernels/lru_scan/kernel.py:lru_scan_kernel``, which
has no backward: the reference trains the recurrence through
``lax.associative_scan``.  The library is built at first use with ``nvcc``
for ``sm_90a`` into ``build/repro_torch/lru_scan-<hash>.so``
(``kernels/_build.py``); nothing is built at import.  Each wrapper takes
CUDA tensors only: it checks device, dtype, contiguity and shapes,
allocates its outputs, launches on ``torch.cuda.current_stream()``, raises
on a non-zero launch status and adds one to its count in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, stream_of

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches since the last reset_launches(): a run reads it to show that
# its training steps went through the kernels.
LAUNCHES: Dict[str, int] = {"lru_scan": 0, "lru_scan_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary("lru_scan", {
    "lru_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lru_backward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
})
BUILD_INFO = LIBRARY.info


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check(what: str, seq: Dict[str, torch.Tensor],
           state: Dict[str, Optional[torch.Tensor]]) -> Tuple[int, int, int]:
    """Device, dtype, contiguity and shape checks → (B, T, R)."""
    tensors = {**seq, **{k: v for k, v in state.items() if v is not None}}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            dev = getattr(t, "device", type(t).__name__)
            raise RuntimeError(f"{what}: needs a CUDA tensor, got {name} "
                               f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    first = next(iter(seq.values()))
    if first.dtype not in _DTYPE_CODE or any(
            t.dtype != first.dtype for t in tensors.values()):
        raise TypeError(f"{what}: dtypes "
                        f"{ {k: t.dtype for k, t in tensors.items()} }; one "
                        f"of {list(_DTYPE_CODE)} for every tensor")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{what}: tensors lie on different cards")
    if first.dim() != 3 or min(first.shape) < 1 or any(
            t.shape != first.shape for t in seq.values()):
        raise ValueError(f"{what}: shapes "
                         f"{ {k: tuple(t.shape) for k, t in seq.items()} }; "
                         "needs equal (B, T, R) with B, T, R >= 1")
    B, T, R = first.shape
    for name, t in state.items():
        if t is not None and tuple(t.shape) != (B, R):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"not {(B, R)}")
    return B, T, R


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 forward: a, b (B,T,R) and h0 (B,R) or None, one dtype of f32 and
    bf16, contiguous, on one card → h (B,T,R) in that dtype."""
    B, T, R = _check("lru_scan", {"a": a, "b": b}, {"h0": h0})
    lib = load_library()
    h = torch.empty_like(a)
    check_launch(lib.lru_forward(a.data_ptr(), b.data_ptr(), _ptr(h0),
                                 h.data_ptr(), B, T, R, _DTYPE_CODE[a.dtype],
                                 stream_of(a)), "lru_scan")
    LAUNCHES["lru_scan"] += 1
    return h


def lru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                      h0: Optional[torch.Tensor], dh: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """K7 backward: from a, the forward's h, h0 (or None) and dh, all of
    one dtype → (da, db, dh0), dh0 None without h0."""
    B, T, R = _check("lru_scan_backward", {"a": a, "h": h, "dh": dh},
                     {"h0": h0})
    lib = load_library()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    check_launch(lib.lru_backward(
        a.data_ptr(), h.data_ptr(), _ptr(h0), dh.data_ptr(), da.data_ptr(),
        db.data_ptr(), _ptr(dh0), B, T, R, _DTYPE_CODE[a.dtype],
        stream_of(a)), "lru_scan_backward")
    LAUNCHES["lru_scan_backward"] += 1
    return da, db, dh0
