"""ctypes wrapper of K6, the hand-written CUDA kernels in
``csrc/flash_attention.cu``: the forward and the two passes of its
backward.

The forward replaces ``repro/kernels/flash_attention/kernel.py:
flash_attention_kernel``; the backward has no TPU counterpart (the
reference trains attention through XLA).  The library is built at first
use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/flash_attention-<hash>.so`` (``kernels/_build.py``);
nothing is built at import.  Each wrapper takes CUDA tensors only: it
checks device, dtype, contiguity and shapes, allocates its outputs,
launches on ``torch.cuda.current_stream()``, raises on a non-zero launch
status and adds one to its count in :data:`LAUNCHES` (the backward's two
passes count as one launch of ``flash_attention_backward``).

The library routes by dtype: bf16 inputs run the tensor-core kernels
(``mma.sync`` bf16 products, P and dS split into three bf16 terms), f32
and f16 inputs the CUDA-core kernels.  A bf16 call that cannot launch its
kernel raises; nothing falls back to the other route or to the plain
version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, stream_of

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The dtypes the library routes to the tensor-core kernels.  Their dK/dV
# pass writes f32 per-head partials (B, Tk, H, D + Dv) into scratch that
# the wrapper allocates; the CUDA-core kernels of the others take none.
TENSOR_CORE_DTYPES = frozenset({torch.bfloat16})

# Launches since the last reset_launches(): a run reads it to show that
# its prefill or its training steps went through the kernels.  Counted
# under a lock: host threads serving sessions prefill at once.
LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                             "flash_attention_backward": 0}
_LAUNCHES_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary("flash_attention", {
    "fa_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _I, ctypes.c_float, _I, _P),
    "fa_backward_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, ctypes.c_float, _I, _I, ctypes.c_float, _I,
                       _P),
    "fa_backward_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, ctypes.c_float, _I, _I, ctypes.c_float,
                         _I, _P),
})
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


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            dev = getattr(t, "device", type(t).__name__)
            raise RuntimeError(f"{what}: needs a CUDA tensor, "
                               f"got {name} on {dev}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"4-D tensor, got shape {tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q/k/v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; one of {list(_DTYPE_CODE)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"{what}: q, k and v lie on different cards")
    B, Tq, H, D = q.shape
    _, Tk, K, _ = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or K < 1 or H % K or min(B, Tq, Tk) < 1
            or not 1 <= D <= MAX_HEAD_DIM or not 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}; needs K | H, T >= 1, D and Dv <= "
            f"{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")


def _shape_args(q, k, v):
    B, Tq, H, D = q.shape
    _, Tk, K, _ = k.shape
    return B, Tq, Tk, H, K, D, v.shape[-1]


def _mask_args(scale, causal, window, attn_cap):
    return (float(scale), int(bool(causal)),
            0 if window is None else int(window),
            0.0 if attn_cap is None else float(attn_cap))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool, window: Optional[int],
                    attn_cap: Optional[float], with_lse: bool = False):
    """K6 forward: q (B,Tq,H,D), k (B,Tk,K,D), v (B,Tk,K,Dv), one dtype of
    f32, bf16 and f16, contiguous, on one card → o (B,Tq,H,Dv) in q's
    dtype.  With ``with_lse`` → (o, lse, o32), what the backward reads:
    the row log-sum-exp (B,H,Tq) f32, and o in f32 before its rounding
    (None for f32 inputs, where it is o)."""
    _check("flash_attention", q, k, v, window)
    lib = load_library()
    B, Tq, Tk, H, K, D, Dv = _shape_args(q, k, v)
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    lse = o32 = None
    if with_lse:
        lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        if q.dtype != torch.float32:
            o32 = torch.empty((B, Tq, H, Dv), dtype=torch.float32,
                              device=q.device)
    check_launch(lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if o32 is None else o32.data_ptr(), B, Tq, Tk, H, K, D, Dv,
        *_mask_args(scale, causal, window, attn_cap),
        _DTYPE_CODE[q.dtype], stream_of(q)), "flash_attention")
    _count("flash_attention")
    return (out, lse, o32) if with_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             scale: float, causal: bool,
                             window: Optional[int], attn_cap: Optional[float]
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K6 backward: from the forward's inputs, its output in f32 (``o``:
    the forward's o32, or o itself for f32 inputs), its lse, and do (the
    output's shape, the inputs' dtype) → (dq, dk, dv) in the inputs'
    dtype.  Two launches on the current stream: the dQ pass (which also
    writes the f32 row sums dO·O) and the dK/dV pass that reads them (for
    bf16, into f32 per-head partials that a third kernel sums over each
    GQA group in a fixed order)."""
    what = "flash_attention_backward"
    _check(what, q, k, v, window)
    B, Tq, Tk, H, K, D, Dv = _shape_args(q, k, v)
    for name, t, shape, dtype in (("o", o, (B, Tq, H, Dv), torch.float32),
                                  ("do", do, (B, Tq, H, Dv), q.dtype),
                                  ("lse", lse, (B, H, Tq), torch.float32)):
        if (not isinstance(t, torch.Tensor) or t.device != q.device
                or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {q.device}")
    lib = load_library()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dl = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    part = (torch.empty(B * Tk * H * (D + Dv), dtype=torch.float32,
                        device=q.device)
            if q.dtype in TENSOR_CORE_DTYPES else None)
    tail = (B, Tq, Tk, H, K, D, Dv, *_mask_args(scale, causal, window,
                                                 attn_cap),
            _DTYPE_CODE[q.dtype], stream_of(q))
    check_launch(lib.fa_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dl.data_ptr(), dq.data_ptr(), *tail),
        what)
    check_launch(lib.fa_backward_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dl.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), *tail), what)
    _count("flash_attention_backward")
    return dq, dk, dv
