"""ctypes wrapper of K6, the hand-written CUDA kernel in
``csrc/flash_attention.cu``.

It replaces ``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``.
The library is built at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/flash_attention-<hash>.so`` (``kernels/_build.py``);
nothing is built at import.  The wrapper takes CUDA tensors only: it
checks device, dtype, contiguity and shapes, allocates the output, launches
on ``torch.cuda.current_stream()``, raises on a non-zero launch status and
adds one to :data:`LAUNCHES`.  The kernel has no backward pass, so a call
that autograd would have to differentiate raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, stream_of

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launches since the last reset_launches(): a run reads it to show that
# its prefill went through the kernel.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary("flash_attention", {
    "fa_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _I, ctypes.c_float, _I, _P),
})
BUILD_INFO = LIBRARY.info


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool, window: Optional[int],
                    attn_cap: Optional[float]) -> torch.Tensor:
    """K6: q (B,Tq,H,D), k (B,Tk,K,D), v (B,Tk,K,Dv), one dtype of f32,
    bf16 and f16, contiguous, on one card → o (B,Tq,H,Dv) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            dev = getattr(t, "device", type(t).__name__)
            raise RuntimeError(f"flash_attention: needs a CUDA tensor, "
                               f"got {name} on {dev}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-D tensor, got shape {tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; one of {list(_DTYPE_CODE)}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k and v lie on different cards")
    B, Tq, H, D = q.shape
    _, Tk, K, _ = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or K < 1 or H % K or min(B, Tq, Tk) < 1
            or not 1 <= D <= MAX_HEAD_DIM or not 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}; needs K | H, T >= 1, D and Dv <= "
            f"{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernel has no backward "
                           "pass; call it under torch.no_grad()")
    lib = load_library()
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    check_launch(lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Tq, Tk, H, K, D, Dv, float(scale), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if attn_cap is None else float(attn_cap),
        _DTYPE_CODE[q.dtype], stream_of(q)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
