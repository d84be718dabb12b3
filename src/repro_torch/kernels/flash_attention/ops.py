"""Public entry for flash attention: K6 on the card, the plain version on
the CPU.

``flash_attention(q, k, v, *, window, causal, scale, attn_cap)`` serves
the train/prefill contract (positions are arange).  A CUDA tensor launches
K6 or the call raises; a CPU tensor takes ``flash_attention_ref``; there is
no fallback between the two.  Unlike ``repro``'s entry
(``kernels/flash_attention/ops.py:36-49``) there is no padding step and no
small-T branch: the kernel takes any T >= 1 and masks the ragged edge
itself, so a non-causal call never attends to padded keys.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, causal: bool = True,
                    scale: Optional[float] = None,
                    attn_cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Tq,H,D) k: (B,Tk,K,D) v: (B,Tk,K,Dv) → (B,Tq,H,Dv) in
    q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_ref(q, k, v, window=window, causal=causal,
                                   scale=scale, attn_cap=attn_cap)
    if kinds == {"cuda"}:
        return K.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale=scale, causal=causal,
                                 window=window, attn_cap=attn_cap)
    raise RuntimeError(f"flash_attention: tensors on {sorted(kinds)}; it "
                       "takes CUDA tensors (kernel) or CPU tensors (plain "
                       "version), not a mix")
