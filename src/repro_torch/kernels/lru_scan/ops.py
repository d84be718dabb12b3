"""Public entry for the LRU scan: K7 on the card, the plain version on the
CPU.

``lru_scan(a, b, h0=None)``: h_t = a_t ⊙ h_{t-1} + b_t over axis 1, as
``repro/kernels/lru_scan/ops.py:19-28``: a, b (B, T, R), h0 (B, R), an f32
carry and the output in ``a``'s dtype.  CUDA tensors go through
:class:`LruScan`, whose forward and backward are K7's kernels; CPU tensors
take ``lru_scan_ref`` and autograd's gradient through its loop.  There is
no fallback between the two, and unlike the reference's entry no padding
and no ``T % 8`` / ``R % 128`` branch: the kernels take any T and R.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lru_scan import kernel as K
from repro_torch.kernels.lru_scan.ref import lru_scan_ref


class LruScanBackward(torch.autograd.Function):
    """K7's backward kernel as a Function of its own, so that
    :class:`LruScan`'s backward is made of Functions that ``torch.func``
    can run at any transform level (its forward always sees plain
    tensors).  It has no backward itself: the port takes no second
    derivative through the scan."""

    @staticmethod
    def forward(a, h, h0, dh):
        return K.lru_scan_backward(a, h, h0, dh.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("lru_scan: no second derivative through K7")


class LruScan(torch.autograd.Function):
    """K7 forward; the backward is :class:`LruScanBackward`.  Written in the
    forward / ``setup_context`` form, which lets ``torch.func.vjp`` (the
    scrutiny) run it."""

    @staticmethod
    def forward(a, b, h0):
        return K.lru_scan(a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _, h0 = inputs
        ctx.save_for_backward(a, output, h0)

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        return LruScanBackward.apply(a, h, h0, dh)


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1; a, b: (B, T, R)."""
    tensors = [a, b] + ([] if h0 is None else [h0])
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return lru_scan_ref(a, b, h0)
    if kinds == {"cuda"}:
        return LruScan.apply(a.contiguous(), b.contiguous(),
                             None if h0 is None else h0.contiguous())
    raise RuntimeError(f"lru_scan: tensors on {sorted(kinds)}; it takes "
                       "CUDA tensors (kernel) or CPU tensors (plain "
                       "version), not a mix")
