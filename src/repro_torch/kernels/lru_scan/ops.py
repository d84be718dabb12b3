"""Public entry for the LRU scan: K7 on the card, the plain version on the
CPU.

``lru_scan(a, b, h0=None)``: h_t = a_t ⊙ h_{t-1} + b_t over axis 1, as
``repro/kernels/lru_scan/ops.py:19-28``: a, b (B, T, R), h0 (B, R), an f32
carry and the output in ``a``'s dtype.  Unlike the reference's entry there
is no padding and no ``T % 8`` / ``R % 128`` branch: the kernels take any
T and R.

The forward and the backward are custom ops, ``repro_torch::lru_scan`` and
``repro_torch::lru_scan_backward``: their CUDA implementations launch K7's
kernels, their CPU implementations run the plain version
(``lru_scan_ref`` and ``lru_scan_backward_ref``, which reads the
forward's ``h`` as the kernel does).  So a
traced step (``core/taint.py``) holds one node per call on either device
instead of a kernel it cannot see.  A call that autograd can reach goes
through :class:`LruScan`, whose forward and backward call the two ops
(``torch.func.vjp``, the scrutiny, runs it); the others call the forward
op alone.  There is no fallback between the devices.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lru_scan import kernel as K
from repro_torch.kernels.lru_scan.ref import (lru_scan_backward_ref,
                                              lru_scan_ref)


# The ops are defined on the dispatcher directly (``torch.library.Library``):
# ``torch.library.custom_op`` adds Python layers to every call and imports
# ``torch._dynamo`` at a process's first call.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("lru_scan(Tensor a, Tensor b, Tensor? h0) -> Tensor")
_LIB.define("lru_scan_backward(Tensor a, Tensor h, Tensor? h0, Tensor dh) "
            "-> (Tensor, Tensor, Tensor)")


def _scan_card(a, b, h0):
    """K7 forward."""
    return K.lru_scan(a, b, h0)


def _scan_plain(a, b, h0):
    return lru_scan_ref(a, b, h0)


def _scan_fake(a, b, h0):
    return torch.empty_like(a)


def _scan_backward_card(a, h, h0, dh):
    """K7 backward → (da, db, dh0) from the forward's ``h``; dh0 is empty
    without h0."""
    da, db, dh0 = K.lru_scan_backward(a, h, h0, dh)
    return da, db, a.new_empty(0) if dh0 is None else dh0


def _scan_backward_plain(a, h, h0, dh):
    da, db, dh0 = lru_scan_backward_ref(a, h, h0, dh)
    return da, db, a.new_empty(0) if dh0 is None else dh0


def _scan_backward_fake(a, h, h0, dh):
    return (torch.empty_like(a), torch.empty_like(a),
            a.new_empty(0) if h0 is None else torch.empty_like(h0))


for _name, _card, _plain, _fake in (
        ("lru_scan", _scan_card, _scan_plain, _scan_fake),
        ("lru_scan_backward", _scan_backward_card, _scan_backward_plain,
         _scan_backward_fake)):
    _LIB.impl(_name, _card, "CUDA")
    _LIB.impl(_name, _plain, "CPU")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)
scan_op = torch.ops.repro_torch.lru_scan.default
scan_backward_op = torch.ops.repro_torch.lru_scan_backward.default


class LruScanBackward(torch.autograd.Function):
    """The backward op as a Function of its own, so that :class:`LruScan`'s
    backward is made of Functions that ``torch.func`` can run at any
    transform level (its forward always sees plain tensors).  It has no
    backward itself: the port takes no second derivative through the
    scan."""

    @staticmethod
    def forward(a, h, h0, dh):
        da, db, dh0 = scan_backward_op(a, h, h0, dh.contiguous())
        return da, db, None if h0 is None else dh0

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("lru_scan: no second derivative through K7")


class LruScan(torch.autograd.Function):
    """The forward op; the backward is :class:`LruScanBackward`.  Written in
    the forward / ``setup_context`` form, which lets ``torch.func.vjp``
    (the scrutiny) run it."""

    @staticmethod
    def forward(a, b, h0):
        return scan_op(a, b, h0)

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
    if kinds not in ({"cpu"}, {"cuda"}):
        raise RuntimeError(f"lru_scan: tensors on {sorted(kinds)}; it "
                           "takes CUDA tensors (kernel) or CPU tensors "
                           "(plain version), not a mix")
    args = (a.contiguous(), b.contiguous(),
            None if h0 is None else h0.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LruScan.apply(*args)
    return scan_op(*args)
