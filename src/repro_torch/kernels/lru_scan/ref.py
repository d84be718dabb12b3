"""Plain PyTorch version of K7 (port of
``repro.kernels.lru_scan.ref.lru_scan_ref``).

The CPU tests and the model on the CPU use it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card; its gradient is autograd's through
the loop.  Unlike the reference's oracle it carries ``h`` in f32 for every
input dtype, as the reference's kernel and entry point do
(``lru_scan/kernel.py:35``), and writes each step in ``a``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1; a, b: (B, T, R); h0: (B, R)
    initial state (zeros if None).  Returns h: (B, T, R) in a.dtype."""
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device) if h0 is None else h0.float())
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out.append(h.to(a.dtype))
    return torch.stack(out, dim=1)
