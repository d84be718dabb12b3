"""SP — Scalar Pentadiagonal solver (NPB class S shapes; port of
``repro.npb.sp``).

Identical checkpoint variables and access ranges to BT (paper §IV-B: "SP
invokes the same function error_norm ... exactly the same critical-uncritical
distribution").  The solver sweep differs: SP's scalar pentadiagonal factor
is modeled with an added 4th-order (pentadiagonal-stencil) dissipation term,
still reading only u[:, :12, :12, :].

Expected criticality (Table II): 1500 uncritical / 10140.
"""

from __future__ import annotations

import torch

from repro_torch.npb import bt as _bt
from repro_torch.npb.common import Benchmark, f64, register, set_region

GP = _bt.GP
DT = 0.003


def _biharmonic(core: torch.Tensor) -> torch.Tensor:
    """Periodic 4th-difference per axis — the pentadiagonal stencil."""
    out = torch.zeros_like(core)
    for ax in range(3):
        out = out + (
            torch.roll(core, 2, dims=ax)
            - 4.0 * torch.roll(core, 1, dims=ax)
            + 6.0 * core
            - 4.0 * torch.roll(core, -1, dims=ax)
            + torch.roll(core, -2, dims=ax)
        )
    return out


@register("sp")
def make_sp(device) -> Benchmark:
    mix_t = f64(_bt._mixing_matrix(seed=2), device)
    core_idx = (slice(None), slice(0, GP), slice(0, GP), slice(None))

    def step(u: torch.Tensor) -> torch.Tensor:
        core = u[core_idx]
        rhs = _bt._lap3(core) @ mix_t - 0.05 * _biharmonic(core)
        return set_region(u, core_idx, core + DT * rhs)

    return _bt.make_solver("sp", 2, step, device)
