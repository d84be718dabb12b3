"""MG — V-cycle multigrid Poisson solver (NPB class S shapes; port of
``repro.npb.mg``).

Checkpoint variables (paper Table I): ``double u[46480]``, ``double
r[46480]``, ``int it``.  Both buffers hold all five grid levels
(34³, 18³, 10³, 6³, 4³ = 46416 elements) plus 64 elements of allocator
padding, exactly the SNU-C memory layout.

Criticality mechanics mirrored from the source (paper §IV-B, Figs 4-5):
- ``u``: coarse levels are zeroed (``zero3``) inside every V-cycle before
  use and the padding is never touched → only the finest 34³ prefix is
  critical.  Expected: 7176 uncritical / 46480.
- ``r``: the first resumed operation is the ``rprj3`` restriction chain,
  which reads the fine level at indices [1, 34) per dim (the 33³ pattern of
  Fig 5); coarse levels are overwritten by rprj3 before any read.
  Expected: 46480 − 33³ = 10543 uncritical (Table II).

The V-cycle itself is genuine NPB: 27-point stencils with distance-class
coefficients, full-weighting restriction, trilinear interpolation, periodic
``comm3`` boundary exchange.  The level views of the flat buffers are
slices at ``OFFSETS`` (the reference's ``dynamic_slice``); every write
goes into a fresh clone or a ``torch.cat``, so the state leaves are never
written.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.npb.common import (Benchmark, add_region, f64, i32,
                                    register, set_region)

LT = 5  # number of levels; level index 0 = coarsest (4³) … 4 = finest (34³)
SIZES = [2 ** (k + 1) + 2 for k in range(LT)]  # [4, 6, 10, 18, 34]
OFFSETS: List[int] = []
_off = 0
for m in reversed(SIZES):  # finest first in the flat buffer (NPB layout)
    OFFSETS.append(_off)
    _off += m**3
OFFSETS = list(reversed(OFFSETS))  # OFFSETS[k] for level k (coarse→fine)
BUF = 46480  # paper's allocation; 46416 used + 64 padding
assert _off == 46416

TOTAL_ITERS = 4
CKPT_ITER = 2

# NPB stencil coefficients by Manhattan distance (class S "smoother" c).
A_COEF = (-8.0 / 3.0, 0.0, 1.0 / 6.0, 1.0 / 12.0)
C_COEF = (-3.0 / 8.0, 1.0 / 32.0, -1.0 / 64.0, 0.0)

_OFFS3 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_INTERIOR = (slice(1, -1),) * 3


def _stencil27(x: torch.Tensor, coef) -> torch.Tensor:
    """27-point stencil on the interior; reads the full cube incl. corners."""
    m = x.shape[0]
    acc = None
    for dz, dy, dx in _OFFS3:
        c = coef[abs(dz) + abs(dy) + abs(dx)]
        if c == 0.0:
            continue
        term = c * x[1 + dz : m - 1 + dz, 1 + dy : m - 1 + dy, 1 + dx : m - 1 + dx]
        acc = term if acc is None else acc + term
    return acc


def _comm3(x: torch.Tensor) -> torch.Tensor:
    """Periodic boundary exchange (NPB comm3), axis by axis: face 0 takes
    face m-2 and face m-1 takes face 1."""
    m = x.shape[0]
    for ax in range(3):
        x = torch.cat([x.narrow(ax, m - 2, 1), x.narrow(ax, 1, m - 2),
                       x.narrow(ax, 1, 1)], dim=ax)
    return x


def _rprj3(rf: torch.Tensor, mc: int) -> torch.Tensor:
    """Full-weighting restriction; reads fine indices [1, m) per dim."""
    m = rf.shape[0]
    acc = None
    w = (1.0 / 8.0, 1.0 / 16.0, 1.0 / 32.0, 1.0 / 64.0)
    for dz, dy, dx in _OFFS3:
        c = w[abs(dz) + abs(dy) + abs(dx)]
        term = c * rf[2 + dz : m - 1 + dz : 2, 2 + dy : m - 1 + dy : 2, 2 + dx : m - 1 + dx : 2]
        acc = term if acc is None else acc + term
    rc = set_region(rf.new_zeros((mc, mc, mc)), _INTERIOR, acc)
    return _comm3(rc)


def _interp_add(uf: torch.Tensor, zc: torch.Tensor) -> torch.Tensor:
    """Trilinear prolongation ADDED into the fine grid (NPB interp).

    Writes fine indices [0, m-1) per dim via read-modify-write — this is the
    read that makes the entire checkpointed fine u critical.
    """
    mc = zc.shape[0]
    for bz in (0, 1):
        for by in (0, 1):
            for bx in (0, 1):
                contrib = None
                norm = 2.0 ** -(bz + by + bx)
                for sz in range(bz + 1):
                    for sy in range(by + 1):
                        for sx in range(bx + 1):
                            t = zc[sz : sz + mc - 1, sy : sy + mc - 1, sx : sx + mc - 1]
                            contrib = t if contrib is None else contrib + t
                uf = add_region(uf, (
                    slice(bz, bz + 2 * (mc - 1), 2),
                    slice(by, by + 2 * (mc - 1), 2),
                    slice(bx, bx + 2 * (mc - 1), 2),
                ), norm * contrib)
    return uf


def _psinv(r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return _comm3(add_region(u, _INTERIOR, _stencil27(r, C_COEF)))


def _resid(u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """r = rhs − A·u on the interior, then comm3."""
    r = set_region(torch.zeros_like(u), _INTERIOR,
                   rhs[_INTERIOR] - _stencil27(u, A_COEF))
    return _comm3(r)


def _mg3p(u: List[torch.Tensor], r: List[torch.Tensor], v: torch.Tensor):
    """One V-cycle (NPB mg3P).  Levels: 0 coarsest … LT-1 finest."""
    # down: restrict residuals
    for k in range(LT - 1, 0, -1):
        r[k - 1] = _rprj3(r[k], SIZES[k - 1])
    # bottom solve
    u[0] = torch.zeros_like(u[0])
    u[0] = _psinv(r[0], u[0])
    # up
    for k in range(1, LT - 1):
        u[k] = torch.zeros_like(u[k])
        u[k] = _interp_add(u[k], u[k - 1])
        r[k] = _resid(u[k], r[k])
        u[k] = _psinv(r[k], u[k])
    # top level: interp ADDS into the persistent fine u
    k = LT - 1
    u[k] = _interp_add(u[k], u[k - 1])
    r[k] = _resid(u[k], v)
    u[k] = _psinv(r[k], u[k])
    return u, r


def _unpack(buf: torch.Tensor) -> List[torch.Tensor]:
    return [buf[OFFSETS[k]:OFFSETS[k] + m**3].reshape(m, m, m)
            for k, m in enumerate(SIZES)]


def _pack(levels: List[torch.Tensor]) -> torch.Tensor:
    """The flat buffer, finest level first, zero padding at the end."""
    parts = [levels[k].reshape(-1) for k in reversed(range(LT))]
    pad = levels[0].new_zeros(BUF - OFFSETS[0] - SIZES[0] ** 3)
    return torch.cat(parts + [pad])


def _make_v() -> np.ndarray:
    """NPB zran3-style RHS: ±1 charges at fixed pseudo-random fine cells."""
    m = SIZES[-1]
    rng = np.random.RandomState(31415)
    v = np.zeros((m, m, m))
    interior = rng.randint(1, m - 1, size=(20, 3))
    for idx, (z, y, x) in enumerate(interior):
        v[z, y, x] = 1.0 if idx < 10 else -1.0
    return v


@register("mg")
def make_mg(device) -> Benchmark:
    v = f64(_make_v(), device)

    def one_iter(u_levels, r_levels):
        u_levels, r_levels = _mg3p(u_levels, r_levels, v)
        r_levels[LT - 1] = _resid(u_levels[LT - 1], v)
        return u_levels, r_levels

    def initial_levels():
        u0 = [torch.zeros((m, m, m), dtype=torch.float64, device=device)
              for m in SIZES]
        r0 = [torch.zeros((m, m, m), dtype=torch.float64, device=device)
              for m in SIZES]
        r0[LT - 1] = _resid(u0[LT - 1], v)  # initial residual = v (u = 0)
        return u0, r0

    def run(u_levels, r_levels, n):
        for _ in range(n):
            u_levels, r_levels = one_iter(u_levels, r_levels)
        return u_levels, r_levels

    def rnm2(r_levels):
        rf = r_levels[LT - 1]
        m = SIZES[-1]
        return {"rnm2": torch.sqrt(torch.sum(rf[_INTERIOR] ** 2)
                                   / float((m - 2) ** 3))}

    def checkpoint_state():
        u_l, r_l = run(*initial_levels(), CKPT_ITER)
        return {"u": _pack(u_l), "r": _pack(r_l), "it": i32(CKPT_ITER, device)}

    def resume(state):
        u_l, r_l = run(_unpack(state["u"]), _unpack(state["r"]),
                       TOTAL_ITERS - CKPT_ITER)
        return rnm2(r_l)

    def reference():
        return rnm2(run(*initial_levels(), TOTAL_ITERS)[1])

    return Benchmark(
        name="mg",
        total_iters=TOTAL_ITERS,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={"u": (7176, BUF), "r": (10543, BUF), "it": (0, 1)},
        device=device,
    )
