"""LU — Lower-Upper symmetric Gauss-Seidel solver (NPB class S shapes;
port of ``repro.npb.lu``).

Checkpoint variables (paper Table I): ``u[12][13][13][5]``,
``rho_i[12][13][13]``, ``qs[12][13][13]``, ``rsd[12][13][13][5]``, ``istep``.

Access ranges mirrored from the SNU-C source / paper §IV-B:
- u components 0–3: read over the full [0,12)³ core (rhs sweeps + error_norm)
  → Fig-3 pattern, 300 uncritical each.
- u component 4 (energy): read only through the three directional flux
  ranges u[1:11,1:11,0:12,4], u[1:11,0:12,1:11,4], u[0:12,1:11,1:11,4]
  (Fig 7) → 428 uncritical.
- rho_i, qs: read over [0,12)³ before being recomputed → 300 uncritical each.
- rsd: read over the full core (SSOR relaxation + final residual rms)
  → same distribution as BT's u, 1500 uncritical.

Expected totals (Table II/paper text): u 1628/10140, rho_i 300/2028,
qs 300/2028, rsd 1500/10140.  (The published Table II swaps the rho_i and
rsd rows' sizes; we follow the paper's §IV-B text.)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.npb import bt as _bt
from repro_torch.npb.common import (Benchmark, add_region, f64, i32,
                                    register, set_region)

GP = 12
PAD = 13
NCOMP = 5
TOTAL_ITERS = 6
CKPT_ITER = 3
DT = 0.002
OMEGA = 1.2  # SSOR over-relaxation factor

_INT = slice(1, GP - 1)  # interior range [1, 11)
_CORE = (slice(None), slice(0, GP), slice(0, GP))


def _lap_interior(core: torch.Tensor) -> torch.Tensor:
    """Axis-aligned second differences evaluated on the interior."""
    c = core
    out = (
        c[2:, _INT, _INT] + c[:-2, _INT, _INT]
        + c[_INT, 2:, _INT] + c[_INT, :-2, _INT]
        + c[_INT, _INT, 2:] + c[_INT, _INT, :-2]
        - 6.0 * c[_INT, _INT, _INT]
    )
    return out


def _make_step(mix5: np.ndarray, w5: np.ndarray, device):
    mix_t = f64(mix5, device)
    w5_t = f64(w5, device)
    interior = (_INT, _INT, _INT, slice(None))

    def step(state):
        u, rho_i, qs, rsd = state["u"], state["rho_i"], state["qs"], state["rsd"]

        # --- reads, at exactly the NPB ranges --------------------------
        u0123 = u[:, :GP, :GP, :4]                 # full core, comps 0-3
        fx = u[_INT, _INT, 0:GP, 4]                # (10,10,12) x-flux range
        fy = u[_INT, 0:GP, _INT, 4]                # (10,12,10) y-flux range
        fz = u[0:GP, _INT, _INT, 4]                # (12,10,10) z-flux range
        r_core = rho_i[_CORE]                      # full core
        q_core = qs[_CORE]                         # full core
        rsd_core = rsd[:, :GP, :GP, :]             # full core

        # --- rhs: stencil + energy-flux divergence ----------------------
        lap = torch.stack(
            [_lap_interior(u0123[..., m]) for m in range(4)], dim=-1
        )  # (10,10,10,4)
        div = (
            (fx[:, :, 2:] - fx[:, :, :-2])
            + (fy[:, 2:, :] - fy[:, :-2, :])
            + (fz[2:, :, :] - fz[:-2, :, :])
        )  # (10,10,10)
        # global relaxation coefficient reads ALL of rho_i, qs cores
        coeff = 1.0 + 0.01 * torch.tanh(torch.mean(r_core * q_core))

        rhs = torch.cat(
            [lap @ mix_t[:4, :4], lap.new_zeros(lap.shape[:-1] + (1,))],
            dim=-1,
        ) + div[..., None] * w5_t  # (10,10,10,5)

        # --- SSOR-flavored relaxation of rsd (interior write) ------------
        new_rsd_int = (1.0 - OMEGA) * rsd_core[interior] + OMEGA * coeff * rhs
        rsd = set_region(rsd, interior, new_rsd_int)

        # --- u update from the fresh residual (interior write) ----------
        u = add_region(u, interior, DT * new_rsd_int)

        # --- recompute auxiliaries from u (full-core write) --------------
        u_new_core = u[:, :GP, :GP, :]
        rho_new = 1.0 / (torch.abs(u_new_core[..., 0]) + 2.0)
        qs_new = 0.5 * (u_new_core[..., 1] ** 2 + u_new_core[..., 2] ** 2) * rho_new
        rho_i = set_region(rho_i, _CORE, rho_new)
        qs = set_region(qs, _CORE, qs_new)

        return {"u": u, "rho_i": rho_i, "qs": qs, "rsd": rsd,
                "istep": state["istep"]}

    return step


def _finalize(exact: np.ndarray, device):
    exact_t = f64(exact[..., :4], device)

    def fin(state):
        u, rsd = state["u"], state["rsd"]
        # error_norm over comps 0-3 only (comp 4 is read via fluxes in-step).
        add = u[:, :GP, :GP, :4] - exact_t
        rms_u = torch.sqrt(torch.sum(add * add, dim=(0, 1, 2)) / float(GP**3))
        # final residual norm reads the FULL rsd core (all 5 comps).
        r = rsd[:, :GP, :GP, :]
        rms_r = torch.sqrt(torch.sum(r * r, dim=(0, 1, 2)) / float(GP**3))
        return {"rms_u": rms_u, "rms_r": rms_r}

    return fin


@register("lu")
def make_lu(device) -> Benchmark:
    exact = _bt._exact_solution()
    rng = np.random.RandomState(3)
    mix5 = _bt._mixing_matrix(seed=3)
    w5 = rng.uniform(0.1, 0.3, size=(NCOMP,))
    step = _make_step(mix5, w5, device)
    fin = _finalize(exact, device)

    def initial_state():
        # Fresh seeded generator: checkpoint_state() and reference() must see
        # the *same* initial field.
        rng_init = np.random.RandomState(31)
        u = _bt._initial_u(exact, seed=3)
        rho = np.full((GP, PAD, PAD), 7.0)
        q = np.full((GP, PAD, PAD), 7.0)
        rho[:, :GP, :GP] = 1.0 / (np.abs(u[:, :GP, :GP, 0]) + 2.0)
        q[:, :GP, :GP] = 0.5 * (u[:, :GP, :GP, 1] ** 2 + u[:, :GP, :GP, 2] ** 2) * rho[:, :GP, :GP]
        rsd = np.full((GP, PAD, PAD, NCOMP), 7.0)
        rsd[:, :GP, :GP, :] = 0.01 * rng_init.randn(GP, GP, GP, NCOMP)
        return {
            "u": f64(u, device),
            "rho_i": f64(rho, device),
            "qs": f64(q, device),
            "rsd": f64(rsd, device),
            "istep": i32(0, device),
        }

    def run(state, n):
        for _ in range(n):
            state = step(state)
        return state

    def checkpoint_state():
        s = run(initial_state(), CKPT_ITER)
        s["istep"] = i32(CKPT_ITER, device)
        return s

    def resume(state):
        return fin(run(state, TOTAL_ITERS - CKPT_ITER))

    def reference():
        return fin(run(initial_state(), TOTAL_ITERS))

    return Benchmark(
        name="lu",
        total_iters=TOTAL_ITERS,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={
            "u": (1628, 10140),
            "rho_i": (300, 2028),
            "qs": (300, 2028),
            "rsd": (1500, 10140),
            "istep": (0, 1),
        },
        device=device,
    )
