"""BT — Block Tri-diagonal solver (NPB class S shapes; port of
``repro.npb.bt``).

Checkpoint variables (paper Table I): ``double u[12][13][13][5]``, ``int step``.

The SNU-C BT allocates u padded to 13 in the j and i dims but every loop
(compute_rhs, the ADI sweeps, error_norm — Fig 2) reads k, j, i ∈ [0, 12).
We mirror that exactly: the solver only ever touches ``u[:, :12, :12, :]``.
Expected criticality (Table II): 1500 uncritical / 10140 (planes j=12, i=12).

The ADI block solves are simplified to an explicit block-coupled stencil
update: the 5 components are mixed by a dense 5×5 matrix per step, which
preserves BT's "every interior element feeds every rms component" data
flow that error_norm then reads.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.npb.common import Benchmark, f64, i32, register, set_region

GP = 12  # grid_points[0..2] for class S
PAD = 13  # allocated extent of the j, i dims
NCOMP = 5
TOTAL_ITERS = 8
CKPT_ITER = 4
DT = 0.004


def _coords():
    # xi, eta, zeta on the 12^3 core, as in exact_solution().
    s = np.arange(GP) / (GP - 1)
    return np.meshgrid(s, s, s, indexing="ij")


def _exact_solution() -> np.ndarray:
    """Smooth reference field, one trig-polynomial per component."""
    z, y, x = _coords()
    comps = [
        1.0 + 0.1 * np.sin(np.pi * x) * np.cos(np.pi * y) * np.sin(np.pi * z),
        0.5 + 0.2 * np.cos(np.pi * x) * np.sin(2 * np.pi * y),
        0.3 + 0.1 * np.sin(2 * np.pi * z) * np.cos(np.pi * x),
        0.8 - 0.1 * np.cos(np.pi * y) * np.cos(np.pi * z),
        1.2 + 0.05 * np.sin(np.pi * (x + y + z)),
    ]
    return np.stack(comps, axis=-1)  # (12, 12, 12, 5)


def _mixing_matrix(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    m = rng.uniform(-0.2, 0.2, size=(NCOMP, NCOMP))
    np.fill_diagonal(m, 1.0)
    return m / np.abs(m).sum(axis=1, keepdims=True)  # row-stochastic-ish: stable


def _lap3(core: torch.Tensor) -> torch.Tensor:
    """Periodic 3-D Laplacian over the 12^3 core (per component)."""
    out = -6.0 * core
    for ax in range(3):
        out = out + torch.roll(core, 1, dims=ax) + torch.roll(core, -1, dims=ax)
    return out


def make_step(mix: np.ndarray, device, read_j=GP, read_i=GP):
    mix_t = f64(mix, device)
    core_idx = (slice(None), slice(0, read_j), slice(0, read_i), slice(None))

    def step(u: torch.Tensor) -> torch.Tensor:
        core = u[core_idx]  # the only read of u — NPB ranges
        rhs = _lap3(core) @ mix_t
        return set_region(u, core_idx, core + DT * rhs)

    return step


def make_error_norm(exact: np.ndarray, device):
    exact_t = f64(exact, device)

    def error_norm(u: torch.Tensor) -> torch.Tensor:
        # Fig 2: rms[m] = sqrt( sum_{k,j,i<12} (u - u_exact)^2 / 12^3 )
        add = u[:, :GP, :GP, :] - exact_t
        rms = torch.sum(add * add, dim=(0, 1, 2)) / float(GP**3)
        return torch.sqrt(rms)

    return error_norm


def _initial_u(exact: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    u = np.full((GP, PAD, PAD, NCOMP), 7.0, dtype=np.float64)  # pad sentinel
    u[:, :GP, :GP, :] = exact + 0.05 * rng.randn(GP, GP, GP, NCOMP)
    return u


def make_solver(name: str, seed: int, step, device) -> Benchmark:
    """BT and SP: ``step`` advances ``u``; error_norm verifies."""
    exact = _exact_solution()
    error_norm = make_error_norm(exact, device)

    def run_from(u, n_steps: int) -> torch.Tensor:
        for _ in range(n_steps):
            u = step(u)
        return u

    def initial():
        return f64(_initial_u(exact, seed), device)

    def checkpoint_state():
        u = run_from(initial(), CKPT_ITER)
        return {"u": u, "step": i32(CKPT_ITER, device)}

    def resume(state):
        u = run_from(state["u"], TOTAL_ITERS - CKPT_ITER)
        return {"rms": error_norm(u)}

    def reference():
        return {"rms": error_norm(run_from(initial(), TOTAL_ITERS))}

    return Benchmark(
        name=name,
        total_iters=TOTAL_ITERS,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={"u": (1500, 10140), "step": (0, 1)},
        device=device,
    )


@register("bt")
def make_bt(device) -> Benchmark:
    return make_solver("bt", 1, make_step(_mixing_matrix(1), device), device)
