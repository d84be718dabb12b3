"""CG — Conjugate Gradient eigenvalue estimator (NPB class S shapes; port
of ``repro.npb.cg``).

Checkpoint variables (paper Table I): ``double x[1402]``, ``int it``.
``x`` is allocated NA+2 = 1402 but only the first NA = 1400 entries
participate (paper §IV-B / Fig 6) → expected 2 uncritical / 1402.

The solver is genuine CG: each outer iteration solves A·z = x with 25 CG
steps and applies inverse power iteration x ← z/‖z‖, ζ = SHIFT + 1/(xᵀz).
A is a fixed SPD matrix standing in for NPB's makea() sparse operator
(dense here — class S is 1400², which is small).  ``A @ p`` is a plain
``torch.matmul``: the reference computes it outside any Pallas kernel.
The reference's ``lax.scan`` loops are Python loops.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.npb.common import Benchmark, f64, i32, register

NA = 1400
PAD = 2
SHIFT = 10.0
CGITMAX = 25
TOTAL_ITERS = 8
CKPT_ITER = 4


def _make_A() -> np.ndarray:
    """SPD stand-in for makea(): well-conditioned, deterministic."""
    rng = np.random.RandomState(12345)
    m = rng.randn(NA, 12)  # low-rank + identity => condition ~ O(10)
    a = (m @ m.T) / 12.0 + np.eye(NA) * 2.0
    return a


def _conj_grad(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """25 CG iterations for A z = x, z0 = 0 (NPB conj_grad)."""
    z = torch.zeros_like(x)
    r = x
    p = r
    rho = torch.dot(r, r)
    for _ in range(CGITMAX):
        q = A @ p
        alpha = rho / torch.dot(p, q)
        z = z + alpha * p
        r = r - alpha * q
        rho_new = torch.dot(r, r)
        beta = rho_new / rho
        p = r + beta * p
        rho = rho_new
    return z


@register("cg")
def make_cg(device) -> Benchmark:
    A = f64(_make_A(), device)

    def outer_iter(x_active):
        z = _conj_grad(A, x_active)
        zeta = SHIFT + 1.0 / torch.dot(x_active, z)
        return z / torch.linalg.norm(z), zeta

    def run(x_active, n):
        zetas = []
        for _ in range(n):
            x_active, zeta = outer_iter(x_active)
            zetas.append(zeta)
        return x_active, torch.stack(zetas)

    def initial_x() -> torch.Tensor:
        x = np.ones(NA + PAD, dtype=np.float64)
        x[NA:] = 7.0  # padding; never read
        return f64(x, device)

    def checkpoint_state():
        x = initial_x()
        x_active, _ = run(x[:NA], CKPT_ITER)
        return {"x": torch.cat([x_active, x[NA:]]),
                "it": i32(CKPT_ITER, device)}

    def resume(state):
        x_active = state["x"][:NA]  # the only read range of x (Fig 6)
        x_active, zetas = run(x_active, TOTAL_ITERS - CKPT_ITER)
        # NPB prints zeta every outer iteration — all post-restart zetas are
        # program output.  (Power iteration is contractive, so the *final*
        # zeta alone would hide finite corruption of x.)
        return {"zetas": zetas, "xnorm": torch.linalg.norm(x_active)}

    def reference():
        x_active, zetas = run(initial_x()[:NA], TOTAL_ITERS)
        return {"zetas": zetas[CKPT_ITER:],
                "xnorm": torch.linalg.norm(x_active)}

    return Benchmark(
        name="cg",
        total_iters=TOTAL_ITERS,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={"x": (2, 1402), "it": (0, 1)},
        device=device,
    )
