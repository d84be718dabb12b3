"""FT — 3-D FFT PDE solver (NPB class S shapes; port of ``repro.npb.ft``).

Checkpoint variables (paper Table I): ``dcomplex y[64][64][65]``,
``dcomplex sums[6]``, ``int kt``.  The last dim is padded to NX+1 = 65;
every read is ``y[:, :, :64]`` → the plane at index 64 (paper Fig 8's
"top layer") is uncritical.  Expected: 4096 uncritical / 266240.

``sums[t]`` stores the checksum of iteration t.  At a checkpoint taken after
iteration ``kt``, AD marks ``sums[:kt]`` critical (those values are emitted
into the final verification) and ``sums[kt:]`` uncritical (they are
recomputed / overwritten after restart).

The solver is genuine: y is the frequency-domain field, each iteration
applies the evolution twiddle exp(−4απ²t·k̄²) and takes an inverse 3-D FFT
(``torch.fft.ifftn``), then a 1024-sample NPB-style checksum.  The
checksum reads the lattice ``j·(5, 3, 1) mod 64``, so only the 4,096
frequencies with ``(5·kz + 3·ky + kx) mod 64 == 0`` reach it exactly;
every other element of ``y[:, :, :64]`` gets a gradient of FFT round-off,
which ``zero_tol = 0`` counts as critical.  How many of those bits are set
depends on the FFT (the reference's XLA FFT, torch's CPU FFT and cuFFT
each give their own count): only the lattice and the padding plane are
structural.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.npb.common import Benchmark, f64, i32, register

NX, NY, NZ = 64, 64, 64
XPAD = NX + 1  # 65
NITER = 6
CKPT_ITER = 3
ALPHA = 1e-6


def _twiddle_exponent() -> np.ndarray:
    """-4 α π² (k̄x² + k̄y² + k̄z²) on the 64³ grid (signed frequencies)."""

    def bar(n):
        k = np.arange(n)
        return np.where(k < n // 2, k, k - n) ** 2

    kz = bar(NZ)[:, None, None]
    ky = bar(NY)[None, :, None]
    kx = bar(NX)[None, None, :]
    return -4.0 * ALPHA * np.pi**2 * (kz + ky + kx)


def _checksum_indices():
    """(s, r, q): the z, y, x indices of the 1024 checksum samples."""
    j = np.arange(1, 1025)
    return (5 * j) % NZ, (3 * j) % NY, j % NX


def lattice_mask() -> np.ndarray:
    """Flat bool over ``y`` (64, 64, 65): the frequencies the checksum
    reads exactly, ``(5·kz + 3·ky + kx) mod 64 == 0`` with ``kx < 64``."""
    kz, ky, kx = np.meshgrid(np.arange(NZ), np.arange(NY), np.arange(XPAD),
                             indexing="ij")
    return (((5 * kz + 3 * ky + kx) % NX == 0) & (kx < NX)).reshape(-1)


def _initial_freq(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x0 = rng.randn(NZ, NY, NX) + 1j * rng.randn(NZ, NY, NX)
    y = np.full((NZ, NY, XPAD), 7.0 + 7.0j, dtype=np.complex128)  # pad sentinel
    y[:, :, :NX] = np.fft.fftn(x0)
    return y


def _set(sums: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """``sums.at[i].set(v)``."""
    return torch.cat([sums[:i], v.reshape(1), sums[i + 1:]])


@register("ft")
def make_ft(device) -> Benchmark:
    expo = f64(_twiddle_exponent(), device)
    s, r, q = (torch.as_tensor(a, device=device) for a in _checksum_indices())

    def iter_t(y: torch.Tensor, t: int) -> torch.Tensor:
        """Checksum of iteration t (1-based).  Reads y[:, :, :64] only."""
        freq = y[:, :, :NX]
        x = torch.fft.ifftn(freq * torch.exp(expo * float(t)))
        return torch.sum(x[s, r, q]) / float(NX * NY * NZ)

    def initial():
        y = torch.as_tensor(_initial_freq(seed=4), device=device)
        sums = torch.full((NITER,), 7.0 + 7.0j, dtype=torch.complex128,
                          device=device)
        return y, sums

    def checkpoint_state():
        y, sums = initial()
        for t in range(1, CKPT_ITER + 1):
            sums = _set(sums, t - 1, iter_t(y, t))
        return {"y": y, "sums": sums, "kt": i32(CKPT_ITER, device)}

    def resume(state):
        y, sums = state["y"], state["sums"]
        for t in range(CKPT_ITER + 1, NITER + 1):
            sums = _set(sums, t - 1, iter_t(y, t))
        return {"sums": sums}

    def reference():
        y, sums = initial()
        for t in range(1, NITER + 1):
            sums = _set(sums, t - 1, iter_t(y, t))
        return {"sums": sums}

    return Benchmark(
        name="ft",
        total_iters=NITER,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={
            "y": (4096, NZ * NY * XPAD),
            # AD's sharper answer: suffix entries are overwritten post-restart.
            "sums": (NITER - CKPT_ITER, NITER),
            "kt": (0, 1),
        },
        device=device,
    )
