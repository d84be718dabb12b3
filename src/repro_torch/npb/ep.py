"""EP — Embarrassingly Parallel Gaussian-deviate tally (NPB, reduced size;
port of ``repro.npb.ep``).

Checkpoint variables (paper Table I): ``double sx``, ``double sy``,
``double q[10]``, ``int k``.  The paper finds *no* uncritical elements in
EP — every tally is read (write-after-read accumulation) — and so do we:
expected uncritical = 0 for all four variables.

Faithful mechanics: pairs of uniforms from the NPB ``randlc`` LCG
(a = 5¹³, modulus 2⁴⁶, implemented exactly with the double-based split
arithmetic of the original), Marsaglia polar acceptance x²+y² ≤ 1,
Gaussian deviates scaled by sqrt(−2 ln t / t), per-annulus counts into q.
Size is reduced from class S's 2²⁴ pairs to 2¹⁶ (chunked), which changes
the tallies but not the criticality structure.  The annulus counts are
an ``index_add``; they are exact integers in float64, so the order of the
additions does not matter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.npb.common import Benchmark, f64, i32, register

M = 16  # 2^16 pairs (class S uses 2^24; reduced, same structure)
CHUNK = 1024
NCHUNKS = (1 << M) // CHUNK  # 64
CKPT_CHUNK = NCHUNKS // 2
NQ = 10

_R23 = 2.0**-23
_T23 = 2.0**23
_R46 = 2.0**-46
_T46 = 2.0**46
_A = 1220703125.0  # 5^13
_SEED = 271828183.0


def _randlc_stream(n: int) -> np.ndarray:
    """Exact NPB randlc: n uniforms in (0,1) from the 2^46 LCG."""
    out = np.empty(n)
    x = _SEED
    a1 = int(_R23 * _A)
    a2 = _A - _T23 * a1
    for i in range(n):
        t1 = _R23 * x
        x1 = int(t1)
        x2 = x - _T23 * x1
        t1 = a1 * x2 + a2 * x1
        t2 = int(_R23 * t1)
        z = t1 - _T23 * t2
        t3 = _T23 * z + a2 * x2
        t4 = int(_R46 * t3)
        x = t3 - _T46 * t4
        out[i] = _R46 * x
    return out


@functools.lru_cache(maxsize=1)
def _uniforms() -> np.ndarray:
    """The whole stream, (NCHUNKS, 2, CHUNK); read-only."""
    return _randlc_stream(2 * (1 << M)).reshape(NCHUNKS, 2, CHUNK)


def _chunk_tally(xu: torch.Tensor, yu: torch.Tensor):
    """Gaussian tallies for one chunk of uniform pairs (NPB inner loop)."""
    x = 2.0 * xu - 1.0
    y = 2.0 * yu - 1.0
    t = x * x + y * y
    accept = t <= 1.0
    tsafe = torch.where(accept, t, 0.5)
    fac = torch.sqrt(-2.0 * torch.log(tsafe) / tsafe)
    xg = torch.where(accept, x * fac, 0.0)
    yg = torch.where(accept, y * fac, 0.0)
    l = torch.clamp(torch.floor(torch.maximum(xg.abs(), yg.abs())),
                    max=NQ - 1).to(torch.int64)
    counts = xu.new_zeros(NQ).index_add(0, l, accept.to(xu.dtype))
    return torch.sum(xg), torch.sum(yg), counts


@register("ep")
def make_ep(device) -> Benchmark:
    uni = f64(_uniforms(), device)

    def run_chunks(sx, sy, q, start, stop):
        for c in range(start, stop):
            dx, dy, dq = _chunk_tally(uni[c, 0], uni[c, 1])
            sx = sx + dx
            sy = sy + dy
            q = q + dq
        return sx, sy, q

    def zeros():
        return f64(0.0, device), f64(0.0, device), f64(np.zeros(NQ), device)

    def outputs(sx, sy, q):
        return {"sx": sx, "sy": sy, "q": q, "gc": torch.sum(q)}

    def checkpoint_state():
        sx, sy, q = run_chunks(*zeros(), 0, CKPT_CHUNK)
        return {"sx": sx, "sy": sy, "q": q, "k": i32(CKPT_CHUNK, device)}

    def resume(state):
        return outputs(*run_chunks(state["sx"], state["sy"], state["q"],
                                   CKPT_CHUNK, NCHUNKS))

    def reference():
        return outputs(*run_chunks(*zeros(), 0, NCHUNKS))

    return Benchmark(
        name="ep",
        total_iters=NCHUNKS,
        ckpt_iter=CKPT_CHUNK,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={"sx": (0, 1), "sy": (0, 1), "q": (0, NQ), "k": (0, 1)},
        device=device,
    )
