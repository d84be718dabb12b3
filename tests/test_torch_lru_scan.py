"""K7, the RG-LRU scan: the port's entry against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.lru_scan.ops.lru_scan`` runs K7's
plain version (a loop over T with an f32 carry); it must agree with the
reference's ``lru_scan_ref`` and its Pallas kernel in interpret mode, and
its gradients (autograd through the loop) with ``jax.vjp`` of
``lru_scan_ref``.  ``rglru_train`` runs the recurrence through it where
the reference runs ``lax.associative_scan``: the same recurrence in
another association order.  The autograd Function that carries the
kernels' custom ops (``repro_torch::lru_scan`` and its backward; on CPU
tensors their implementations are the plain version) is driven under
plain autograd, ``torch.func.vjp`` (the scrutiny) and a
``torch.func.grad`` nested inside it, and every forward and backward is
counted at the dispatcher.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 1e-5 (atol and rtol: one rounding a step, in another
order, decaying through a < 1); bf16 2e-2 (the output's one rounding);
the RG-LRU block 1e-5 of its largest output (f32, matmuls and the scan
summed in another order).

``lru_scan_chunked_ref``, the CPU model of the forward kernel's chunked
order (zero-carry chunks, their carries chained from the first chunk to
the last, each chunk again), is held against the plain version and
against the reference's oracle and Pallas kernel (interpret) at chunk
lengths 1, 7, 8 and 32, within 1e-5 of the largest |h| (f32: one extra
rounding per chunk boundary); its first chunk is bit for bit the plain
version's, and where h0 and a prefix of b are zero, or a is zero at a
chunk boundary, its zeros are exact.

``lru_scan_backward_chunked_ref``, the CPU model of the backward kernel's
chunked order (zero-carry chunks, then their carries from the last chunk to
the first, then each chunk again), is held against autograd through the
plain version and against ``jax.vjp`` of the reference's oracle at chunk
lengths 1, 7, 32 and T, within 1e-5 (f32: one extra rounding per chunk
boundary); where dh is zero from some step on, or a is zero at a chunk
boundary, its zeros are exact.

The CUDA kernels themselves are held against the plain version on the
card by the ``gpu`` cases of ``tests/test_torch_rules.py`` (the card's
machine has no JAX, and this file imports it) and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.kernels.lru_scan.kernel import lru_scan_kernel
from repro.kernels.lru_scan.ref import lru_scan_ref as r_lru_scan_ref
from repro.models import recurrent as r_rec
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.kernels.lru_scan import ops
from repro_torch.kernels.lru_scan.ref import (
    lru_scan_backward_chunked_ref, lru_scan_chunked_ref, lru_scan_ref)
from repro_torch.models import recurrent as rec

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)


def _inputs(B, T, R, seed, dtype="float32", h0=True):
    rng = np.random.RandomState(seed)
    arrs = [rng.uniform(0.0, 1.0, (B, T, R)), rng.randn(B, T, R)]
    if h0:
        arrs.append(rng.randn(B, R))
    return [np.asarray(jnp.asarray(a, getattr(jnp, dtype))) for a in arrs]


def _port(arrs):
    return [state_from_numpy(a, "cpu") for a in arrs]


@pytest.mark.parametrize("B,T,R", [(1, 1, 5), (2, 7, 100), (2, 64, 33)])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_plain_k7_matches_reference_ref(B, T, R, h0):
    arrs = _inputs(B, T, R, seed=T * R, h0=h0)
    want = r_lru_scan_ref(*(jnp.asarray(a) for a in arrs))
    got = ops.lru_scan(*_port(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_k7_matches_reference_kernel(dtype, tol):
    """The Pallas kernel carries h in f32 whatever the input dtype, as the
    port's plain version does; T and R on its tile grid (8 | T, 128 | R)."""
    arrs = _inputs(2, 16, 256, seed=3, dtype=dtype)
    want = lru_scan_kernel(*(jnp.asarray(a) for a in arrs), block_t=8,
                           interpret=True)
    got = ops.lru_scan(*_port(arrs))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_plain_k7_gradients_match_reference_vjp(h0):
    arrs = _inputs(2, 19, 40, seed=11, h0=h0)
    ct = np.random.RandomState(12).randn(2, 19, 40).astype(np.float32)
    _, vjp = jax.vjp(r_lru_scan_ref, *(jnp.asarray(a) for a in arrs))
    want = vjp(jnp.asarray(ct))
    ins = [t.requires_grad_() for t in _port(arrs)]
    got = torch.autograd.grad(ops.lru_scan(*ins), ins, torch.from_numpy(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def _count_ops(monkeypatch):
    """Counts the calls of the entry's two custom ops by name."""
    calls = {}
    for name in ('scan_op', 'scan_backward_op'):
        op = getattr(ops, name)

        def counted(*args, op=op, name=name):
            calls[name] = calls.get(name, 0) + 1
            return op(*args)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_autograd_function_under_torch_func(monkeypatch, h0):
    """``LruScan`` on CPU tensors (the custom ops' plain implementations):
    its gradient equals autograd's through the plain version under plain
    autograd, ``torch.func.vjp`` and a ``torch.func.grad`` nested in a
    vjp, and every forward and backward goes through the custom ops."""
    a, b, *rest = (t.double() for t in _port(_inputs(2, 9, 6, seed=5,
                                                     h0=h0)))
    args = (a, b) + tuple(rest)

    def loss(fn):
        return lambda a, b, h0=None: (fn(a, b, h0) ** 2).sum()

    argnums = tuple(range(len(args)))
    want = torch.func.grad(loss(lru_scan_ref), argnums=argnums)(*args)
    kernel_loss = loss(ops.LruScan.apply)
    calls = _count_ops(monkeypatch)
    got_func = torch.func.grad(kernel_loss, argnums=argnums)(*args)
    _, vjp = torch.func.vjp(kernel_loss, *args)
    got_vjp = vjp(torch.ones((), dtype=torch.float64))

    def nested(*x):   # a train step's gradient inside the scrutiny's vjp,
        torch.func.grad(kernel_loss)(*x)   # not reaching the output
        return kernel_loss(*x)

    _, vjp2 = torch.func.vjp(nested, *args)
    got_nested = vjp2(torch.ones((), dtype=torch.float64))
    live = [t.clone().requires_grad_() for t in args]
    got_plain = torch.autograd.grad(kernel_loss(*live), live)
    for got in (got_func, got_vjp, got_plain, got_nested):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    assert calls == {"scan_op": 5, "scan_backward_op": 5}

    def second(*x):   # a second derivative through the kernel raises
        g = torch.func.grad(kernel_loss)(*x)
        return (g * x[0]).sum()

    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.func.grad(second)(*args)


def test_entry_refuses_mixed_devices():
    x = torch.ones(1, 2, 3)
    with pytest.raises(RuntimeError, match="not a mix"):
        ops.lru_scan(x, x.to("meta"))


def test_rglru_train_matches_reference_associative_scan():
    """The RG-LRU block (train path, f32 reduced recurrentgemma-2b) with
    the reference's parameters: the port scans in order, the reference
    with ``lax.associative_scan``."""
    rcfg = r_get_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    rp = r_rec.init_rglru(rcfg, jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.RandomState(1).randn(2, 37, cfg.d_model).astype(np.float32)
    want = np.asarray(r_rec.rglru_train(rcfg, rp, jnp.asarray(x)))
    got = rec.rglru_train(cfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


CHUNK_T = (1, 31, 100, 256)
CHUNKS = ("1", "7", "32", "T")


def _chunk_case(T, chunk, h0):
    """a, b, h0 (or None), the forward's h and a cotangent dh (torch, f32),
    and the chunk length (``"T"``: one chunk)."""
    arrs = _inputs(2, T, 24, seed=T + 3, h0=h0)
    dh = np.random.RandomState(T + 4).randn(2, T, 24).astype(np.float32)
    a, b, *rest = _port(arrs)
    h0_t = rest[0] if h0 else None
    h = lru_scan_ref(a, b, h0_t)
    return arrs, dh, (a, b, h0_t, h), T if chunk == "T" else int(chunk)


@pytest.mark.parametrize("T", CHUNK_T)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_chunked_backward_matches_autograd(T, chunk, h0):
    _, dh, (a, b, h0_t, h), L = _chunk_case(T, chunk, h0)
    ins = [t.clone().requires_grad_() for t in [a, b] + ([h0_t] if h0
                                                         else [])]
    want = torch.autograd.grad(lru_scan_ref(*ins), ins, torch.from_numpy(dh))
    da, db, dh0 = lru_scan_backward_chunked_ref(a, h, h0_t,
                                                torch.from_numpy(dh), L)
    assert (dh0 is None) == (not h0)
    for g, w in zip((da, db) + ((dh0,) if h0 else ()), want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", CHUNK_T)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_chunked_backward_matches_reference_vjp(T, chunk, h0):
    arrs, dh, (a, _, h0_t, h), L = _chunk_case(T, chunk, h0)
    _, vjp = jax.vjp(r_lru_scan_ref, *(jnp.asarray(x) for x in arrs))
    want = vjp(jnp.asarray(dh))
    got = lru_scan_backward_chunked_ref(a, h, h0_t, torch.from_numpy(dh), L)
    assert len(want) == (3 if h0 else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("zero_from", [0, 5, 64, 99])
def test_chunked_backward_keeps_zeros_where_dh_is_zero_on(chunk, zero_from):
    """dh zero from step t on: da and db are exact zeros there (the carry
    out of those chunks is an exact 0, not a rounding of one)."""
    _, dh, (a, _, h0_t, h), _ = _chunk_case(100, "T", True)
    dh[:, zero_from:] = 0.0
    da, db, _ = lru_scan_backward_chunked_ref(a, h, h0_t,
                                              torch.from_numpy(dh), chunk)
    assert torch.count_nonzero(da[:, zero_from:]) == 0
    assert torch.count_nonzero(db[:, zero_from:]) == 0
    if zero_from:
        assert torch.count_nonzero(db[:, :zero_from]) > 0


@pytest.mark.parametrize("chunk", [7, 32])
def test_chunked_backward_with_a_zero_at_a_chunk_boundary(chunk):
    """a = 0 at the first step of a chunk cuts the carry there: before it,
    g is dh plus the carry of the steps up to the zero, exactly as the
    plain walk has it."""
    _, dh, (a, b, h0_t, _), _ = _chunk_case(100, "T", True)
    a = a.clone()
    a[:, chunk] = 0.0
    a[:, 3 * chunk] = 0.0
    h = lru_scan_ref(a, b, h0_t)
    ins = [t.clone().requires_grad_() for t in (a, b, h0_t)]
    want = torch.autograd.grad(lru_scan_ref(*ins), ins, torch.from_numpy(dh))
    got = lru_scan_backward_chunked_ref(a, h, h0_t, torch.from_numpy(dh),
                                        chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # db just before the cut is dh there plus nothing carried across it
    assert torch.equal(got[1][:, chunk - 1], torch.from_numpy(dh)[:, chunk - 1])


FWD_CHUNKS = (1, 7, 8, 32)


def _fwd_case(T, h0):
    """a, b, h0 (zeros where ``h0`` is False) as numpy f32 arrays, and the
    port's a, b and h0 (None without it)."""
    arrs = _inputs(2, T, 24, seed=T + 5, h0=True)
    if not h0:
        arrs[2] = np.zeros_like(arrs[2])
    a, b, h0_t = _port(arrs)
    return arrs, (a, b, h0_t if h0 else None)


def _close(got, want):
    """Within 1e-5 of the largest |h|: the chain's one rounding a chunk."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("T", CHUNK_T)
@pytest.mark.parametrize("chunk", FWD_CHUNKS)
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_chunked_forward_matches_plain_version(T, chunk, h0):
    _, (a, b, h0_t) = _fwd_case(T, h0)
    want = lru_scan_ref(a, b, h0_t)
    got = lru_scan_chunked_ref(a, b, h0_t, chunk)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("T", CHUNK_T)
@pytest.mark.parametrize("chunk", FWD_CHUNKS)
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
def test_chunked_forward_matches_reference(T, chunk, h0):
    """Against the reference's oracle and its Pallas kernel in interpret
    mode (which takes zeros for a missing h0)."""
    arrs, (a, b, h0_t) = _fwd_case(T, h0)
    got = lru_scan_chunked_ref(a, b, h0_t, chunk).numpy()
    ja, jb, jh0 = (jnp.asarray(x) for x in arrs)
    _close(got, r_lru_scan_ref(ja, jb, jh0 if h0 else None))
    _close(got, lru_scan_kernel(ja, jb, jh0, interpret=True))


@pytest.mark.parametrize("T", [1, 31, 100])
@pytest.mark.parametrize("chunk", FWD_CHUNKS)
def test_chunked_forward_first_chunk_is_the_plain_version(T, chunk):
    """The first chunk's carry in is h0 itself, and each step rounds
    a h and + b as the plain version does: bit for bit, in f32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        a, b, h0_t = _port(_inputs(2, T, 24, seed=T + 6, dtype=dtype))
        got = lru_scan_chunked_ref(a, b, h0_t, chunk)
        want = lru_scan_ref(a, b, h0_t)
        assert torch.equal(got[:, :chunk], want[:, :chunk]), dtype


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("zero_to", [1, 5, 64, 99])
def test_chunked_forward_keeps_zeros_where_b_is_zero_up_to(chunk, zero_to):
    """h0 zero and b zero up to step t: h is exactly 0 there (a chunk
    from a zero carry gives c^ = 0, and the chain Q 0 + 0 = 0)."""
    _, (a, b, _) = _fwd_case(100, False)
    b = b.clone()
    b[:, :zero_to] = 0.0
    h = lru_scan_chunked_ref(a, b, None, chunk)
    assert torch.count_nonzero(h[:, :zero_to]) == 0
    assert torch.count_nonzero(h[:, zero_to:]) > 0


@pytest.mark.parametrize("chunk", [7, 32])
def test_chunked_forward_with_a_zero_at_a_chunk_boundary(chunk):
    """a = 0 at the first step of a chunk cuts the carry there: from that
    step on, h is what a walk from h = 0 gives, exactly as the plain walk
    has it at that step."""
    _, (a, b, h0_t) = _fwd_case(100, True)
    a = a.clone()
    a[:, chunk] = 0.0
    a[:, 3 * chunk] = 0.0
    got = lru_scan_chunked_ref(a, b, h0_t, chunk)
    want = lru_scan_ref(a, b, h0_t)
    _close(got.numpy(), want.numpy())
    # h at the cut is b there, whatever came before
    assert torch.equal(got[:, chunk], b[:, chunk])
    assert torch.equal(got[:, 3 * chunk], b[:, 3 * chunk])
