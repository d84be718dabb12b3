"""K6, flash attention: the port's entry against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.flash_attention``
runs K6's plain version; it must agree with the reference's Pallas kernel
(interpret mode) and with ``flash_attention_ref`` over the cases of
``tests/test_kernels.py``, and with ``flash_attention_ref`` at ragged T.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32 (sums in
another order), 2e-2 in bf16 (one rounding of the output).

The backward: the plain path's gradients (autograd through
``flash_attention_ref``) equal ``jax.grad`` of the reference's
``flash_attention_ref``, which is what the reference trains with (through
XLA; K6 has no backward there), within 2e-5 of each gradient's largest
magnitude in f32.  The autograd Function that carries the kernels' custom
ops (``repro_torch::flash_attention`` and its backward; on CPU tensors
their implementations are the plain version) is driven under plain
autograd and ``torch.func.vjp`` (the scrutiny), its calls counted at the
dispatcher.

The controls in K6's order (``ref.flash_attention_tiled`` and
``ref.TiledAttention``, over the kernels' key tiles in f32), which
``chip_smoke.py`` bounds K6's distance with, compute the reference's
function: forward against ``flash_attention_ref`` and gradients under
``torch.func.vjp`` against ``jax.grad`` through it, 2e-5 in f32 and 2e-2
for bf16 inputs (of each gradient's largest magnitude).

The CUDA kernels themselves are held against the plain version on the
card by the ``gpu`` cases of ``tests/test_torch_rules.py`` (the card's
machine has no JAX, and this file imports it) and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as r_ops
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.convert import state_from_numpy
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as ref_t
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref as flash_ref_t)

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

FA_CASES = [
    # (B, T, H, K, D, window, causal, cap, dtype) as tests/test_kernels.py
    (1, 128, 4, 4, 64, None, True, None, "float32"),
    (2, 256, 8, 2, 64, None, True, None, "float32"),     # GQA 4:1
    (1, 256, 4, 1, 128, None, True, None, "float32"),    # MQA
    (1, 256, 4, 4, 64, 128, True, None, "float32"),      # sliding window
    (1, 256, 4, 2, 64, None, True, 50.0, "float32"),     # softcap (gemma2)
    (1, 256, 4, 2, 64, 128, True, 50.0, "bfloat16"),     # all combined bf16
    (2, 128, 2, 2, 256, None, True, None, "float32"),    # gemma-7b head_dim
    (1, 128, 4, 4, 64, None, False, None, "float32"),    # non-causal (enc)
]


def _qkv(B, T, H, K, D, dtype, seed, Dv=None):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, T, H, D), rng.randn(B, T, K, D),
            rng.randn(B, T, K, Dv or D)]
    return [np.asarray(jnp.asarray(a, getattr(jnp, dtype))) for a in arrs]


def _port(np_qkv, **kw):
    q, k, v = (state_from_numpy(a, "cpu") for a in np_qkv)
    return ops.flash_attention(q, k, v, **kw).float().numpy()


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_k6_matches_reference_kernel(case):
    B, T, H, K_, D, window, causal, cap, dtype = case
    np_qkv = _qkv(B, T, H, K_, D, dtype, seed=0)
    jq, jk, jv = (jnp.asarray(a) for a in np_qkv)
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    want_kernel = flash_attention_kernel(jq, jk, jv, interpret=True, **kw)
    want_ref = flash_attention_ref(jq, jk, jv, **kw)
    got = _port(np_qkv, **kw)
    tol = _tol(dtype)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("T", [1, 17, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_t_matches_reference_ref(T, causal, dtype):
    np_qkv = _qkv(2, T, 4, 2, 32, dtype, seed=T, Dv=16)
    kw = dict(window=None, causal=causal, scale=32 ** -0.5, attn_cap=None)
    want = flash_attention_ref(*(jnp.asarray(a) for a in np_qkv), **kw)
    np.testing.assert_allclose(_port(np_qkv, **kw),
                               np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_non_causal_ragged_t_follows_ref_not_padded_kernel():
    """The reference's entry pads T=200 to 256 with zero keys and masks them
    only through the causal test, so a non-causal call attends to them
    (ROADMAP Queue 3).  The port masks k >= Tk itself and matches
    ``flash_attention_ref``."""
    np_qkv = _qkv(1, 200, 4, 4, 64, "float32", seed=1)
    jq, jk, jv = (jnp.asarray(a) for a in np_qkv)
    want = np.asarray(flash_attention_ref(jq, jk, jv, causal=False))
    padded = np.asarray(r_ops.flash_attention(jq, jk, jv, causal=False,
                                              interpret=True))
    got = _port(np_qkv, causal=False)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert np.abs(padded - want).max() > 1e-2


def test_plain_version_launches_nothing():
    K.reset_launches()
    _port(_qkv(1, 33, 4, 2, 16, "float32", seed=3), window=8, attn_cap=5.0)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


# (B, T, H, K, D, Dv, window, causal, cap)
GRAD_CASES = [
    (2, 40, 4, 2, 16, 16, None, True, None),     # GQA 2:1
    (1, 33, 4, 1, 32, 32, None, True, None),     # MQA (recurrentgemma)
    (1, 50, 2, 2, 16, 16, 8, True, None),        # sliding window
    (2, 30, 4, 2, 16, 16, None, True, 5.0),      # softcap
    (1, 45, 6, 3, 24, 8, 16, True, 5.0),         # Dv != D, all combined
    (1, 20, 2, 1, 16, 16, None, False, None),    # non-causal
]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_gradients_match_reference_grad(case):
    B, T, H, K_, D, Dv, window, causal, cap = case
    np_qkv = _qkv(B, T, H, K_, D, "float32", seed=T, Dv=Dv)
    ct = np.random.RandomState(T + 1).randn(B, T, H, Dv).astype(np.float32)
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    want = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(flash_attention_ref(q, k, v, **kw) * ct),
        argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in np_qkv))
    live = [state_from_numpy(a, "cpu").requires_grad_() for a in np_qkv]
    got = torch.autograd.grad(ops.flash_attention(*live, **kw), live,
                              torch.from_numpy(ct))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=2e-5 * np.abs(w).max(), rtol=0)


def _count_ops(monkeypatch):
    """Counts the calls of the entry's two custom ops by name."""
    calls = {}
    for name in ('attention_op', 'attention_backward_op'):
        op = getattr(ops, name)

        def counted(*args, op=op, name=name):
            calls[name] = calls.get(name, 0) + 1
            return op(*args)

        monkeypatch.setattr(ops, name, counted)
    return calls


def test_autograd_function_under_torch_func(monkeypatch):
    """``FlashAttention`` on CPU tensors (the custom ops' plain
    implementations): its gradient equals autograd's through the plain
    version, under plain autograd and ``torch.func.vjp``, and the forward
    and backward go through the custom ops."""
    q, k, v = (state_from_numpy(a, "cpu").double()
               for a in _qkv(2, 21, 4, 2, 8, "float32", seed=9, Dv=6))
    kw = dict(scale=0.3, causal=True, window=6, attn_cap=4.0)

    def loss(q, k, v):
        o = ops.FlashAttention.apply(q, k, v, kw["scale"], kw["causal"],
                                     kw["window"], kw["attn_cap"])[0]
        return (o ** 2).sum()

    want = torch.func.grad(
        lambda q, k, v: (flash_ref_t(q, k, v, **kw) ** 2).sum(),
        argnums=(0, 1, 2))(q, k, v)
    calls = _count_ops(monkeypatch)
    _, vjp = torch.func.vjp(loss, q, k, v)
    got_vjp = vjp(torch.ones((), dtype=torch.float64))
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    got_plain = torch.autograd.grad(loss(*live), live)
    for got in (got_vjp, got_plain):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-9, rtol=1e-9)
    assert calls == {"attention_op": 2, "attention_backward_op": 2}


def test_card_route_writes_lse_only_for_autograd(monkeypatch):
    """Only a call that autograd can reach asks the forward op for the row
    log-sum-exp (which the card writes for the backward): one under
    ``no_grad`` or on inputs that need no gradient (the serving prefill)
    runs the forward op alone; one under ``torch.func.vjp`` or on inputs
    that require grad goes through ``FlashAttention``.  Driven on CPU
    tensors, the forward op's ``with_lse`` argument recorded."""
    q, k, v = (state_from_numpy(a, "cpu")
               for a in _qkv(1, 9, 2, 1, 8, "float32", seed=3))
    args = (0.3, True, None, None)
    want = flash_ref_t(q, k, v, scale=0.3)
    asked = []
    op = ops.attention_op

    def forward(*a):
        asked.append(a[7])
        return op(*a)

    monkeypatch.setattr(ops, "attention_op", forward)
    with torch.no_grad():
        live = [t.clone().requires_grad_() for t in (q, k, v)]
        got = [ops._route(*live, *args),
               torch.func.vjp(lambda q, k, v: ops._route(q, k, v, *args),
                              q, k, v)[0]]
    got.append(ops._route(q, k, v, *args))
    got.append(ops._route(*live, *args))
    assert asked == [False, True, False, True]
    for o in got:
        torch.testing.assert_close(o, want, atol=0, rtol=0)



# The controls in K6's order.  (B, T, H, K, D, Dv, window, causal, cap,
# dtype): T past one key tile with a ragged last tile, GQA and MQA, the
# window, the softcap and Dv != D, non-causal, and bf16 inputs.
TILED_CASES = [
    (1, 150, 4, 2, 32, 32, None, True, None, "float32"),
    (1, 130, 4, 1, 16, 8, 40, True, 5.0, "float32"),
    (2, 70, 2, 2, 16, 16, None, False, None, "float32"),
    (1, 150, 4, 2, 32, 32, 50, True, 30.0, "bfloat16"),
]


def test_tiled_control_follows_the_kernels_tiles():
    assert ref_t.FWD_KEY_TILE == 64 and ref_t.BWD_KEY_TILE == 64


@pytest.mark.parametrize("case", TILED_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tiled_control_forward_matches_reference(case):
    B, T, H, K_, D, Dv, window, causal, cap, dtype = case
    np_qkv = _qkv(B, T, H, K_, D, dtype, seed=T + 7, Dv=Dv)
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    want = np.asarray(flash_attention_ref(*(jnp.asarray(a) for a in np_qkv),
                                          **kw), np.float32)
    q, k, v = (state_from_numpy(a, "cpu") for a in np_qkv)
    tol = _tol(dtype)
    got = ref_t.flash_attention_tiled(q, k, v, **kw)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    o32, lse = ref_t.flash_attention_tiled(q, k, v, stats=True, **kw)
    np.testing.assert_allclose(o32.numpy(), want, atol=tol, rtol=tol)
    # lse is the row log-sum-exp of the masked scores
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     k.float().repeat_interleave(H // K_, 2)) * kw["scale"]
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qi, ki = torch.arange(T)[:, None], torch.arange(T)[None, :]
    ok = (qi >= ki) if causal else torch.ones(T, T, dtype=torch.bool)
    if window is not None:
        ok &= qi - ki < window
    torch.testing.assert_close(
        lse, torch.logsumexp(s.masked_fill(~ok, -torch.inf), -1),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", TILED_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tiled_control_gradients_match_reference_grad(case):
    B, T, H, K_, D, Dv, window, causal, cap, dtype = case
    np_qkv = _qkv(B, T, H, K_, D, dtype, seed=T + 8, Dv=Dv)
    ct = np.asarray(jnp.asarray(
        np.random.RandomState(T + 9).randn(B, T, H, Dv),
        getattr(jnp, dtype)))
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    want = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum((flash_attention_ref(q, k, v, **kw)
                                 * ct).astype(jnp.float32)),
        argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in np_qkv))
    q, k, v = (state_from_numpy(a, "cpu") for a in np_qkv)
    _, vjp = torch.func.vjp(
        lambda q, k, v: ref_t.tiled_attention(q, k, v, **kw), q, k, v)
    got = vjp(state_from_numpy(ct, "cpu"))
    tol = _tol(dtype)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == q.dtype
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=tol * np.abs(w).max(), rtol=tol)
