"""K6, flash attention: the port's entry against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.flash_attention``
runs K6's plain version; it must agree with the reference's Pallas kernel
(interpret mode) and with ``flash_attention_ref`` over the cases of
``tests/test_kernels.py``, and with ``flash_attention_ref`` at ragged T.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32 (sums in
another order), 2e-2 in bf16 (one rounding of the output).

The CUDA kernel itself is held against the plain version on the card by
the ``gpu`` case of ``tests/test_torch_rules.py`` (the card's machine has
no JAX, and this file imports it) and by ``chip_smoke.py``.
"""

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
    q, k, v = (state_from_numpy(a) for a in np_qkv)
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
    assert K.LAUNCHES == {"flash_attention": 0}
