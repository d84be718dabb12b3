"""The rest of the model families against the reference, on the CPU:
MLA + MoE (deepseek-v3-671b), the encoder-decoder (whisper-tiny) and
M-RoPE with a patch-embedding prefix (qwen2-vl-7b).

Reduced configs (f32), the reference's parameters carried over by
``params_from_numpy`` (``test_torch_serve.py``'s ``models`` fixture and
helpers), tokens, frames and patch embeddings made with numpy from a seed:

- prefill logits and caches, and one ``decode_step``, match ``repro``'s;
- the port's prefill + decode agrees with its own full forward
  (``full_logits``), as ``tests/test_decode_consistency.py`` checks the
  reference (olmoe-1b-7b too);
- ``loss_fn`` (MoE with its training capacity, plus the aux loss) and its
  gradients match ``jax.value_and_grad`` of the reference's, as
  ``tests/test_models_smoke.py`` runs it;
- the engine's KV-cache masks (``resume_fn(2)``, 2 probes) equal the
  reference's bit for bit on the same engine state;
- the reference's VLM engine fault: ``Engine.start`` sets ``pos`` to the
  text length T, so its first decode step overwrites cache slot T (which
  holds position T of the patch-prefixed sequence), attends to T + 1
  slots, and departs from the full forward by more than 1;
  the port's engine starts at P + T and agrees within 1e-5.

Tolerances (f32): logits within 1e-5 absolute; caches within 1e-5 of their
largest magnitude; prefill + decode against the full forward 1e-4; the
loss within 1e-5 relative and gradients within 1e-4 of each leaf's largest
magnitude, floored at 1 (as ``tests/test_torch_train.py``).

The deepseek loss batch is one in which no row of the MoE layer overflows
the last expert's capacity: there the reference zeroes that expert's last
kept slot (its fault, held in ``tests/test_torch_moe.py`` and ROADMAP
Queue 3) and the port does not, so the losses would differ by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScrutinyConfig as RConfig
from repro.core import scrutinize as r_scrutinize
from repro.models import loss_fn as r_loss_fn
from repro.models import prefill as r_prefill
from repro.serve.engine import Engine as REngine
from repro_torch import Engine, ScrutinyConfig, get_config, scrutinize
from repro_torch.convert import state_from_numpy
from repro_torch.models import (decode_step, full_logits, init_params,
                                loss_fn, moe, prefill)
from repro_torch.train.step import loss_and_grads
from test_torch_serve import (MAX_LEN, _assert_close_scaled, _map, _named,
                              _tokens, models)

ARCHS = ["deepseek-v3-671b", "whisper-tiny", "qwen2-vl-7b"]
P = 4                        # patch embeddings ahead of a VLM's text

assert models                # the fixture, used by name below


def _batch(cfg, T, seed, extra_tokens=0):
    """numpy batch: tokens (2, T + extra_tokens), and frames (whisper) or
    patch embeddings with their (B, P + T, 3) M-RoPE positions
    (qwen2-vl: the temporal axis counts along the sequence, the height
    and width axes run over a 2 x 2 patch grid, then follow the text)."""
    rng = np.random.RandomState(seed)
    b = {"tokens": _tokens((2, T + extra_tokens), cfg.vocab, seed)}
    if cfg.enc_dec:
        b["frames"] = rng.randn(2, cfg.encoder_len,
                                cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.randn(2, P, cfg.d_model).astype(np.float32)
        L = P + T + extra_tokens
        t = np.arange(L)
        hw = np.concatenate([np.arange(P) // 2, t[P:]]), \
            np.concatenate([np.arange(P) % 2, t[P:]])
        b["positions"] = np.broadcast_to(
            np.stack([t, *hw], -1), (2, L, 3)).astype(np.int32)
    return b


def _head(batch, T):
    """The batch's first T text tokens (positions cut to P + T)."""
    out = dict(batch, tokens=batch["tokens"][:, :T])
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :P + T]
    return out


def _torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _length(cfg, T):
    return T + (P if cfg.family == "vlm" else 0)


_ENGINES = {}


def _r_engine(models, name):
    """The reference's engine for ``name``, one a module: its jitted
    prefill and step compile once."""
    if name not in _ENGINES:
        rcfg, rparams, _, _ = models(name)
        _ENGINES[name] = REngine(rcfg, rparams, MAX_LEN)
    return _ENGINES[name]


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(models, name):
    rcfg, rparams, cfg, tparams = models(name)
    T = 12
    full = _batch(cfg, T, seed=T, extra_tokens=1)
    batch = _head(full, T)
    pos = _length(cfg, T)
    reng = _r_engine(models, name)
    r_logits, r_cache = reng._prefill(rparams, _jax(batch))
    r_logits2, _ = reng._step(rparams, r_cache,
                              jnp.asarray(full["tokens"][:, T:]),
                              jnp.asarray(pos, jnp.int32))
    t_logits, t_cache = prefill(cfg, tparams, _torch(batch), MAX_LEN)
    t_logits2, _ = decode_step(cfg, tparams, t_cache,
                               torch.from_numpy(full["tokens"][:, T:]),
                               torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_logits2.numpy(), np.asarray(r_logits2),
                               atol=1e-5, rtol=0)
    want, got = _named(r_cache), _named(t_cache)
    assert sorted(got) == sorted(want)
    for leaf in want:
        _assert_close_scaled(got[leaf].numpy(), want[leaf], leaf)


@pytest.mark.parametrize("name", ARCHS + ["olmoe-1b-7b"])
def test_decode_matches_full_forward(name):
    """Prefill T tokens, decode token T: the logits equal the full forward
    over T + 1 tokens at text position T (the port's own parameters from
    a seed)."""
    cfg = get_config(name).reduced()
    tparams = init_params(cfg, torch.Generator().manual_seed(0))
    T = 12
    full = _torch(_batch(cfg, T, seed=5, extra_tokens=1))
    want = full_logits(cfg, tparams, full)[:, T]
    _, cache = prefill(cfg, tparams, _torch(_head(
        {k: v.numpy() for k, v in full.items()}, T)), T + P + 8)
    got, _ = decode_step(cfg, tparams, cache, full["tokens"][:, T:],
                         torch.tensor(_length(cfg, T), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def _last_expert_overflows(cfg, params, batch) -> bool:
    """Whether the training capacity drops a slot of the last expert in
    some row of some MoE layer of the port's loss on ``batch``."""
    seen, real = [], moe.apply_moe

    def spy(cfg_, p, x, **kw):
        seen.append((p, x))
        return real(cfg_, p, x, **kw)

    moe.apply_moe = spy
    try:
        with torch.no_grad():
            loss_fn(cfg, params, batch)
    finally:
        moe.apply_moe = real
    m = cfg.moe
    for p, x in seen:
        T = x.shape[1]
        C = max(1, int(T * m.top_k / m.num_experts * moe.CAPACITY_FACTOR))
        top = moe.top_k(torch.softmax(x @ p["router"], -1), m.top_k)[1]
        if ((top.reshape(x.shape[0], -1) == m.num_experts - 1).sum(1)
                > C).any():
            return True
    return False


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(models, name):
    rcfg, rparams, cfg, tparams = models(name)
    T = 24
    b = _batch(cfg, T, seed=1)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    b["mask"] = (np.random.RandomState(2).rand(2, T) < 0.8).astype(
        np.float32)
    t_batch = _torch(b)
    if cfg.moe is not None:
        assert not _last_expert_overflows(cfg, tparams, t_batch)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_loss_fn(rcfg, p, _jax(b))))(rparams)
    t_loss, t_grads = loss_and_grads(cfg, tparams, t_batch)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)
    want, got = _named(r_grads), _named(t_grads)
    assert sorted(got) == sorted(want)
    for leaf in want:
        g, w = np.asarray(got[leaf], np.float32), np.asarray(want[leaf])
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, leaf


@pytest.mark.parametrize("name", ARCHS)
def test_kv_masks_match_reference(models, name):
    """The reference engine's state after its prefill, ``pos`` set to the
    prefilled length (the port's rule): ``resume_fn(2)`` with 2 probes in
    both packages gives the same masks; the self-attention (or latent)
    cache is critical exactly below ``pos`` (the two steps write slots
    pos and pos + 1 before they read them), whisper's cross K/V in
    full."""
    rcfg, rparams, cfg, tparams = models(name)
    T = 12
    batch = _batch(cfg, T, seed=1)
    reng = _r_engine(models, name)
    r_state = dict(reng.start(_jax(batch)),
                   pos=jnp.asarray(_length(cfg, T), jnp.int32))
    r_rep = r_scrutinize(reng.resume_fn(2), r_state,
                         config=RConfig(probes=2))
    eng = Engine(cfg, tparams, MAX_LEN, device="cpu")
    state = state_from_numpy(_map(np.asarray, r_state), "cpu")
    rep = scrutinize(eng.resume_fn(2), state,
                     config=ScrutinyConfig(probes=2), device="cpu")
    assert sorted(rep.leaves) == sorted(r_rep.leaves)
    for leaf in r_rep.leaves:
        assert np.array_equal(rep[leaf].mask, r_rep[leaf].mask), leaf
    crit = _length(cfg, T)
    for leaf, lr in rep.leaves.items():
        if leaf.endswith(("/xk", "/xv")):
            assert lr.all_critical, leaf
        elif leaf.startswith("cache/"):
            m = lr.mask.reshape(lr.shape)
            want = np.arange(lr.shape[2]) < crit
            assert (m == want.reshape((1, 1, -1) + (1,) * (m.ndim - 3))
                    ).all(), leaf


def test_vlm_engine_starts_after_the_patches(models):
    """Reduced qwen2-vl, B=2, T=12 text tokens, P=4 patches, max_len 32:
    the reference's engine decodes token T at ``pos`` = T, over the cache
    slot of patch-prefixed position T, and departs from its own full
    forward at text position T by more than 1; the port's engine starts
    at P + T and agrees with that forward within 1e-5."""
    rcfg, rparams, cfg, tparams = models("qwen2-vl-7b")
    T, max_len = 12, 32
    full = _batch(cfg, T, seed=9, extra_tokens=1)
    full.pop("positions")                  # the engines' arange positions
    head = dict(full, tokens=full["tokens"][:, :T])
    want = np.asarray(r_prefill(rcfg, rparams, _jax(full), max_len)[0])
    reng = REngine(rcfg, rparams, max_len)
    s = reng.start(_jax(head))
    assert int(s["pos"]) == T
    r_got, _ = reng._step(rparams, s["cache"],
                          jnp.asarray(full["tokens"][:, T:]), s["pos"])
    assert float(np.abs(np.asarray(r_got) - want).max()) > 1.0
    eng = Engine(cfg, tparams, max_len, device="cpu")
    st = eng.start(_torch(head))
    assert int(st["pos"]) == P + T
    got, _ = eng.decode(st, torch.from_numpy(full["tokens"][:, T:]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
