"""The serving slice against the reference, on the CPU.

Reduced phi4-mini (dense GQA), gemma2-27b (window 32, softcaps, post-norm,
geglu, embedding scale) and qwen1.5-32b (qkv bias, untied head), with the
reference's parameters carried over by ``params_from_numpy`` and prompts
made with numpy from a seed:

- prefill logits and cache, and one ``decode_step``, match ``repro``'s;
- the port's prefill + decode agrees with its own full forward, as
  ``tests/test_decode_consistency.py`` checks the reference;
- ``Engine.generate`` with forced tokens gives the reference's logits;
- the KV-cache scrutiny reproduces ``BENCH_serve.json`` ``kv_table`` and
  the reference's masks bit for bit on the same engine state;
- given the same state and masks, the step directories (base + delta)
  are byte-identical and each package restores the other's;
- a restore continues decoding exactly.

Tolerances (f32 throughout): logits within 1e-5 absolute (|logits| < 2);
caches within 1e-5 of their largest magnitude (|k|, |v| reach ~9, and
every matmul sums in another order than XLA's).
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
from repro.configs import all_arch_names as r_all_arch_names
from repro.configs import get_config as r_get_config
from repro.core import ScrutinyConfig as RConfig
from repro.core import scrutinize as r_scrutinize
from repro.models import count_params as r_count_params
from repro.models import decode_step as r_decode_step
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import set_attn_impl
from repro.serve.engine import Engine as REngine
import repro_torch.checkpoint as TC
from repro_torch import Engine, ScrutinyConfig, get_config, scrutinize
from repro_torch import _tree
from repro_torch._tensors import to_host
from repro_torch.convert import (params_from_numpy, report_from_masks,
                                 state_from_numpy)
from repro_torch.configs import all_arch_names
from repro_torch.models import (count_params, decode_step, full_logits,
                                init_cache, init_params, prefill)

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["phi4-mini-3.8b", "gemma2-27b", "qwen1.5-32b"]
MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    """name → (reference cfg, reference params, port cfg, port params)."""
    made = {}

    def get(name):
        if name not in made:
            rcfg = r_get_config(name).reduced()
            rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
                jax.random.PRNGKey(0))
            np_params = _map(np.asarray, rparams)
            cfg = get_config(name).reduced()
            made[name] = (rcfg, rparams, cfg,
                          params_from_numpy(cfg, np_params, "cpu"))
        return made[name]

    return get


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _named(tree):
    return dict(_tree.flatten_with_names(tree)[0])


def _map(fn, tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(leaf) for _, leaf in named])


def _assert_close_scaled(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= 1e-5 * scale, what


# --------------------------------------------------------------------------
# configs and trees
# --------------------------------------------------------------------------

def test_config_registry_is_the_references():
    assert all_arch_names() == r_all_arch_names()
    for name in all_arch_names():
        for full in (True, False):
            t, r = get_config(name), r_get_config(name)
            if not full:
                t, r = t.reduced(), r.reduced()
            assert dataclasses.asdict(t) == dataclasses.asdict(r), name


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "olmoe-1b-7b",
                                  "whisper-tiny", "qwen2-vl-7b"])
def test_unported_families_raise(name):
    """The families the port once refused (MoE, MLA, encoder-decoder,
    M-RoPE) are served now: nothing raises, and an engine takes them
    (their parity with the reference: ``tests/test_torch_models_rest.py``
    and ``tests/test_torch_moe.py``)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert all(t.device.type == "cpu" for t in _named(cache).values())
    Engine(cfg, params, 16, device="cpu")


def test_foreign_parameter_trees_are_refused(models):
    rcfg, rparams, cfg, tparams = models("qwen1.5-32b")
    np_params = _map(np.asarray, rparams)
    del np_params["lm_head"]
    with pytest.raises(ValueError, match="init_params tree"):
        params_from_numpy(cfg, np_params, "cpu")
    with pytest.raises(ValueError, match="init_params"):
        Engine(get_config("phi4-mini-3.8b").reduced(), tparams, 16,
               device="cpu")


def _shapes(tree):
    return {n: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for n, l in _named(tree).items()}


@pytest.mark.parametrize("name", ARCHS + ["gemma-7b", "xlstm-125m",
                                          "recurrentgemma-2b", "olmoe-1b-7b",
                                          "deepseek-v3-671b", "whisper-tiny",
                                          "qwen2-vl-7b"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_and_cache_trees_match_reference(name, reduced):
    """Leaf names, shapes and dtypes of the parameters and the decode
    cache, and the parameter count, at reduced and at full size (shapes
    only: the meta device and ``jax.eval_shape``)."""
    cfg, rcfg = get_config(name), r_get_config(name)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    t_params = init_params(cfg, None, device="meta")
    r_params = jax.eval_shape(lambda k: r_init_params(rcfg, k),
                              jax.random.PRNGKey(0))
    assert _shapes(t_params) == _shapes(r_params)
    assert count_params(t_params) == r_count_params(r_params)
    t_cache = init_cache(cfg, 2, 48, device="meta")
    r_cache = jax.eval_shape(lambda: r_init_cache(rcfg, 2, 48))
    assert _shapes(t_cache) == _shapes(r_cache)


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,T,impl", [
    ("phi4-mini-3.8b", 40, "auto"),
    ("phi4-mini-3.8b", 40, "pallas"),      # the reference's K6, interpret
    ("gemma2-27b", 20, "auto"),            # window layers, zero-filled
    ("gemma2-27b", 40, "auto"),            # window layers, ring buffer
    ("qwen1.5-32b", 40, "auto"),
])
def test_prefill_and_decode_match_reference(models, name, T, impl):
    rcfg, rparams, cfg, tparams = models(name)
    toks = _tokens((2, T + 1), cfg.vocab, seed=T)
    set_attn_impl(impl)
    try:
        r_logits, r_cache = r_prefill(rcfg, rparams,
                                      {"tokens": jnp.asarray(toks[:, :T])},
                                      MAX_LEN)
    finally:
        set_attn_impl("auto")
    r_logits2, _ = r_decode_step(rcfg, rparams, r_cache,
                                 jnp.asarray(toks[:, T:]),
                                 jnp.asarray(T, jnp.int32))
    t_logits, t_cache = prefill(cfg, tparams,
                                {"tokens": torch.from_numpy(toks[:, :T])},
                                MAX_LEN)
    t_logits2, _ = decode_step(cfg, tparams, t_cache,
                               torch.from_numpy(toks[:, T:]),
                               torch.tensor(T, dtype=torch.int32))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_logits2.numpy(), np.asarray(r_logits2),
                               atol=1e-5, rtol=0)
    want, got = _named(r_cache), _named(t_cache)
    assert sorted(got) == sorted(want)
    for leaf in want:
        _assert_close_scaled(got[leaf].numpy(), want[leaf], leaf)


def _full_forward_logits(cfg, params, tokens):
    """The port's train-path forward → logits at every position."""
    return full_logits(cfg, params, {"tokens": tokens})


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_full_forward(models, name):
    """Prefill T tokens, decode token T: the logits equal the full forward
    over T + 1 tokens at position T (f32, sums in another order: 1e-4)."""
    _, _, cfg, tparams = models(name)
    T = 40                                 # past gemma2's reduced window 32
    toks = torch.from_numpy(_tokens((2, T + 1), cfg.vocab, seed=5))
    want = _full_forward_logits(cfg, tparams, toks)[:, T]
    _, cache = prefill(cfg, tparams, {"tokens": toks[:, :T]}, T + 8)
    got, _ = decode_step(cfg, tparams, cache, toks[:, T:],
                         torch.tensor(T, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_with_forced_tokens_matches_reference(models, name):
    rcfg, rparams, cfg, tparams = models(name)
    n = 5
    prompt = _tokens((2, 12), cfg.vocab, seed=7)
    forced = _tokens((2, n - 1), cfg.vocab, seed=8)
    reng = REngine(rcfg, rparams, MAX_LEN)
    r_logits, cache = reng._prefill(rparams, {"tokens": jnp.asarray(prompt)})
    want = [np.asarray(r_logits)]
    for i in range(n - 1):
        r_logits, cache = reng._step(rparams, cache,
                                     jnp.asarray(forced[:, i:i + 1]),
                                     jnp.asarray(12 + i, jnp.int32))
        want.append(np.asarray(r_logits))
    eng = Engine(cfg, tparams, MAX_LEN, device="cpu")
    toks, state, logits = eng.generate(
        {"tokens": torch.from_numpy(prompt)}, n,
        forced=torch.from_numpy(forced))
    np.testing.assert_allclose(logits.numpy(), np.stack(want), atol=1e-5,
                               rtol=0)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, n)
    assert torch.equal(toks, logits.argmax(-1).T.to(torch.int32))
    assert int(state["pos"]) == 12 + n - 1
    assert state["pos"].dtype == state["tokens"].dtype == torch.int32


def test_resume_fn_logits_are_the_engines_in_bf16(models):
    """``resume_fn`` runs the cache in f32 for the gradient's sake; the
    values it writes are computed in bf16 either way, so its logits equal
    the engine's own decode steps bit for bit."""
    _, _, cfg, tparams = models("gemma2-27b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    eng = Engine(cfg, tparams, MAX_LEN, device="cpu")
    state = eng.start({"tokens": torch.from_numpy(
        _tokens((2, 40), cfg.vocab, 4))})
    assert state["cache"]["seg0"]["u0"]["k"].dtype == torch.bfloat16
    got = eng.resume_fn(3)(state)["logits"]
    want = []
    for _ in range(3):
        logits, state = eng.decode(state)
        want.append(logits)
    assert torch.equal(got, torch.stack(want))


# --------------------------------------------------------------------------
# KV-cache scrutiny: BENCH_serve.json kv_table
# --------------------------------------------------------------------------

def _bench_kv_table():
    with open(ROOT / "BENCH_serve.json") as f:
        return json.load(f)["kv_table"]


@pytest.mark.parametrize("name,prompt", [("phi4-mini-3.8b", 8),
                                         ("phi4-mini-3.8b", 32),
                                         ("gemma2-27b", 8),
                                         ("gemma2-27b", 32)])
def test_kv_table_and_masks_match_reference(models, name, prompt):
    """``benchmarks/bench_kv_scrutiny.py:39-70``: batch 2, max_len 64,
    horizon 2, probes 2; the port's counts equal ``BENCH_serve.json`` and
    its masks equal the reference's on the same engine state."""
    rcfg, rparams, cfg, tparams = models(name)
    reng = REngine(rcfg, rparams, MAX_LEN)
    r_state = reng.start({"tokens": jnp.asarray(
        _tokens((2, prompt), cfg.vocab, seed=1))})
    r_rep = r_scrutinize(reng.resume_fn(2), r_state,
                         config=RConfig(probes=2))
    eng = Engine(cfg, tparams, MAX_LEN, device="cpu")
    state = state_from_numpy(_map(np.asarray, r_state), "cpu")
    rep = scrutinize(eng.resume_fn(2), state,
                     config=ScrutinyConfig(probes=2), device="cpu")
    assert sorted(rep.leaves) == sorted(r_rep.leaves)
    for leaf in r_rep.leaves:
        assert np.array_equal(rep[leaf].mask, r_rep[leaf].mask), leaf
    cache = [l for n, l in rep.leaves.items() if n.startswith("cache")]
    row = _bench_kv_table()[f"{name}@{prompt}"]
    assert sum(l.total for l in cache) == row["total"]
    assert sum(l.uncritical for l in cache) == row["uncritical"]


# --------------------------------------------------------------------------
# engine-state checkpoints: both packages, and a restart
# --------------------------------------------------------------------------

def _tree_bytes(d, step):
    sd = os.path.join(d, f"step_{step}")
    out = {}
    for f in sorted(os.listdir(sd)):
        with open(os.path.join(sd, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _probe(state, headroom, max_len, horizon):
    """The state scrutiny probes, ``headroom`` steps ahead (clamped), as
    ``serve/sessions.py:179-186`` does: the mask then covers the KV the
    next decode steps write, so delta saves may reuse it."""
    pos = min(int(state["pos"]) + headroom, max_len - horizon)
    return dict(state, pos=torch.tensor(pos, dtype=torch.int32))


def test_engine_checkpoints_byte_identical_and_cross_restore(models,
                                                              tmp_path):
    rcfg, rparams, cfg, _ = models("phi4-mini-3.8b")
    reng = REngine(rcfg, rparams, MAX_LEN)
    s1 = reng.start({"tokens": jnp.asarray(_tokens((2, 9), cfg.vocab, 2))})
    s2, _ = reng.step(s1)
    np1, np2 = (_map(np.asarray, s) for s in (s1, s2))
    r_rep = r_scrutinize(reng.resume_fn(2),
                         dict(s1, pos=s1["pos"] + 2),
                         config=RConfig(probes=2))
    masks = {n: np.asarray(l.mask) for n, l in r_rep.leaves.items()}
    t1, t2 = state_from_numpy(np1, "cpu"), state_from_numpy(np2, "cpu")
    t_rep = report_from_masks(masks, t1)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    level = dict(keep_n=3, max_chain=1)
    with RC.CheckpointManager([RC.Level(dr, **level)],
                              scrutiny_fn=lambda s: r_rep,
                              save_mode="device") as rm, \
            TC.CheckpointManager([TC.Level(dt, **level)],
                                 scrutiny_fn=lambda s: t_rep,
                                 save_mode="device", pipeline_engine="device",
                                 device="cpu") as tm:
        for step, (rs, ts) in enumerate(((s1, t1), (s2, t2)), start=1):
            rm.save(step, rs, block=True)
            tm.save(step, ts, block=True)
            assert _tree_bytes(dr, step) == _tree_bytes(dt, step), step
        assert tm.last_save_stats["levels"][dt]["kind"] == "delta"
    expect = {n: np.where(masks[n].reshape(v.shape), v, np.zeros((), v.dtype))
              for n, v in _named(np2).items()}
    like = _map(np.zeros_like, np2)
    with TC.CheckpointManager([TC.Level(dr, keep_n=0)],
                              device="cpu") as tm:
        step, got = tm.restore(state_from_numpy(like, "cpu"))
    assert step == 2
    for n, v in _named(got).items():
        assert to_host(v).tobytes() == expect[n].tobytes(), n
    with RC.CheckpointManager([RC.Level(dt, keep_n=0)]) as rm:
        step, got_r = rm.restore(_map(jnp.asarray, like))
    assert step == 2
    for n, v in _named(_map(np.asarray, got_r)).items():
        assert v.tobytes() == expect[n].tobytes(), n


def test_restore_continues_decoding_exactly(models, tmp_path):
    """Scrutinize (probe at pos + 2), save a base and a delta, restore into
    zeros, then decode 4 steps: the logits equal the uninterrupted engine's
    bit for bit, also with garbage in every uncritical slot."""
    _, _, cfg, tparams = models("phi4-mini-3.8b")
    eng = Engine(cfg, tparams, MAX_LEN, device="cpu")
    state = eng.start({"tokens": torch.from_numpy(
        _tokens((2, 10), cfg.vocab, 3))})
    for _ in range(2):
        state, _ = eng.step(state)
    horizon = 2
    rep = scrutinize(eng.resume_fn(horizon),
                     _probe(state, 2, MAX_LEN, horizon),
                     config=ScrutinyConfig(probes=2), device="cpu")
    d = str(tmp_path / "c")
    with TC.CheckpointManager([TC.Level(d, keep_n=3, max_chain=2)],
                              scrutiny_fn=lambda s: rep, save_mode="device",
                              restore_mode="device", pipeline_engine="device",
                              device="cpu") as mgr:
        mgr.save(1, state, block=True)
        state, _ = eng.step(state)
        mgr.save(2, state, block=True)
        assert mgr.last_save_stats["levels"][d]["kind"] == "delta"
        step, restored = mgr.restore(_map(torch.zeros_like, state))
    assert step == 2
    masks = {n: torch.from_numpy(np.asarray(l.mask))
             for n, l in rep.leaves.items()}

    def continuation(s):
        out = []
        for _ in range(4):
            logits, s = eng.decode(s)
            out.append(logits)
        return torch.stack(out)

    want = continuation(state)
    assert torch.equal(continuation(restored), want)
    gen = torch.Generator().manual_seed(0)
    leaves = _named(restored)
    for n, m in masks.items():
        if n.startswith("cache"):
            flat = leaves[n].view(-1)
            flat[~m] = torch.randn(int((~m).sum()), generator=gen)
    assert torch.equal(continuation(restored), want)
    leaves["cache/seg0/u0/k"].view(-1)[torch.nonzero(
        masks["cache/seg0/u0/k"])[:8, 0]] += 1.0
    assert not torch.equal(continuation(restored), want)
