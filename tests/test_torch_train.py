"""The training slice against the reference, on the CPU.

Reduced recurrentgemma-2b (RG-LRU + local MQA), xlstm-125m (mLSTM/sLSTM)
and phi4-mini-3.8b (dense GQA), f32, with the reference's parameters
carried over by ``params_from_numpy`` and tokens made with numpy from a
seed:

- the three recurrent cells (train, prefill state, decode step) match
  ``repro.models.recurrent``;
- ``loss_fn`` and its gradients match ``jax.value_and_grad`` of the
  reference's;
- one AdamW and one Adafactor update match the reference's;
- the data pipeline keeps the reference's leaves and ring-buffer rules;
- the AD scrutiny of a training state after one step gives the
  reference's masks bit for bit, ``opt/mu`` and ``opt/nu`` all uncritical
  (the reference's one-step-horizon fault, ROADMAP Queue 3);
- prefill + decode agrees with the full forward for the r/m/s flavours,
  as ``tests/test_decode_consistency.py`` checks the reference;
- ``repro_torch.launch.train.main`` on the CPU restarts exactly;
- the allocating entry points default to the card.

Tolerances (f32): the loss within 1e-5 relative; every other tensor
within 1e-4 (gradients: the loss is summed in another order and the
RG-LRU scanned in another association order) or 1e-5 (forward values, as
``tests/test_torch_serve.py``) of its largest magnitude, floored at 1;
optimizer updates within 1e-6.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import scrutinize as r_scrutinize
from repro.data import pipeline as r_dp
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.models import model as r_model
from repro.models import recurrent as r_rec
from repro.train import optim as r_optim
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import _tree, scrutinize
from repro_torch._tensors import resolve_device
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.data import pipeline as dp
from repro_torch.launch import train as launch
from repro_torch.models import (decode_step, init_cache, init_params,
                                loss_fn, prefill)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import recurrent as rec
from repro_torch.train import optim
from repro_torch.train.step import loss_and_grads, make_train_step

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

ARCHS = ["recurrentgemma-2b", "xlstm-125m", "phi4-mini-3.8b"]


def _named(tree):
    return dict(_tree.flatten_with_names(tree)[0])


def _map(fn, tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(leaf) for _, leaf in named])


def _close(got, want, what, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |Δ| {err} > {tol} x {scale}"


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def models():
    """name → (reference cfg, reference params, port cfg, port params)."""
    made = {}

    def get(name):
        if name not in made:
            rcfg = r_get_config(name).reduced()
            rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
                jax.random.PRNGKey(0))
            cfg = get_config(name).reduced()
            made[name] = (rcfg, rparams, cfg, params_from_numpy(
                cfg, _map(np.asarray, rparams), "cpu"))
        return made[name]

    return get


# --------------------------------------------------------------------------
# the recurrent cells
# --------------------------------------------------------------------------

CELLS = {
    "r": (r_rec.init_rglru, r_rec.rglru_train, r_rec.rglru_decode,
          lambda c, p, x: r_model._rglru_hidden(c, p, x)[:, -1],
          rec.rglru_train, rec.rglru_decode, rec.rglru_prefill,
          r_rec.rglru_init_state),
    "m": (r_rec.init_mlstm, r_rec.mlstm_train, r_rec.mlstm_decode,
          lambda c, p, x: r_model._mlstm_prefill(c, p, x)[1],
          rec.mlstm_train, rec.mlstm_decode, rec.mlstm_prefill,
          r_rec.mlstm_init_state),
    "s": (r_rec.init_slstm, r_rec.slstm_train, r_rec.slstm_decode,
          lambda c, p, x: r_model._slstm_prefill(c, p, x)[1],
          rec.slstm_train, rec.slstm_decode, rec.slstm_prefill,
          r_rec.slstm_init_state),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_cells_match_reference(cell):
    (r_init, r_train, r_decode, r_state_at_T, t_train, t_decode, t_prefill,
     r_init_state) = CELLS[cell]
    name = "recurrentgemma-2b" if cell == "r" else "xlstm-125m"
    rcfg, cfg = r_get_config(name).reduced(), get_config(name).reduced()
    rp = r_init(rcfg, jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    rng = np.random.RandomState(4)
    x = rng.randn(2, 19, cfg.d_model).astype(np.float32)
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    _close(t_train(cfg, tp, torch.from_numpy(x)),
           jax.jit(lambda p, x: r_train(rcfg, p, x))(rp, jnp.asarray(x)),
           f"{cell} train", 1e-5)
    # the state at T from the port's prefill, then one decode step from it
    _, t_state = t_prefill(cfg, tp, torch.from_numpy(x))
    r_state = jax.jit(lambda p, x: r_state_at_T(rcfg, p, x))(
        rp, jnp.asarray(x))
    if cell == "r":
        _close(t_state["h"], r_state, "r state h", 1e-5)
        r_state = {"h": r_state, "conv": np.asarray(
            jnp.asarray(x) @ rp["w_in"])[:, -3:]}
    else:
        for k in r_state:
            _close(t_state[k], r_state[k], f"{cell} state {k}", 1e-5)
    r_out, r_new = jax.jit(lambda p, x, st: r_decode(rcfg, p, x, st))(
        rp, jnp.asarray(x1), _map(jnp.asarray, r_state))
    t_out, t_new = t_decode(cfg, tp, torch.from_numpy(x1),
                            _map(lambda a: torch.from_numpy(np.array(a)),
                                 r_state))
    _close(t_out, r_out, f"{cell} decode out", 1e-5)
    for k in r_new:
        _close(t_new[k], r_new[k], f"{cell} decode state {k}", 1e-5)
    # the zero states have the reference's shapes and dtypes
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _named(r_init_state(rcfg, 2)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _named(CELL_INIT[cell](cfg, 2, device="cpu")).items()}
    assert got == want


CELL_INIT = {"r": rec.rglru_init_state, "m": rec.mlstm_init_state,
             "s": rec.slstm_init_state}


# --------------------------------------------------------------------------
# loss, gradients, optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(models, name):
    rcfg, rparams, cfg, tparams = models(name)
    toks = _tokens((2, 24), cfg.vocab, seed=1)
    labels = np.roll(toks, -1, axis=1)
    mask = (np.random.RandomState(2).rand(2, 24) < 0.8).astype(np.float32)
    r_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
               "mask": jnp.asarray(mask)}
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in
               r_batch.items()}
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_loss_fn(rcfg, p, r_batch)))(rparams)
    t_loss, t_grads = loss_and_grads(cfg, tparams, t_batch)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)
    want, got = _named(r_grads), _named(t_grads)
    assert sorted(got) == sorted(want)
    for leaf in want:
        _close(got[leaf], want[leaf], leaf, 1e-4)
    assert float(loss_fn(cfg, tparams, {k: t_batch[k] for k in
                                        ("tokens", "labels")})) > 0


def _opt_inputs(seed):
    rng = np.random.RandomState(seed)
    shapes = {"w": (3, 16, 12), "b": (12,), "v": (4, 6)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_step_matches_reference(kind):
    """Two updates from a fresh state (the second reads the moments the
    first wrote): factored (``w``) and unfactored (``b``, ``v``) leaves."""
    params, grads = _opt_inputs(0)
    r_oc = r_optim.OptConfig(kind=kind, lr=1e-2, warmup=3)
    oc = optim.OptConfig(kind=kind, lr=1e-2, warmup=3)
    r_p = _map(jnp.asarray, params)
    r_s = r_optim.init_opt(r_oc, r_p)
    t_p = _map(lambda a: torch.from_numpy(a.copy()), params)
    t_s = optim.init_opt(oc, t_p)
    assert ({k: tuple(v.shape) for k, v in _named(t_s).items()}
            == {k: tuple(v.shape) for k, v in _named(r_s).items()})
    for i in range(2):
        g = {k: v * (1 + i) for k, v in grads.items()}
        r_p, r_s = r_optim.apply_opt(r_oc, r_p, _map(jnp.asarray, g), r_s)
        t_p, t_s = optim.apply_opt(oc, t_p, _map(torch.from_numpy, g), t_s)
    for tree_t, tree_r in ((t_p, r_p), (t_s, r_s)):
        want = _named(tree_r)
        for leaf, v in _named(tree_t).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[leaf]),
                                       rtol=1e-6, atol=1e-6, err_msg=leaf)
    r_c, r_n = r_optim.clip_by_global_norm(_map(jnp.asarray, grads), 1.0)
    t_c, t_n = optim.clip_by_global_norm(_map(torch.from_numpy, grads), 1.0)
    np.testing.assert_allclose(float(t_n), float(r_n), rtol=1e-6)
    for leaf, v in _named(t_c).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(_named(r_c)[leaf]),
                                   rtol=1e-6, atol=1e-7)


def test_microbatch_step_matches_whole_batch(models):
    """Two accumulated microbatches give the whole batch's update (f32,
    sums in another order: 1e-5 of each leaf's largest magnitude)."""
    _, _, cfg, tparams = models("recurrentgemma-2b")
    toks = torch.from_numpy(_tokens((4, 16), cfg.vocab, seed=3))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    oc = optim.OptConfig(lr=1e-2, warmup=1)
    out = []
    for mb in (None, 2):
        params = _map(torch.clone, tparams)
        opt = optim.init_opt(oc, params)
        params, opt, metrics = make_train_step(cfg, oc, microbatch=mb)(
            params, opt, batch)
        out.append((params, float(metrics["loss"])))
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)
    want = _named(out[0][0])
    for leaf, v in _named(out[1][0]).items():
        _close(v, want[leaf], leaf, 1e-5)


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

def test_data_pipeline_structure():
    rcfg = r_get_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    r_s = r_dp.init_state(rcfg, 2, 16, seed=3)
    s0 = dp.init_state(cfg, 2, 16, seed=3, device="cpu")
    assert ({k: tuple(v.shape) for k, v in _named(s0).items()}
            == {k: tuple(np.shape(v)) for k, v in _named(r_s).items()})
    assert s0["key"].tolist() == np.asarray(r_s["key"]).tolist() == [0, 3]
    toks = s0["buffer"]
    assert toks.dtype == torch.int32 and 0 <= int(toks.min()) and \
        int(toks.max()) < cfg.vocab
    # the synthetic stream follows the successor rule at ~90 % of steps
    succ = ((toks[..., 1:] - toks[..., :-1]) % cfg.vocab == 1).float().mean()
    assert float(succ) > 0.75
    s, seen = s0, []
    for i in range(5):
        before = s["buffer"].clone()
        b, s = dp.next_batch(cfg, s)
        slot = i % dp.PREFETCH
        assert torch.equal(b["tokens"], before[slot])
        assert torch.equal(b["labels"], torch.roll(before[slot], -1, 1))
        assert int(s["cursor"]) == int(s["step"]) == i + 1
        others = [j for j in range(dp.PREFETCH) if j != slot]
        assert torch.equal(s["buffer"][others], before[others])
        assert not torch.equal(s["buffer"][slot], before[slot])
        seen.append(b["tokens"])
    assert torch.equal(s0["buffer"], dp.init_state(cfg, 2, 16, seed=3,
                                                   device="cpu")["buffer"])
    # resume from a host snapshot after step 1 gives the same batches
    _, s1 = dp.next_batch(cfg, s0)
    snap = state_from_numpy(_map(lambda t: t.numpy(), s1), "cpu")
    for want in seen[1:3]:
        b, snap = dp.next_batch(cfg, snap)
        assert torch.equal(b["tokens"], want)
    consumed = dp.consume_resume_fn(cfg, 2)(s0)["consumed"]
    assert torch.equal(consumed, torch.stack(seen[:2]))


# --------------------------------------------------------------------------
# scrutiny of the training state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
def test_training_state_masks_match_reference(models, name):
    """The launcher's resume function (the next step's loss) on a training
    state with non-zero moments, as after a step: every parameter
    critical, every integer leaf critical by policy, and ``opt/mu``,
    ``opt/nu`` all uncritical, since a one-step horizon never reads the
    moments; equal to the reference's AD masks bit for bit."""
    rcfg, rparams, cfg, _ = models(name)
    r_oc = r_optim.OptConfig(kind="adamw", lr=3e-3, warmup=5, clip_norm=10.0)
    r_step = jax.jit(r_make_train_step(rcfg, r_oc))
    rng = np.random.RandomState(6)
    moments = [_map(lambda p: jnp.asarray(rng.rand(*p.shape), jnp.float32),
                    rparams) for _ in range(2)]
    # the reference's build_state (launch/train.py:44) at step 1
    data = r_dp.next_batch(rcfg, r_dp.init_state(rcfg, 2, 16))[1]
    r_state = {"params": rparams,
               "opt": {"mu": moments[0], "nu": moments[1],
                       "step": jnp.asarray(1, jnp.int32)},
               "data": data, "step": jnp.asarray(1, jnp.int32)}

    def r_resume(s):
        b, _ = r_dp.next_batch(rcfg, s["data"])
        _, _, metrics = r_step(s["params"], s["opt"], b)
        return {"loss": metrics["loss"]}

    r_rep = r_scrutinize(r_resume, r_state)
    np_state = _map(np.asarray, r_state)
    np_state["data"]["key"] = np_state["data"]["key"].astype(np.int32)
    rep = scrutinize(launch.make_resume_fn(cfg),
                     state_from_numpy(np_state, "cpu"), device="cpu")
    assert sorted(rep.leaves) == sorted(r_rep.leaves)
    for leaf in r_rep.leaves:
        assert np.array_equal(rep[leaf].mask, r_rep[leaf].mask), leaf
        if leaf.startswith(("opt/mu/", "opt/nu/")):
            assert rep[leaf].critical == 0, leaf
        else:
            assert rep[leaf].all_critical, leaf


# --------------------------------------------------------------------------
# decode consistency, restart, device defaults
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
def test_decode_matches_full_forward(name):
    """Prefill T tokens, decode token T: the logits equal the full forward
    over T + 1 tokens at position T (f32, sums in another order: 1e-4)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    T = 40                                 # past recurrentgemma's window 32
    toks = torch.from_numpy(_tokens((2, T + 1), cfg.vocab, seed=5))
    want = model_mod.full_logits(cfg, params, {"tokens": toks})[:, T]
    _, cache = prefill(cfg, params, {"tokens": toks[:, :T]}, T + 8)
    got, _ = decode_step(cfg, params, cache, toks[:, T:],
                         torch.tensor(T, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("T", [1, 2])
def test_short_recurrent_prefill_decodes(models, T):
    """A prompt shorter than the RG-LRU's conv history (T < 3 rows): the
    prefill pads its conv state in front with the zeros ``_causal_conv``
    pads with, so the state has ``rglru_init_state``'s shape and decodes.
    Prefill + decode equals the full forward at position T (1e-4, as
    above); the prefill logits equal the reference's (1e-5), whose next
    decode step fails on the same prompt (ROADMAP Queue 3)."""
    rcfg, rparams, cfg, params = models("recurrentgemma-2b")
    toks = _tokens((2, T + 1), cfg.vocab, seed=7 + T)
    want = model_mod.full_logits(
        cfg, params, {"tokens": torch.from_numpy(toks)})[:, T]
    logits, cache = prefill(cfg, params,
                            {"tokens": torch.from_numpy(toks[:, :T])}, 16)
    r_logits, _ = jax.jit(lambda p, t: r_model.prefill(
        rcfg, p, {"tokens": t}, 16))(rparams, jnp.asarray(toks[:, :T]))
    _close(logits, r_logits, f"prefill logits T={T}", 1e-5)
    zero = _named(init_cache(cfg, 2, 16, device="cpu"))
    convs = {k: v for k, v in _named(cache).items() if k.endswith("/conv")}
    assert convs and all(v.shape == zero[k].shape for k, v in convs.items())
    assert all(v.shape[-2:] == rec.rglru_init_state(cfg, 2, device="cpu")
               ["conv"].shape[-2:] for v in convs.values())
    got, _ = decode_step(cfg, params, cache, torch.from_numpy(toks[:, T:]),
                         torch.tensor(T, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_restart_equivalence(tmp_path):
    """Run 12 steps straight vs 6 + crash + restore + 6: identical losses
    (as ``tests/test_train_loop.py``, on the CPU)."""
    args = ["--steps", "12", "--batch", "2", "--seq", "32",
            "--ckpt-every", "6", "--ckpt-dir", str(tmp_path),
            "--log-every", "100", "--device", "cpu"]
    full = launch.main(args)
    for level in ("ram", "disk"):
        d = tmp_path / level
        for sub in d.iterdir():
            if sub.name.startswith("step_") and \
                    int(sub.name.split("_")[1]) > 6:
                shutil.rmtree(sub)
    resumed = launch.main(args + ["--resume"])
    assert len(resumed) == 6
    np.testing.assert_allclose(full[6:], resumed, rtol=1e-5,
                               err_msg="restart diverged from straight run")


@pytest.mark.parametrize("flag", ["--verify-static", "--coordinated"])
def test_unported_launcher_paths_raise(flag, tmp_path):
    """``--coordinated`` (item 10) raises; ``--verify-static`` (item 8,
    ported) runs: two steps and a gated, pruned scrutiny here, its
    checkpoints held in ``tests/test_torch_static.py``."""
    args = [flag, "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    if flag == "--verify-static":
        losses = launch.main(args + ["--steps", "2", "--batch", "2",
                                     "--seq", "16", "--ckpt-every", "2",
                                     "--log-every", "100"])
        assert len(losses) == 2 and np.isfinite(losses).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        launch.main(args)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_allocating_entry_points_default_to_the_card(no_card):
    """Called without a device, each raises resolve_device's error when
    no card is present; with ``device="cpu"`` each allocates there."""
    cfg = get_config("recurrentgemma-2b").reduced()
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    np_tree = {"x": np.ones(3, np.float32)}
    np_params = _map(lambda t: t.numpy(),
                     init_params(cfg, torch.Generator().manual_seed(0)))
    calls = [
        lambda **kw: init_cache(cfg, 2, 8, **kw),
        lambda **kw: model_mod.init_layer_cache(cfg, ("r", "d"), 2, 8, **kw),
        lambda **kw: attn.init_cache(cfg, 2, 8, **kw),
        lambda **kw: state_from_numpy(np_tree, **kw),
        lambda **kw: params_from_numpy(cfg, np_params, **kw),
        lambda **kw: dp.init_state(cfg, 2, 8, **kw),
        lambda **kw: launch.build_state(cfg, optim.OptConfig(), 2, 8, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)
        for leaf in _tree.leaves(call(device="cpu")):
            assert leaf.device.type == "cpu"
