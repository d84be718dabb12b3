"""Rematerialization in the port (``cfg.remat``, ``set_remat_policy``)
against the reference, on the CPU.

- Loss and gradients with remat off, "full" and "dots" are bit for bit
  equal to each other (remat moves memory, not values: every recomputed
  value is the same op on the same inputs) and equal the reference's
  ``jax.value_and_grad`` with its remat on, for reduced recurrentgemma-2b,
  xlstm-125m and phi4-mini-3.8b;
- remat runs: with it on, every layer's forward runs twice in a training
  step ("full" recomputes the matrix products, "dots" keeps them); with
  autograd off, or ``cfg.remat`` False, once;
- the AD scrutiny of a training state (``torch.func.vjp``, where
  checkpointing's saved-tensor hooks are refused) and participation (a
  ``make_fx`` trace under ``no_grad``) give the same masks with
  ``cfg.remat`` on as off.

Tolerances (f32): against the reference, the loss within 1e-5 relative
and the gradients within 1e-4 of each leaf's largest magnitude, floored at
1, as ``tests/test_torch_train.py``; between the port's three modes, bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.models import model as r_model
from repro_torch import _tree, scrutinize
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.core import participation
from repro_torch.data import pipeline as dp
from repro_torch.launch import train as launch
from repro_torch.models import model as t_model
from repro_torch.train.step import loss_and_grads

torch.set_num_threads(1)

ARCHS = ["recurrentgemma-2b", "xlstm-125m", "phi4-mini-3.8b"]
MODES = ["off", "full", "dots"]


def _named(tree):
    return {n: np.asarray(v) for n, v in _tree.flatten_with_names(tree)[0]}


@pytest.fixture
def policy():
    """Sets both packages' remat policy; restores "dots" after."""
    def set_(mode):
        t_model.set_remat_policy(mode)
        r_model.set_remat_policy(mode)
    yield set_
    set_("dots")


@pytest.fixture(scope="module")
def models():
    made = {}

    def get(name):
        if name not in made:
            rcfg = dataclasses.replace(r_get_config(name).reduced(),
                                       remat=True)
            rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
                jax.random.PRNGKey(0))
            cfg = get_config(name).reduced()
            made[name] = (rcfg, rparams, cfg, params_from_numpy(
                cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu"))
        return made[name]

    return get


def _batch(vocab, seed=1):
    toks = np.random.RandomState(seed).randint(0, vocab, (2, 24)).astype(
        np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _with(cfg, mode):
    return dataclasses.replace(cfg, remat=mode != "off")


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_equal_across_modes_and_the_reference(
        models, policy, name):
    rcfg, rparams, cfg, tparams = models(name)
    b = _batch(cfg.vocab)
    got = {}
    for mode in MODES:
        if mode != "off":
            policy(mode)
        loss, grads = loss_and_grads(_with(cfg, mode), tparams,
                                     state_from_numpy(b, "cpu"))
        got[mode] = (float(loss), _named(grads))
    for mode in ("full", "dots"):
        assert got[mode][0] == got["off"][0], mode
        for k, v in got["off"][1].items():
            np.testing.assert_array_equal(got[mode][1][k], v,
                                          err_msg=f"{mode} {k}")
    policy("dots")
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_loss_fn(rcfg, p, jax.tree_util.tree_map(jnp.asarray,
                                                            b))))(rparams)
    np.testing.assert_allclose(got["dots"][0], float(r_loss), rtol=1e-5)
    for k, v in _named(r_grads).items():
        scale = max(float(np.abs(v).max()), 1.0)
        err = float(np.abs(got["dots"][1][k] - v).max())
        assert err <= 1e-4 * scale, f"{k}: max |Δ| {err}"


class _CountOps(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops, self.count = ops, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_each_layer(models, policy, monkeypatch):
    _, _, cfg, tparams = models("recurrentgemma-2b")
    b = state_from_numpy(_batch(cfg.vocab), "cpu")
    calls = []
    real = t_model.apply_block_train

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(t_model, "apply_block_train", counted)
    for mode, grad, want in (("off", True, 1), ("full", True, 2),
                             ("dots", True, 2), ("dots", False, 1)):
        if mode != "off":
            policy(mode)
        calls.clear()
        with torch.set_grad_enabled(grad):
            if grad:
                loss_and_grads(_with(cfg, mode), tparams, b)
            else:
                t_model.loss_fn(_with(cfg, mode), tparams, b)
        assert len(calls) == want * cfg.n_layers, (mode, grad, len(calls))


def test_dots_keeps_the_matrix_products(models, policy):
    """xlstm's layers (no attention op) under a counting mode: "full"
    runs every ``aten.mm`` of the forward again in the backward, "dots"
    none (their outputs are kept)."""
    _, _, cfg, tparams = models("xlstm-125m")
    b = state_from_numpy(_batch(cfg.vocab), "cpu")
    mm = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    counts = {}
    for mode in MODES:
        if mode != "off":
            policy(mode)
        with _CountOps(mm) as c:
            loss_and_grads(_with(cfg, mode), tparams, b)
        counts[mode] = c.count
    assert counts["dots"] == counts["off"] < counts["full"], counts


def test_policy_names():
    with pytest.raises(ValueError, match="unknown remat policy"):
        t_model.set_remat_policy("everything")


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
def test_scrutiny_and_participation_masks_unchanged_with_remat(models,
                                                               name):
    """The launcher's resume on a training state: the AD masks (under
    ``torch.func.vjp``) and participation's (a ``make_fx`` trace) with
    ``cfg.remat`` on equal those with it off, bit for bit."""
    _, _, cfg, tparams = models(name)
    rng = np.random.RandomState(6)

    def moments():
        named, treedef = _tree.flatten_with_names(tparams)
        return _tree.unflatten(treedef, [torch.from_numpy(
            rng.rand(*p.shape).astype(np.float32)) for _, p in named])

    state = {"params": tparams,
             "opt": {"mu": moments(), "nu": moments(),
                     "step": torch.tensor(1, dtype=torch.int32)},
             "data": dp.init_state(cfg, 2, 16, device="cpu"),
             "step": torch.tensor(1, dtype=torch.int32)}
    for analysis in (lambda fn: scrutinize(fn, state, device="cpu"),
                     lambda fn: participation(fn, state, device="cpu")):
        reps = [analysis(launch.make_resume_fn(_with(cfg, mode)))
                for mode in ("off", "dots")]
        assert sorted(reps[0].leaves) == sorted(reps[1].leaves)
        for leaf in reps[0].leaves:
            np.testing.assert_array_equal(reps[1][leaf].mask,
                                          reps[0][leaf].mask, err_msg=leaf)
