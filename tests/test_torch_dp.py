"""The port's compressed data-parallel step (``repro_torch.train.step``:
``topk_ef_compress``, ``int8_allreduce``, ``make_compressed_dp_step``,
``init_errors``) against the reference, on the CPU.

- ``topk_ef_compress`` and ``int8_allreduce`` over a world of one equal
  the reference's bit for bit on numpy-seeded trees (ties included);
- the whole step on a (1, 1) mesh against the reference's
  ``make_compressed_dp_step``, for reduced xlstm-125m and
  recurrentgemma-2b, each step from the port's state before it;
- a world of two, two processes in a gloo group, against the reference's
  own functions composed: ``jax.value_and_grad(loss_fn)`` on each half of
  the batch, ``topk_ef_compress``, ``int8_allreduce`` under
  ``jax.vmap(..., axis_name="dp")`` over the stacked replicas (vmap gives
  psum and pmax one device's worth), ``clip_by_global_norm`` and
  ``apply_opt``; both ranks' parameters are bit-identical, and each keeps
  its own error buffer (the reference hands back replica 0's).

Tolerances (f32).  The gradients of the two packages differ by their
summation order, within 1e-4 of each leaf's largest magnitude
(``tests/test_torch_train.py``; 2.8e-5 seen here), so the top-k threshold
and the int8 rounding, both steps of the gradient, may fall on either side
for an element that lies at them: an element is exempt where ``| |g + e| -
threshold |`` is within 1e-4 of its leaf's largest ``|g + e|`` (its
selection) or ``g / scale`` is within 127 x 1e-4 of a rounding midpoint
(its int8 value), and at most 1 in 100 of the elements may be exempt.
Every other element: parameters and moments within 1e-4 of the leaf's
largest magnitude, errors within 1e-4 of the leaf's largest ``|g + e|``
(the gradient's scale), both floored at 1; the loss within 1e-5
relative.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.train import optim as r_optim
from repro.train import step as r_step
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.train import optim
from repro_torch.train import step as t_step

torch.set_num_threads(1)

FRAC = 0.05
SEL_TOL = VAL_TOL = 1e-4
ROUND_TOL = 127 * SEL_TOL       # SEL_TOL of the largest |g|, in int8 steps
MAX_EXEMPT = 1e-2
TIMEOUT_S = 240


def _named(tree):
    return {n: np.asarray(v) for n, v in
            _tree.flatten_with_names(tree)[0]}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tree_np(tree):
    """A port tree (nested dicts of tensors) as nested numpy arrays."""
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [t.detach().numpy().copy()
                                     for _, t in named])


def _trees(seed, frac_ties=False):
    rng = np.random.RandomState(seed)
    shapes = {"a": (37, 5), "b": (1000,), "c": {"d": (3, 4, 129)},
              "e": (1,)}

    def make(scale):
        def one(s):
            return (rng.randn(*s) * scale).astype(np.float32)
        return {k: ({kk: one(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else one(v))
                for k, v in shapes.items()}

    g = make(rng.choice([1e-3, 1.0, 50.0]))
    if frac_ties:                       # many equal magnitudes
        g["b"][:600] = np.round(g["b"][:600], 1)
    return g, make(0.1)


def _torch(tree):
    return state_from_numpy(tree, "cpu")


@pytest.mark.parametrize("frac", [0.001, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_ef_compress_bit_for_bit(seed, frac):
    g, e = _trees(seed, frac_ties=seed == 0)
    rs, re_ = r_step.topk_ef_compress(_jnp(g), _jnp(e), frac)
    ts, te = t_step.topk_ef_compress(_torch(g), _torch(e), frac)
    for what, r, t in (("sparse", rs, ts), ("errors", re_, te)):
        want, got = _named(r), _named(_tree_np(t))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_allreduce_world_of_one_bit_for_bit(seed):
    g, _ = _trees(seed)
    stacked = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], g)
    want = jax.vmap(lambda t: r_step.int8_allreduce(t, "dp"),
                    axis_name="dp")(stacked)
    got = _named(_tree_np(t_step.int8_allreduce(_torch(g))))
    for k, v in _named(want).items():
        np.testing.assert_array_equal(got[k], v[0], err_msg=k)


def test_init_errors():
    p = _torch({"w": np.ones((3, 2), np.float32),
                "h": {"b": np.ones(4, np.float16)}})
    e = t_step.init_errors(p)
    assert e["w"].dtype == torch.float32 and e["h"]["b"].dtype == \
        torch.float32 and not e["w"].any() and e["h"]["b"].shape == (4,)


def test_local_batch_cuts_this_replicas_rows():
    b = {"tokens": torch.arange(24, dtype=torch.int32).reshape(6, 4),
         "labels": torch.arange(24, dtype=torch.int32).reshape(6, 4)}
    for rank in range(3):
        got = t_step.local_batch({"data": 3, "model": 1}, b, rank)
        assert torch.equal(got["tokens"], b["tokens"][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not split"):
        t_step.local_batch({"data": 4, "model": 1}, b, 0)


def test_the_step_refuses_what_the_reference_refuses():
    cfg = get_config("xlstm-125m").reduced()
    oc = optim.OptConfig()
    with pytest.raises(ValueError, match="data-parallel only"):
        t_step.make_compressed_dp_step(cfg, oc, {"data": 1, "model": 2})
    with pytest.raises(ValueError, match="group of 2 ranks"):
        t_step.make_compressed_dp_step(cfg, oc, {"data": 2, "model": 1})


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

def _models(name):
    rcfg = r_get_config(name).reduced()
    rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    cfg = get_config(name).reduced()
    return rcfg, cfg, np_params


def _batch(cfg, seed, rows=4, T=16):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab, (rows, T)) \
        .astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


_GRADS = {}


def _grad_fn(rcfg):
    """``jax.value_and_grad`` of the reference's loss, jitted once per
    config."""
    if rcfg.name not in _GRADS:
        _GRADS[rcfg.name] = jax.jit(jax.value_and_grad(
            lambda p, b: r_loss_fn(rcfg, p, b)))
    return _GRADS[rcfg.name]


def _exempt(rcfg, params, errors, halves, quantize):
    """Per leaf, the elements whose top-k selection on some replica, or
    whose int8 rounding, lies within the tolerances of its threshold or
    midpoint (the reference's own functions composed) → (exempt for the
    parameters, [exempt for replica r's errors], [replica r's largest
    |g + e| per leaf: its errors' scale])."""
    grad = _grad_fn(rcfg)
    p_ex, e_ex, e_scale = None, [], []
    for b, e in zip(halves, errors):
        _, g = grad(_jnp(params), _jnp(b))
        sel, rnd, top = {}, {}, {}
        e_named = _named(e)
        for k, gk in _named(g).items():
            g32 = np.asarray(gk, np.float32) + e_named[k]
            mag = np.abs(g32).reshape(-1)
            kk = max(1, int(mag.size * FRAC))
            thresh = np.sort(mag)[-kk]
            near = np.abs(mag - thresh) <= SEL_TOL * mag.max()
            sel[k] = near
            top[k] = float(mag.max())
            sparse = np.where(mag >= thresh, g32.reshape(-1), 0.0)
            scale = np.float32(np.abs(sparse).max() / 127.0 + 1e-12)
            q = sparse / scale
            rnd[k] = (np.abs(np.abs(q - np.floor(q)) - 0.5) <= ROUND_TOL
                      if quantize else np.zeros_like(near))
        e_ex.append(sel)
        e_scale.append(top)
        p_ex = {k: sel[k] | rnd[k] | (p_ex[k] if p_ex else False)
                for k in sel}
    return p_ex, e_ex, e_scale


def _check(got, want, exempt, what, scales=None):
    g, w = _named(got), _named(want)
    assert sorted(g) == sorted(w), what
    n_ex = n_all = 0
    for k in w:
        ex = exempt.get(k, np.zeros(w[k].size, bool)).reshape(w[k].shape) \
            if exempt is not None else np.zeros(w[k].shape, bool)
        n_ex += int(ex.sum())
        n_all += ex.size
        scale = max(float(np.abs(w[k]).max()) if scales is None
                    else scales[k], 1.0)
        err = float(np.abs(np.where(ex, 0, g[k].astype(np.float32)
                                    - w[k].astype(np.float32))).max())
        assert err <= VAL_TOL * scale, \
            f"{what} {k}: max |Δ| {err} > {VAL_TOL} x {scale}"
    assert n_ex <= MAX_EXEMPT * n_all, f"{what}: {n_ex} of {n_all} exempt"


def _opt_named(state):
    return {f"opt/{k}": v for k, v in _named(state).items()}


@pytest.mark.parametrize("name", ["xlstm-125m", "recurrentgemma-2b"])
def test_step_matches_reference_on_a_1x1_mesh(name):
    rcfg, cfg, np_params = _models(name)
    roc = r_optim.OptConfig(lr=1e-2, warmup=2)
    oc = optim.OptConfig(lr=1e-2, warmup=2)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rstep = jax.jit(r_step.make_compressed_dp_step(rcfg, roc, mesh,
                                                   frac=FRAC))
    tstep = t_step.make_compressed_dp_step(cfg, oc, {"data": 1, "model": 1},
                                           frac=FRAC)
    tp = params_from_numpy(cfg, np_params, "cpu")
    ts, te = optim.init_opt(oc, tp), t_step.init_errors(tp)
    for i in range(2):
        b = _batch(cfg, i)
        before = (_tree_np(tp), _tree_np(ts), _tree_np(te))
        want = rstep(*(_jnp(x) for x in before), _jnp(b))
        p_ex, (e_ex,), (e_sc,) = _exempt(rcfg, before[0], [before[2]], [b],
                                         True)
        tp, ts, te, tl = tstep(tp, ts, te, state_from_numpy(b, "cpu"))
        np.testing.assert_allclose(float(tl), float(want[3]), rtol=1e-5)
        _check(_tree_np(tp), want[0], p_ex, f"step {i} params")
        _check(_tree_np(te), want[2], e_ex, f"step {i} errors", e_sc)
        _check(_tree_np(ts["mu"]), want[1]["mu"], p_ex, f"step {i} mu")
        assert int(ts["step"]) == int(want[1]["step"])


_PROG = r"""
import os
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=2)
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.train import optim, step
cfg = get_config(os.environ["ARCH"]).reduced()
out = os.environ["OUT"]
z = np.load(os.path.join(out, "inputs.npz"))
def nest(prefix):
    tree = {}
    for name in z.files:
        if not name.startswith(prefix):
            continue
        node = tree
        *parts, last = name[len(prefix):].split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = z[name]
    return tree
oc = optim.OptConfig(lr=1e-2, warmup=2)
params = params_from_numpy(cfg, nest("p/"), "cpu")
opt, errors = optim.init_opt(oc, params), step.init_errors(params)
def save(tag, loss):
    flat = {}
    for pre, tree in (("p/", params), ("o/", opt), ("e/", errors)):
        for n, t in _tree.flatten_with_names(tree)[0]:
            flat[pre + n] = t.numpy()
    np.savez(os.path.join(out, f"{tag}_rank{rank}.npz"), loss=float(loss),
             **flat)
for i, quantize in enumerate((True, True, False)):
    fn = step.make_compressed_dp_step(cfg, oc, {"data": 2, "model": 1},
                                      frac=float(os.environ["FRAC"]),
                                      quantize=quantize)
    batch = state_from_numpy({"tokens": z[f"tokens{i}"],
                              "labels": z[f"labels{i}"]}, "cpu")
    save(f"before{i}", 0.0)
    params, opt, errors, loss = fn(params, opt, errors, batch)
    save(f"after{i}", loss)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _load(path):
    z = np.load(path)
    trees = {}
    for pre in ("p/", "o/", "e/"):
        tree = {}
        for name in z.files:
            if name.startswith(pre):
                node = tree
                *parts, last = name[2:].split("/")
                for part in parts:
                    node = node.setdefault(part, {})
                node[last] = z[name]
        trees[pre] = tree
    return trees["p/"], trees["o/"], trees["e/"], float(z["loss"])


@pytest.mark.multiprocess
def test_world_of_two_over_gloo_matches_the_reference_composed(tmp_path):
    name = "recurrentgemma-2b"
    rcfg, cfg, np_params = _models(name)
    roc = r_optim.OptConfig(lr=1e-2, warmup=2)
    batches = [_batch(cfg, 10 + i) for i in range(3)]
    np.savez(tmp_path / "inputs.npz",
             **{f"p/{k}": v for k, v in _named(np_params).items()},
             **{f"{k}{i}": b[k] for i, b in enumerate(batches)
                for k in ("tokens", "labels")})
    env = dict(os.environ, OMP_NUM_THREADS="1", ARCH=name, OUT=str(tmp_path),
               FRAC=str(FRAC), INIT=f"tcp://localhost:{_free_port()}")
    env.pop("REPRO_PROCESS_COUNT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, "-c", _PROG],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o, e[-3000:])

    grad = _grad_fn(rcfg)
    reduce = jax.jit(jax.vmap(lambda t: r_step.int8_allreduce(t, "dp"),
                              axis_name="dp"))
    update = jax.jit(lambda p, g, s: r_optim.apply_opt(
        roc, p, r_optim.clip_by_global_norm(g, roc.clip_norm)[0], s))
    for i, quantize in enumerate((True, True, False)):
        got = [_load(tmp_path / f"after{i}_rank{r}.npz") for r in range(2)]
        before = [_load(tmp_path / f"before{i}_rank{r}.npz")
                  for r in range(2)]
        params, opt = before[0][0], before[0][1]
        for r in range(2):
            for a, b in ((got[0][0], got[1][0]), (got[0][1], got[1][1])):
                for k, v in _named(a).items():
                    np.testing.assert_array_equal(v, _named(b)[k],
                                                  err_msg=f"step {i} {k}")
        halves = [{k: v[2 * r:2 * r + 2] for k, v in batches[i].items()}
                  for r in range(2)]
        losses, sparse, errors = [], [], []
        for r in range(2):
            loss, g = grad(_jnp(params), _jnp(halves[r]))
            s, e = r_step.topk_ef_compress(g, _jnp(before[r][2]), FRAC)
            losses.append(float(loss))
            sparse.append(s)
            errors.append(e)
        stacked = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]),
                                         *sparse)
        red = (jax.tree_util.tree_map(lambda a: a[0], reduce(stacked))
               if quantize else
               jax.tree_util.tree_map(lambda a: a.mean(0), stacked))
        want_p, want_o = update(_jnp(params), red, _jnp(opt))
        p_ex, e_ex, e_sc = _exempt(rcfg, params,
                                   [before[r][2] for r in range(2)], halves,
                                   quantize)
        np.testing.assert_allclose(got[0][3], np.mean(losses), rtol=1e-5)
        _check(got[0][0], want_p, p_ex, f"step {i} params")
        _check(got[0][1]["mu"], want_o["mu"], p_ex, f"step {i} mu")
        for r in range(2):
            _check(got[r][2], errors[r], e_ex[r],
                   f"step {i} rank {r} errors", e_sc[r])
        # each replica keeps its own buffer: they differ
        assert any(not np.array_equal(a, _named(got[1][2])[k])
                   for k, a in _named(got[0][2]).items())
