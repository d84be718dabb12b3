"""The port's GPipe (``repro_torch.distributed.pipeline.gpipe_apply``)
against the sequential run and the reference, on the CPU.

- Two processes in a gloo group, one stage each, run reduced
  phi4-mini-3.8b's four decoder blocks as S = 2 stages of two, over M = 4
  microbatches: the outputs on both ranks, every stage's parameter
  gradients and x's gradient equal the four blocks run one after the
  other in one process;
- those sequential blocks equal the reference's ``apply_block_train`` on
  the carried-over parameters;
- the reference's ``gpipe_apply`` does not return what its docstring
  says: on 2 host devices, x = [[1,2],[3,4],[5,6]] as (3, 1, 1, 2) and
  ``block_fn(p, x) = x * p + 1`` with stage parameters (2, 3), it returns
  shape (4, 1, 1, 2) with one non-zero row, [7, 9] at row 1 (stage 0's
  output for microbatch 1); the port returns the last stage's outputs in
  microbatch order, [[10,16],[22,28],[34,40]] (ROADMAP Queue 3).

Tolerances (f32): the sequential blocks within 1e-5 of the reference's
largest |output| (XLA sums its matmuls in another order); the pipeline
bit for bit the sequential run's outputs, and its gradients within 1e-6
of each leaf's largest magnitude, floored at 1 (the microbatches'
gradients are summed in another order than one batch's).
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

from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.models import model as r_model
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import pipeline
from repro_torch.models import model as t_model

torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
S, M, MB, T = 2, 4, 1, 8
TIMEOUT_S = 240

_PROG = r"""
import os, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=2)
from repro_torch.configs import get_config
from repro_torch.distributed import pipeline
from repro_torch.models import model
out_dir = os.environ["OUT"]
res = {}
# the reference's probe: block_fn(p, x) = x * p + 1, stage parameters (2, 3)
x = torch.tensor([[1., 2.], [3., 4.], [5., 6.]]).reshape(3, 1, 1, 2)
y = pipeline.gpipe_apply(None, lambda p, v: v * p + 1,
                         torch.tensor(float(rank + 2)), x, 3)
res["probe"] = y.detach().numpy()
# reduced phi4-mini: two decoder blocks a stage
cfg = get_config(os.environ["ARCH"]).reduced()
z = np.load(os.path.join(out_dir, "inputs.npz"))
stage = {k[2:]: torch.from_numpy(z[k][2 * rank:2 * rank + 2].copy())
         .requires_grad_(True) for k in z.files if k.startswith("p/")}
def nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *parts, last = name.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = v
    return tree
x = torch.from_numpy(z["x"]).requires_grad_(True)
kind = model.layer_kinds(cfg)[0]
pos = torch.arange(x.shape[2], dtype=torch.int32).expand(x.shape[1], -1)
def block_fn(p, v):
    for layer in model._unstack(p):
        v = model.apply_block_train(cfg, kind, layer, v, pos)[0]
    return v
out = pipeline.gpipe_apply(None, block_fn, nest(stage), x, x.shape[0])
(out * torch.from_numpy(z["w"])).sum().backward()
res["out"] = out.detach().numpy()
for k, v in stage.items():
    res["g/" + k] = v.grad.numpy()
res["gx"] = (x.grad if x.grad is not None else torch.zeros_like(x)).numpy()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
dist.destroy_process_group()
"""

_REF_PROBE = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed.pipeline import gpipe_apply
mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))
x = jnp.array([[1., 2.], [3., 4.], [5., 6.]]).reshape(3, 1, 1, 2)
y = gpipe_apply(mesh, "pipe", lambda p, v: v * p[0] + 1,
                jnp.array([2., 3.]), x, 3)
print("REF", np.asarray(y).reshape(-1).tolist(), list(y.shape))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("REPRO_PROCESS_COUNT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


@pytest.fixture(scope="module")
def blocks():
    """(reference cfg, port cfg, the segment's stacked parameters as
    numpy, x (M, MB, T, d), the loss weights w)."""
    rcfg = r_get_config(ARCH).reduced()
    rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    cfg = get_config(ARCH).reduced()
    tparams = params_from_numpy(cfg, np_params, "cpu")
    seg = {n: t.numpy() for n, t in _tree.flatten_with_names(
        tparams["segments"]["seg0"]["u0"])[0]}
    rng = np.random.RandomState(3)
    x = rng.randn(M, MB, T, cfg.d_model).astype(np.float32)
    w = rng.randn(M, MB, T, cfg.d_model).astype(np.float32)
    return rcfg, cfg, seg, x, w


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *parts, last = name.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


def _sequential(cfg, seg, x, w):
    """The four blocks one after the other on each microbatch → (outputs,
    parameter gradients, x's gradient)."""
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in seg.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    kind = t_model.layer_kinds(cfg)[0]
    pos = torch.arange(T, dtype=torch.int32).expand(MB, -1)
    outs = []
    for m in range(M):
        v = xt[m]
        for layer in t_model._unstack(_nest(p)):
            v = t_model.apply_block_train(cfg, kind, layer, v, pos)[0]
        outs.append(v)
    out = torch.stack(outs)
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()},
            xt.grad.numpy())


@pytest.fixture(scope="module")
def two_stages(blocks, tmp_path_factory):
    """Both ranks' results of the two-process gloo run."""
    _, cfg, seg, x, w = blocks
    out = tmp_path_factory.mktemp("gpipe")
    np.savez(out / "inputs.npz", x=x, w=w,
             **{f"p/{k}": v for k, v in seg.items()})
    env = _env(INIT=f"tcp://localhost:{_free_port()}", OUT=str(out),
               ARCH=ARCH)
    procs = [subprocess.Popen([sys.executable, "-c", _PROG],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(S)]
    outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o, e[-3000:])
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(S)]


def _close(got, want, what, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |Δ| {err} > {tol} x {scale}"


def test_sequential_blocks_match_reference(blocks):
    rcfg, cfg, seg, x, _ = blocks
    want, _, _ = _sequential(cfg, seg, x, np.zeros_like(x))
    kind = r_model.layer_kinds(rcfg)[0]
    rseg = _nest({k: jnp.asarray(v) for k, v in seg.items()})
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (MB, T))
    for m in range(M):
        v = jnp.asarray(x[m])
        for layer in range(4):
            p = jax.tree_util.tree_map(lambda a: a[layer], rseg)
            v = r_model.apply_block_train(rcfg, kind, p, v, pos)[0]
        _close(want[m], np.asarray(v), f"microbatch {m}", 1e-5)


@pytest.mark.multiprocess
def test_gpipe_outputs_match_sequential_on_every_rank(blocks, two_stages):
    _, cfg, seg, x, w = blocks
    want, _, _ = _sequential(cfg, seg, x, w)
    for r, res in enumerate(two_stages):
        assert res["out"].shape == (M, MB, T, cfg.d_model)
        np.testing.assert_array_equal(res["out"], want,
                                      err_msg=f"rank {r}")


@pytest.mark.multiprocess
def test_gpipe_gradients_match_sequential(blocks, two_stages):
    _, cfg, seg, x, w = blocks
    _, grads, gx = _sequential(cfg, seg, x, w)
    for r, res in enumerate(two_stages):
        for k, g in grads.items():
            _close(res[f"g/{k}"], g[2 * r:2 * r + 2], f"stage {r} {k}", 1e-6)
    _close(two_stages[0]["gx"], gx, "x", 1e-6)
    assert not two_stages[1]["gx"].any()      # stage 1 never reads x


@pytest.mark.multiprocess
def test_reference_gpipe_fault_pinned(two_stages):
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _REF_PROBE], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    line = next(x for x in p.stdout.splitlines() if x.startswith("REF "))
    flat, shape = eval(line[4:].replace("] [", "], ["))   # noqa: S307
    ref = np.array(flat).reshape(shape)
    assert list(shape) == [4, 1, 1, 2]
    want_ref = np.zeros((4, 1, 1, 2))
    want_ref[1, 0, 0] = [7.0, 9.0]
    np.testing.assert_array_equal(ref, want_ref)
    for res in two_stages:
        np.testing.assert_array_equal(
            res["probe"].reshape(3, 2),
            np.array([[10.0, 16.0], [22.0, 28.0], [34.0, 40.0]]))


def test_gpipe_world_of_one_is_the_sequential_run(blocks):
    _, cfg, seg, x, w = blocks
    want, grads, gx = _sequential(cfg, seg, x, w)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in seg.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    kind = t_model.layer_kinds(cfg)[0]
    pos = torch.arange(T, dtype=torch.int32).expand(MB, -1)

    def block_fn(params, v):
        for layer in t_model._unstack(params):
            v = t_model.apply_block_train(cfg, kind, layer, v, pos)[0]
        return v

    out = pipeline.gpipe_apply(None, block_fn, _nest(p), xt, M)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    (out * torch.from_numpy(w)).sum().backward()
    for k, g in grads.items():
        np.testing.assert_array_equal(p[k].grad.numpy(), g, err_msg=k)
    np.testing.assert_array_equal(xt.grad.numpy(), gx)


@pytest.mark.parametrize("stages,micro,want", [(2, 4, 0.2), (4, 4, 3 / 7),
                                               (1, 8, 0.0)])
def test_bubble_fraction(stages, micro, want):
    assert pipeline.bubble_fraction(stages, micro) == pytest.approx(want)


def test_microbatch_count_must_match_x():
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.gpipe_apply(None, lambda p, v: v, None,
                             torch.zeros(3, 1, 2, 2), 4)
