"""The port's MoE against the reference, on the CPU.

Reduced olmoe-1b-7b (8 experts, top 2) and deepseek-v3-671b (8 routed
experts, top 2, one shared), f32, the reference's parameters carried over,
inputs made with numpy from a seed:

- ``apply_moe`` dropless (inference) and with the training capacity: the
  outputs and the aux loss; a router made to overflow one expert, so that
  capacity drops slots: the port keeps and drops the reference's slots;
- a router with tied columns: ties go to the lower expert index, as
  ``lax.top_k`` breaks them;
- the reference's fault: when the *last* expert overflows a row, its
  dropped slots are scattered as zeros to (E - 1, C - 1), an index in
  bounds, and overwrite that expert's last kept slot
  (``repro/models/moe.py:122-126``); the port keeps that slot, as a numpy
  model of the capacity rule does (ROADMAP Queue 3);
- participation over the launcher's resume (the next step's loss) on a
  reduced olmoe training state whose batch leaves experts unrouted: masks
  equal to the reference's bit for bit once a segment's layers are joined
  as the reference's scan rule joins them (an expert is critical in every
  layer there if a slot routes to it in one); layer by layer the port
  finds the unrouted experts' weights uncritical; AD ⊆ participation
  through the soundness gate;
- the launcher trains both archs with ``--preset smoke --scrutinize``.

Tolerances (f32): MoE outputs within 1e-5 of their largest magnitude
(sums in another order), the aux loss within 1e-6 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import participation as r_participation
from repro.data import pipeline as r_dp
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.models import moe as r_moe
from repro_torch import _tree, scrutinize
from repro_torch.analysis import analyze_static, verify_soundness
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import participation
from repro_torch.launch import train as launch
from repro_torch.models import moe

torch.set_num_threads(1)

B, T = 2, 13


def _named(tree):
    return dict(_tree.flatten_with_names(tree)[0])


def _map(fn, tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(leaf) for _, leaf in named])


def _inputs(name, hot=None):
    """(reference cfg, reference MoE params, port cfg, port params, x); with
    ``hot`` the router's column of that expert is pushed towards x's mean,
    so that it takes most tokens and overflows its capacity."""
    rcfg, cfg = r_get_config(name).reduced(), get_config(name).reduced()
    rp = r_moe.init_moe(rcfg, jax.random.PRNGKey(1))
    x = np.random.RandomState(0).randn(B, T, cfg.d_model).astype(np.float32)
    if hot is not None:
        router = np.array(rp["router"])
        router[:, hot] += 20.0 * x.mean((0, 1))
        rp = dict(rp, router=jnp.asarray(router))
    tp = _map(lambda a: torch.from_numpy(np.array(a)), rp)
    return rcfg, rp, cfg, tp, x


def _capacity(cfg):
    return max(1, int(T * cfg.moe.top_k / cfg.moe.num_experts
                      * moe.CAPACITY_FACTOR))


def _routed(cfg, p, x):
    """The port's top-k expert ids (B, T, K) of x."""
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    return moe.top_k(probs, cfg.moe.top_k)[1].numpy()


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= 1e-5 * scale, what


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("train", [False, True], ids=["dropless", "capacity"])
@pytest.mark.parametrize("hot", [None, 0, 3], ids=["plain", "hot0", "hot3"])
def test_apply_moe_matches_reference(name, train, hot):
    rcfg, rp, cfg, tp, x = _inputs(name, hot)
    r_out, r_aux = r_moe.apply_moe(rcfg, rp, jnp.asarray(x), train=train)
    out, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x), train=train)
    _close(out, r_out, f"{name} output")
    assert abs(float(aux) - float(r_aux)) <= 1e-6
    if hot is not None:
        # the hot expert overflows every row, so capacity drops slots (and
        # the output equality above says the same ones in both packages)
        top = _routed(cfg, tp, x).reshape(B, -1)
        assert all(np.bincount(row, minlength=cfg.moe.num_experts)[hot]
                   > _capacity(cfg) for row in top)


def test_top_k_ties_go_to_the_lower_index():
    """Three router columns equal (so every token's probabilities tie
    among them): the port picks the lower indices first, as
    ``lax.top_k``, and the outputs equal the reference's."""
    rcfg, rp, cfg, tp, x = _inputs("olmoe-1b-7b")
    router = np.array(rp["router"])
    router[:, [1, 4, 6]] = router[:, [6]] + 20.0 * x.mean((0, 1))[:, None]
    rp = dict(rp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    probs = np.asarray(jax.nn.softmax(x @ router, axis=-1))
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    got = moe.top_k(torch.from_numpy(probs.copy()), 2)[1].numpy()
    assert (probs[..., 1] == probs[..., 4]).all()
    assert np.array_equal(got, want)
    assert (got == [1, 4]).all(-1).mean() > 0.5     # the tie is on top
    r_out, _ = r_moe.apply_moe(rcfg, rp, jnp.asarray(x))
    out, _ = moe.apply_moe(cfg, tp, torch.from_numpy(x))
    _close(out, r_out, "tied routing")


def _capacity_model(cfg, p, x):
    """numpy model of the training dispatch: per row, slot s keeps its
    expert when fewer than C earlier slots (in slot order) went to it."""
    K, C = cfg.moe.top_k, _capacity(cfg)
    logits = x @ p["router"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = _routed(cfg, p, x)
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w /= top_w.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for b in range(B):
        seen = np.zeros(cfg.moe.num_experts, int)
        for s, e in enumerate(top_e[b].reshape(-1)):
            t, k = divmod(s, K)
            seen[e] += 1
            if seen[e] > C:
                continue
            h = x[b, t] @ p["wi"][e].numpy()
            g = x[b, t] @ p["wg"][e].numpy()
            y = (g / (1 + np.exp(-g)) * h) @ p["wo"][e].numpy()
            out[b, t] += top_w[b, t, k] * y
    return out


def test_last_expert_overflow_is_a_fault_of_the_reference():
    """The last expert takes most tokens: the port equals the numpy model
    of the capacity rule; the reference departs from it exactly at the
    token that holds that expert's last kept slot (slot C - 1) in each
    row, whose output lost that expert's contribution."""
    rcfg, rp, cfg, tp, x = _inputs("olmoe-1b-7b", hot=7)
    want = _capacity_model(cfg, tp, x)
    out, _ = moe.apply_moe(cfg, tp, torch.from_numpy(x), train=True)
    _close(out, want, "port against the capacity model")
    r_out, _ = r_moe.apply_moe(rcfg, rp, jnp.asarray(x), train=True)
    off = np.abs(np.asarray(r_out) - want).max(-1) > 1e-4
    top = _routed(cfg, tp, x).reshape(B, -1)
    for b in range(B):
        (last_kept,) = np.nonzero(top[b] == 7)[0][_capacity(cfg) - 1:
                                                  _capacity(cfg)]
        assert np.nonzero(off[b])[0].tolist() == [last_kept // 2]


def _join_layers(name, mask, shape):
    """A stacked segment leaf's mask OR-ed over its layers: the
    reference's scan rule joins the taints of a scan's iterations over
    its ``xs`` (``repro/core/taint.py:_rule_scan``), so each layer of a
    segment gets the union; the port's graph has every layer's own
    nodes."""
    if not name.startswith("params/segments/"):
        return mask
    m = mask.reshape(shape)
    return np.broadcast_to(m.any(0), shape).reshape(-1)


def test_training_state_participation_matches_reference():
    """The launcher's resume (the next step's loss) on a reduced olmoe
    training state (two layers), batch 2 x 4 tokens (capacity 1, and experts no token
    routes to): participation masks equal to the reference's, bit for bit
    once each segment's layers are joined as the reference's scan joins
    them; per layer, the experts no kept slot routes to are uncritical in
    the port (and so its masks lie inside the reference's); AD ⊆
    participation."""
    # two layers: one segment of two, the reference's scan join still shows
    rcfg, cfg = (dataclasses.replace(c("olmoe-1b-7b").reduced(), n_layers=2)
                 for c in (r_get_config, get_config))
    rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(6)
    moments = [_map(lambda p: jnp.asarray(rng.rand(*p.shape), jnp.float32),
                    rparams) for _ in range(2)]
    data = r_dp.next_batch(rcfg, r_dp.init_state(rcfg, 2, 4))[1]
    r_state = {"params": rparams,
               "opt": {"mu": moments[0], "nu": moments[1],
                       "step": jnp.asarray(1, jnp.int32)},
               "data": data, "step": jnp.asarray(1, jnp.int32)}

    def r_resume(s):   # the next step's metrics["loss"], as in train.py
        b, _ = r_dp.next_batch(rcfg, s["data"])
        return {"loss": r_loss_fn(rcfg, s["params"], b)}

    r_rep = r_participation(r_resume, r_state)
    np_state = _map(np.asarray, r_state)
    np_state["data"]["key"] = np_state["data"]["key"].astype(np.int32)
    state = state_from_numpy(np_state, "cpu")
    resume = launch.make_resume_fn(cfg)
    rep = participation(resume, state, device="cpu")
    assert sorted(rep.leaves) == sorted(r_rep.leaves)
    for leaf in r_rep.leaves:
        got, want = rep[leaf].mask, np.asarray(r_rep[leaf].mask)
        assert np.array_equal(_join_layers(leaf, got, rep[leaf].shape),
                              want), leaf
        assert not (got & ~want).any(), leaf
    wi = rep["params/segments/seg0/u0/moe/wi"]
    per_expert = wi.mask.reshape(wi.shape[:2] + (-1,))
    assert (per_expert.all(-1) | ~per_expert.any(-1)).all()
    assert (~per_expert.any(-1)).any()          # an unrouted expert
    ad = scrutinize(resume, state, device="cpu")
    assert verify_soundness(ad, analyze_static(resume, state,
                                               device="cpu")).ok


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_launcher_trains_the_moe_archs(name, tmp_path):
    """``--arch olmoe-1b-7b`` / ``deepseek-v3-671b --preset smoke``: two
    steps of the loss with its aux term, and a save reduced by
    participation (``--scrutinize``) after the second."""
    losses = launch.main(["--arch", name, "--preset", "smoke", "--steps",
                          "2", "--batch", "2", "--seq", "8", "--ckpt-every",
                          "2", "--log-every", "100", "--scrutinize",
                          "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "ram" / "step_2" / "manifest.json").exists()
