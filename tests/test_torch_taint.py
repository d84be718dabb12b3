"""Participation over the aten graph (``repro_torch.core.taint``) against
the reference's over the jaxpr (``repro.core.taint``), on the CPU.

Each case runs the same numpy-made state through a JAX function and its
torch counterpart and compares the two packages' participation masks bit
for bit: reads through slices, write-before-read over a static and a
concrete dynamic window, gather, scatter-add, FFT axes and the FFT
padding plane, matmul, a loop carry and a select (the reference's scan,
while and cond; Python loops unroll in a torch trace), the integer policy.
Beyond the reference's cases: a traced function that calls K6 and K7
holds their custom-op nodes (any→all), a read of memory no recorded op
wrote raises, and NPB MG — the largest graph of the eight programs —
gives the reference's masks (the other seven are in
``tests/test_torch_static.py``; MG sits here so that the two files' long
reference walks run on different workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.configs import get_config as r_get_config
from repro.core.criticality import scrutinize as r_scrutinize
from repro.core.taint import participation as r_participation
from repro.data.pipeline import consume_resume_fn as r_consume_resume_fn
from repro.npb.common import get_benchmark as r_get_benchmark
from repro_torch.core import (UnattributedTensorError, participation,
                              scrutinize, scrutinize_graph_reads,
                              traced_step)
from repro_torch.core.taint import classify_rule
from repro_torch.data.pipeline import consume_resume_fn
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.npb.common import get_benchmark

torch.set_num_threads(1)


def _t_set(x, index, value):
    y = x.clone()
    y[index] = value
    return y


def _t_loop(x):
    c, ys = x, []
    for _ in range(4):
        c = _t_set(c, slice(0, 3), c[0:3] * 1.5)
        ys.append(c[0])
    return {"o": torch.stack(ys).sum()}


def _j_loop(x):
    def body(c, _):
        c = c.at[0:3].set(c[0:3] * 1.5)
        return c, c[0]

    _, ys = jax.lax.scan(body, x, None, length=4)
    return {"o": ys.sum()}


def _t_while(x):
    v = x
    for _ in range(3):
        v = _t_set(v, 0, v[0] + v[1])
    return {"o": v[0]}


def _j_while(x):
    def body(c):
        i, v = c
        return i + 1, v.at[0].set(v[0] + v[1])

    _, v = jax.lax.while_loop(lambda c: c[0] < 3, body, (0, x))
    return {"o": v[0]}


IDX = np.array([1, 4, 4, 8])
W = np.zeros((3, 4))
# name → (state as numpy, reference fn, port fn); both take the state dict
CASES = {
    "slice_read": (
        {"x": np.arange(10.0)},
        lambda s: {"o": s["x"][:7].sum()},
        lambda s: {"o": s["x"][:7].sum()}),
    "write_before_read_static": (
        {"x": np.arange(10.0)},
        lambda s: {"o": (s["x"].at[2:5].set(jnp.zeros(3)) ** 2).sum()},
        lambda s: {"o": (_t_set(s["x"], slice(2, 5), 0.0) ** 2).sum()}),
    "write_before_read_dynamic": (
        {"x": np.arange(10.0), "p": np.asarray(3)},
        lambda s: {"o": jax.lax.dynamic_update_slice(
            s["x"], jnp.zeros(4), (s["p"],)).sum()},
        lambda s: {"o": s["x"].index_put(
            (torch.arange(4) + s["p"],), torch.zeros(4,
                                                     dtype=torch.float64)
        ).sum()}),
    "gather": (
        {"x": np.arange(10.0)},
        lambda s: {"o": s["x"][jnp.asarray(IDX)].sum()},
        lambda s: {"o": s["x"][torch.from_numpy(IDX)].sum()}),
    "scatter_add": (
        {"x": np.arange(10.0)},
        lambda s: {"o": s["x"].at[2:5].add(1.0).sum()},
        lambda s: {"o": _t_set(s["x"], slice(2, 5),
                               s["x"][2:5] + 1.0).sum()}),
    "fft_axes": (
        {"x": np.arange(8.0) + 0j},
        lambda s: {"o": jnp.fft.fft(s["x"])[0]},
        lambda s: {"o": torch.fft.fft(s["x"])[0]}),
    "fft_padding_plane": (
        {"y": np.ones((4, 5), np.complex128)},
        lambda s: {"o": jnp.fft.ifft(s["y"][:, :4]).sum()},
        lambda s: {"o": torch.fft.ifft(s["y"][:, :4]).sum()}),
    "fft_one_axis_of_two": (
        {"y": np.ones((4, 6), np.complex128)},
        lambda s: {"o": jnp.fft.fft(s["y"], axis=-1)[1:3, 0]},
        lambda s: {"o": torch.fft.fft(s["y"], dim=-1)[1:3, 0]}),
    "matmul": (
        {"x": np.arange(3.0)},
        lambda s: {"o": s["x"] @ jnp.asarray(W)},
        lambda s: {"o": s["x"] @ torch.from_numpy(W)}),
    "matmul_rows": (
        {"a": np.ones((5, 3)), "b": np.ones((3, 4))},
        lambda s: {"o": (s["a"] @ s["b"])[1:3, 0]},
        lambda s: {"o": (s["a"] @ s["b"])[1:3, 0]}),
    "loop_carry": (
        {"x": np.arange(6.0)},
        lambda s: _j_loop(s["x"]),
        lambda s: _t_loop(s["x"])),
    "select_unions_branches": (
        {"x": np.arange(4.0)},
        lambda s: {"o": jnp.where(s["x"][0] > 0, s["x"][1], s["x"][2])},
        lambda s: {"o": torch.where(s["x"][0] > 0, s["x"][1], s["x"][2])}),
    "while_carry": (
        {"x": np.arange(4.0)},
        lambda s: _j_while(s["x"]),
        lambda s: _t_while(s["x"])),
    "reduce_max_axis": (
        {"x": np.arange(12.0).reshape(3, 4)},
        lambda s: {"o": jnp.max(s["x"], axis=1)[:2]},
        lambda s: {"o": torch.amax(s["x"], dim=1)[:2]}),
    "cumsum_prefix": (
        {"x": np.arange(8.0)},
        lambda s: {"o": jnp.cumsum(s["x"])[:5].sum()},
        lambda s: {"o": torch.cumsum(s["x"], 0)[:5].sum()}),
    "roll_window": (
        {"x": np.arange(9.0)},
        lambda s: {"o": jnp.roll(s["x"], 2)[:3].sum()},
        lambda s: {"o": torch.roll(s["x"], 2)[:3].sum()}),
    "integer_policy": (
        {"x": np.ones(3), "i": np.asarray(2, np.int32)},
        lambda s: {"o": s["x"].sum()},
        lambda s: {"o": s["x"].sum()}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_masks_match_reference(case):
    np_state, r_fn, t_fn = CASES[case]
    want = r_participation(r_fn, {k: jnp.asarray(v)
                                  for k, v in np_state.items()})
    got = participation(t_fn, {k: torch.from_numpy(np.array(v))
                               for k, v in np_state.items()}, device="cpu")
    for name in np_state:
        np.testing.assert_array_equal(got[name].mask, want[name].mask,
                                      err_msg=f"{case}({name})")


def test_write_before_read_clears_the_window():
    """The paper's central mechanism, spelled out: the overwritten window
    is uncritical, the rest read."""
    got = participation(CASES["write_before_read_static"][2],
                        {"x": torch.arange(10.0, dtype=torch.float64)},
                        device="cpu")["x"].mask
    assert got[:2].all() and not got[2:5].any() and got[5:].all()


def test_broadcast_operand_reads_only_its_rows():
    """A pointwise op ORs the taint over the dimensions an operand was
    broadcast along.  (The reference taints an operand broadcast through a
    size-1 dimension whole: its elementwise rule compares shapes.  Sound,
    coarser; the NPB programs' masks are equal either way.)"""
    def f(s):
        return {"o": (s["x"] * s["y"])[:2, 1:3].sum()}

    rep = participation(f, {"x": torch.arange(3.0).reshape(3, 1),
                            "y": torch.arange(4.0)}, device="cpu")
    np.testing.assert_array_equal(rep["x"].mask, [True, True, False])
    np.testing.assert_array_equal(rep["y"].mask, [False, True, True, False])


def test_grad_subset_of_participation():
    x = np.random.RandomState(0).randn(32)

    def f(s):
        v = s["x"][:24]
        return {"o": torch.tanh(v).sum() + (v[:8] ** 2).sum()}

    state = {"x": torch.from_numpy(x)}
    g = scrutinize(f, state, device="cpu")["x"].mask
    p = participation(f, state, device="cpu")["x"].mask
    assert not (g & ~p).any()
    assert p[:24].all() and not p[24:].any()


def _kernel_step(s):
    a = torch.sigmoid(s["gate"])
    h = lru_scan(a, s["b"])
    o = flash_attention(s["q"], s["k"], s["v"], window=4)
    return {"o": h[:, -1].sum() + o[:, :2].sum()}


def _kernel_state():
    rng = np.random.RandomState(3)
    return {k: torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for k, shape in (("gate", (1, 6, 4)), ("b", (1, 6, 4)),
                             ("q", (1, 5, 2, 8)), ("k", (1, 5, 1, 8)),
                             ("v", (1, 5, 1, 8)), ("unused", (3,)))}


def test_traced_kernels_are_custom_op_nodes():
    """A function that calls K6 and K7 traces to one custom-op node each
    on the CPU too; the walk gives them the any→all rule, so every input
    of attention and of the scan comes out critical."""
    state = _kernel_state()
    ts = traced_step(_kernel_step, state, device="cpu")
    calls = [n for n in ts.gm.graph.nodes if n.op == "call_function"]
    ops = {str(n.target) for n in calls}
    assert {"repro_torch.flash_attention.default",
            "repro_torch.lru_scan.default"} <= ops
    custom = [n for n in calls if str(n.target).startswith("repro_torch.")]
    assert {classify_rule(n) for n in custom} == {"custom_op"}
    rep = participation(_kernel_step, state, device="cpu")
    for name in ("gate", "b", "q", "k", "v"):
        assert rep[name].mask.all(), name
    assert not rep["unused"].mask.any()
    reads = scrutinize_graph_reads(_kernel_step, state, device="cpu")
    assert reads == {"gate": True, "b": True, "q": True, "k": True,
                     "v": True, "unused": False}


def test_unattributed_tensor_raises():
    """A write the tracer cannot see (here through numpy, as a kernel on
    raw pointers would write) leaves an ``empty`` node feeding the output:
    the walk and the reads pre-pass raise instead of calling ``x``
    uncritical."""
    def f(s):
        out = torch.empty(4, dtype=torch.float64)
        out.numpy()[:] = s["x"].detach().numpy()[:4]
        return {"o": (out * 2).sum()}

    state = {"x": torch.arange(6.0, dtype=torch.float64)}
    with pytest.raises(UnattributedTensorError, match="aten.empty"):
        participation(f, state, device="cpu")
    with pytest.raises(UnattributedTensorError):
        scrutinize_graph_reads(f, state, device="cpu")


def test_mg_matches_reference():
    """NPB MG, 6,625 graph nodes (the V-cycle unrolled): the masks of
    both leaves bit for bit the reference's, Table II's counts."""
    got = get_benchmark("mg", device="cpu").participation()
    want = r_get_benchmark("mg").participation()
    for name in ("u", "r", "it"):
        np.testing.assert_array_equal(got[name].mask, want[name].mask,
                                      err_msg=name)
    assert (got["u"].uncritical, got["r"].uncritical) == (7176, 10543)


def _consume_case(scored: bool, lib):
    """The data pipeline's scrutiny target (``consume_resume_fn``: two
    batches popped, the port's pop reads the cursor and the step on the
    host), alone or with a float leaf that scores the popped tokens and
    one that nothing reads."""
    cfg = r_get_config("xlstm-125m").reduced()
    rng = np.random.default_rng(11)
    data = {"key": np.array([0, 7], np.uint32 if lib is jnp else np.int32),
            "step": np.array(3, np.int32),
            "buffer": rng.integers(0, cfg.vocab, (4, 2, 8)).astype(np.int32),
            "cursor": np.array(1, np.int32)}
    state = {"data": data}
    if scored:
        state.update(w=rng.standard_normal(cfg.vocab),
                     unread=rng.standard_normal(5))
    if lib is jnp:
        state = jax.tree_util.tree_map(jnp.asarray, state)
        consume = r_consume_resume_fn(cfg, 2)
    else:
        state = jax.tree_util.tree_map(torch.from_numpy, state)
        consume = consume_resume_fn(cfg, 2)

    def fn(s):
        out = consume(s["data"])
        if scored:
            tok = out["consumed"] if lib is jnp else out["consumed"].long()
            out = dict(out, score=s["w"][tok].sum())
        return out

    return fn, state


@pytest.mark.parametrize("scored", [False, True], ids=["consume", "scored"])
def test_scrutinize_consume_resume_fn_matches_reference(scored):
    """``scrutinize`` with the default config (the reads pre-pass on) takes
    a function that reads state on the host, which no trace can hold: the
    masks equal the reference's, and the unread float leaf skips the
    sweep."""
    fn, state = _consume_case(scored, torch)
    got = scrutinize(fn, state, device="cpu")
    r_fn, r_state = _consume_case(scored, jnp)
    want = r_scrutinize(r_fn, r_state)
    assert set(got.leaves) == set(want.leaves)
    for name in want.leaves:
        np.testing.assert_array_equal(got[name].mask, want[name].mask,
                                      err_msg=name)
    if scored:
        assert got.stats["dead_leaves"] == 1
        assert 0 < got["w"].critical < got["w"].total
        assert not got["unread"].mask.any()


def test_reads_walk_refuses_an_in_place_write_of_a_leaf():
    """The reads walk runs ``fn`` for real: a write into a state leaf
    raises before it happens, so the state is left as it was."""
    state = {"x": torch.arange(4.0, dtype=torch.float64)}

    def f(s):
        s["x"].mul_(2)
        return {"o": s["x"].sum()}

    with pytest.raises(RuntimeError, match="in place"):
        scrutinize_graph_reads(f, state, device="cpu")
    torch.testing.assert_close(state["x"],
                               torch.arange(4.0, dtype=torch.float64))
