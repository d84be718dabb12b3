"""The port's AD scrutiny against the reference's, word for word.

Each program of ``tests/test_core_criticality.py`` (plus the stencil of
``examples/quickstart.py``) has a torch twin; both packages scrutinize the
same numpy-made state and their masks must agree bit for bit.  The two
packages draw probe cotangents from different generators, so only the
structural zeros decide a mask — which is what the paper's definition asks.
Within the port, the device and host engines agree word for word; the
``tests/test_device_scrutiny.py`` matrix (f32/bf16/f64/int32 × 0/3/50/100%)
is repeated against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScrutinyConfig as RConfig
from repro.core import scrutinize as r_scrutinize
from repro_torch.convert import state_from_numpy
from repro_torch.core import (DeviceReport, LeafPolicy, ScrutinyConfig,
                              scrutinize)

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _words(rep, name):
    return np.packbits(np.asarray(rep[name].mask, bool)).tobytes()


def _agree(j_fn, t_fn, np_state, probes=3):
    """Scrutinize the twins on the same state; assert the reference, the
    port's device engine and the port's host engine agree bit for bit.
    Returns the port's device report."""
    r = r_scrutinize(j_fn, jax.tree_util.tree_map(jnp.asarray, np_state),
                     config=RConfig(probes=probes))
    t_state = state_from_numpy(np_state, "cpu")
    d = scrutinize(t_fn, t_state, config=ScrutinyConfig(probes=probes),
                   device="cpu")
    h = scrutinize(t_fn, t_state,
                   config=ScrutinyConfig(probes=probes, engine="host"),
                   device="cpu")
    assert isinstance(d, DeviceReport) and not isinstance(h, DeviceReport)
    assert set(d.leaves) == set(r.leaves)
    for name in r.leaves:
        assert _words(d, name) == _words(r, name), name
        assert d[name].mask_words.tobytes() == _words(h, name), name
        assert d[name].critical == h[name].critical == r[name].critical
        assert d[name].policy.value == r[name].policy.value
    return d


def test_slice_pattern_bt_style():
    u = np.ones((4, 5, 5, 3), np.float32)
    d = _agree(lambda s: jnp.sum(s["u"][:, :4, :4, :] ** 2),
               lambda s: (s["u"][:, :4, :4, :] ** 2).sum(), {"u": u})
    m = d["u"].mask.reshape(4, 5, 5, 3)
    assert m[:, :4, :4, :].all() and not m[:, 4].any() and not m[:, :, 4].any()


def test_write_before_read_is_uncritical():
    def j_fn(s):
        new = jnp.arange(4, dtype=jnp.float32)
        return jnp.sum(jax.lax.dynamic_update_slice(s["cache"], new, (8,)))

    def t_fn(s):
        c = s["cache"]
        new = torch.arange(4, dtype=torch.float32)
        return torch.cat([c[:8], new, c[12:]]).sum()

    d = _agree(j_fn, t_fn, {"cache": np.ones(16, np.float32)})
    assert not d["cache"].mask[8:12].any() and d["cache"].critical == 12


def test_integer_state_always_critical():
    state = {"x": np.ones(3, np.float32), "step": np.asarray(5, np.int32),
             "flags": np.zeros(4, bool)}
    d = _agree(lambda s: jnp.sum(s["x"]) * 1.0, lambda s: s["x"].sum() * 1.0,
               state)
    assert d["step"].policy == LeafPolicy.ALWAYS_CRITICAL
    assert d["flags"].critical == 4


def test_multiplicative_zero_vs_structural_zero():
    w = np.array([1.0, 0.0, 2.0], np.float32)
    d = _agree(lambda s: jnp.sum(s["x"] * w),
               lambda s: (s["x"] * torch.from_numpy(w)).sum(),
               {"x": np.ones(3, np.float32)})
    np.testing.assert_array_equal(d["x"].mask, [True, False, True])


def test_probe_union_defeats_single_cotangent_cancellation():
    d = _agree(lambda s: {"a": s["x"][0], "b": -s["x"][0], "c": s["x"][1]},
               lambda s: {"a": s["x"][0], "b": -s["x"][0], "c": s["x"][1]},
               {"x": np.ones(2, np.float32)})
    assert d["x"].mask.all()


def test_complex_leaf_ft_style():
    y = (np.ones((3, 3, 5)) + 1j * np.ones((3, 3, 5))).astype(np.complex64)
    d = _agree(lambda s: jnp.sum(jnp.abs(s["y"][:, :, :4]) ** 2),
               lambda s: (s["y"][:, :, :4].abs() ** 2).sum(), {"y": y})
    assert d["y"].uncritical == 9


def test_through_a_loop():
    """The NPB main-loop shape: a carried value over several iterations
    (``lax.scan`` in the reference, a Python loop in the port)."""
    def j_fn(s):
        def body(carry, _):
            return carry * 1.01 + s["bias"][:2].sum(), None
        out, _ = jax.lax.scan(body, s["x0"], None, length=5)
        return out

    def t_fn(s):
        carry = s["x0"]
        for _ in range(5):
            carry = carry * 1.01 + s["bias"][:2].sum()
        return carry

    d = _agree(j_fn, t_fn, {"x0": np.asarray(1.0, np.float32),
                            "bias": np.ones(4, np.float32)})
    np.testing.assert_array_equal(d["bias"].mask, [True, True, False, False])


def test_quickstart_stencil():
    rng = np.random.RandomState(0)
    state = {"u": rng.randn(13, 13).astype(np.float32),
             "step": np.asarray(3, np.int32)}

    def j_fn(s):
        u = s["u"]
        for _ in range(3):
            core = u[:12, :12]
            lap = (jnp.roll(core, 1, 0) + jnp.roll(core, -1, 0)
                   + jnp.roll(core, 1, 1) + jnp.roll(core, -1, 1) - 4 * core)
            u = u.at[:12, :12].add(0.1 * lap)
        return {"norm": jnp.sqrt((u[:12, :12] ** 2).sum())}

    def t_fn(s):
        u = s["u"]
        for _ in range(3):
            core = u[:12, :12]
            lap = (torch.roll(core, 1, 0) + torch.roll(core, -1, 0)
                   + torch.roll(core, 1, 1) + torch.roll(core, -1, 1)
                   - 4 * core)
            top = torch.cat([core + 0.1 * lap, u[:12, 12:]], dim=1)
            u = torch.cat([top, u[12:]], dim=0)
        return {"norm": torch.sqrt((u[:12, :12] ** 2).sum())}

    d = _agree(j_fn, t_fn, state)
    assert d["u"].critical == 144 and d["step"].critical == 1


def test_magnitudes_kept_for_tiering():
    def fn(s):
        return 100.0 * s["x"][0] + 0.001 * s["x"][1] + 0.0 * s["x"][2]

    d = _agree(fn, fn, {"x": np.ones(3, np.float32)})
    mag = d["x"].magnitude
    assert mag[0] > mag[1] > 0 and mag[2] == 0


@pytest.mark.parametrize("seed", range(6))
def test_masked_sum_criticality(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 64))
    sel = rng.rand(n) > 0.5
    x = rng.randn(n).astype(np.float32) + 3.0
    d = _agree(lambda s: jnp.sum(jnp.where(jnp.asarray(sel), s["x"], 0.0) ** 2),
               lambda s: (torch.where(torch.from_numpy(sel), s["x"],
                                      torch.zeros(())) ** 2).sum(),
               {"x": x})
    np.testing.assert_array_equal(d["x"].mask, sel)


@pytest.mark.parametrize("n,k", [(4, 1), (17, 9), (48, 48)])
def test_prefix_read(n, k):
    d = _agree(lambda s: jnp.sum(s["x"][:k] ** 2 + s["x"][:k]),
               lambda s: (s["x"][:k] ** 2 + s["x"][:k]).sum(),
               {"x": np.ones(n, np.float32)})
    np.testing.assert_array_equal(d["x"].table.regions, [[0, k]])
    # the device words wrap as a BitMask with zero tail bits
    assert d["x"].mask_words.size == (n + 7) // 8
    assert d["x"].bitmask().count() == k == d["x"].critical


def test_no_differentiable_output_raises():
    with pytest.raises(ValueError, match="no differentiable outputs"):
        scrutinize(lambda s: {"count": torch.tensor(3)},
                   {"x": torch.ones(2)}, device="cpu")


@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_device_matches_host_with_jitter(jitter):
    state = {"x": torch.zeros(40), "y": torch.arange(5.0)}

    def fn(s):
        return torch.relu(s["x"]).sum() + (s["y"][:3] ** 2).sum()

    cfg = dict(probes=4, input_jitter=jitter, seed=7)
    d = scrutinize(fn, state, config=ScrutinyConfig(**cfg), device="cpu")
    h = scrutinize(fn, state, config=ScrutinyConfig(engine="host", **cfg),
                   device="cpu")
    for name in state:
        assert d[name].mask_words.tobytes() == _words(h, name)
    # x sits in relu's dead zone: only jittered probes move off it
    assert d["x"].mask.any() == (jitter > 0)


# --------------------------------------------------------------------------
# the tests/test_device_scrutiny.py matrix
# --------------------------------------------------------------------------

def _sel(n, frac, seed=0):
    if frac in (0.0, 1.0):
        return np.full(n, frac == 1.0)
    sel = np.zeros(n, bool)
    k = max(1, int(round(n * frac)))
    sel[np.random.RandomState(seed).choice(n, k, replace=False)] = True
    return sel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64", "int32"])
@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
def test_dtype_density_matrix(dtype, frac):
    n = 1037                                    # odd: padded words
    rng = np.random.RandomState(1)
    sel = _sel(n, frac)
    if dtype == "int32":
        x = jnp.asarray(rng.randint(-2 ** 30, 2 ** 30, n), jnp.int32)
    else:
        x = jnp.asarray(1.0 + rng.rand(n), getattr(jnp, dtype))
    np_state = {"x": np.asarray(x), "y": rng.randn(17).astype(np.float32),
                "step": np.asarray(3, np.int32)}
    wj = jnp.asarray(sel, x.dtype if dtype != "int32" else jnp.float32)
    wt = state_from_numpy({"w": np.asarray(wj)}, "cpu")["w"]

    def j_fn(s):
        if s["x"].dtype == jnp.int32:
            return jnp.sum(s["x"].astype(jnp.float32)) * 0.0 + s["y"].sum()
        return jnp.sum((s["x"] * wj).astype(jnp.float32)) + s["y"].sum()

    def t_fn(s):
        if s["x"].dtype == torch.int32:
            return s["x"].float().sum() * 0.0 + s["y"].sum()
        return (s["x"] * wt).float().sum() + s["y"].sum()

    d = _agree(j_fn, t_fn, np_state, probes=2)
    if dtype == "int32":
        assert d["x"].mask.all()
    else:
        np.testing.assert_array_equal(d["x"].mask, sel)


def test_device_report_lazy_d2h_and_reuse():
    state = {"a": torch.ones(3000), "b": torch.ones(10),
             "i": torch.tensor(2)}

    def fn(s):
        return (s["a"][:1000] ** 2).sum() + s["b"].sum()

    r1 = scrutinize(fn, state, device="cpu")
    before = r1.stats["d2h_bytes"]
    assert before == 4 * (3 + 1)              # per-tile count summaries
    r1["a"].mask                                # noqa: B018 - lazy D2H
    assert r1.stats["d2h_bytes"] == before + 375
    r2 = scrutinize(fn, state, device="cpu")
    assert r2.reuse_unchanged(r1) is r1        # nothing changed: same object
    r3 = scrutinize(lambda s: (s["a"][:999] ** 2).sum() + s["b"].sum(),
                    state, device="cpu")
    merged = r3.reuse_unchanged(r1)
    assert merged is not r1 and merged.leaves["b"] is r1.leaves["b"]
    assert merged.leaves["a"] is r3.leaves["a"]
    assert r3.stats["changed_leaves"] == 1
