"""The port's host format layer against the reference: BitMask words,
RegionTable runs and storage accounting, pytree leaf names and order,
dtype names and host copies, policies, and the obs stats freezing.

Inputs are made by numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regions as r_regions
from repro.core.bitset import BitMask as RBitMask
from repro.core.criticality import _path_str
from repro_torch import _tensors, _tree
from repro_torch.core import regions as t_regions
from repro_torch.core.bitset import BitMask as TBitMask
from repro_torch.core.policy import LeafPolicy, default_leaf_policy
from repro_torch.obs import FrozenStats, MetricsRegistry, ObsState

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

SIZES = [0, 1, 7, 8, 9, 63, 65, 1000, 4099]
DENSITIES = [0.0, 0.03, 0.5, 0.97, 1.0]


def _mask(n, frac, seed):
    if frac in (0.0, 1.0):
        return np.full(n, frac == 1.0)
    return np.random.RandomState(seed).rand(n) < frac


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("frac", DENSITIES)
def test_bitmask_words_match_reference(n, frac):
    a = _mask(n, frac, seed=n)
    b = _mask(n, 0.4, seed=n + 1)
    ra, rb = RBitMask.from_bool(a), RBitMask.from_bool(b)
    ta, tb = TBitMask.from_bool(a), TBitMask.from_bool(b)
    assert ta.words.tobytes() == ra.words.tobytes()
    assert ta.count() == ra.count() and ta.all() == ra.all()
    assert (ta | tb).words.tobytes() == (ra | rb).words.tobytes()
    assert (ta & tb).words.tobytes() == (ra & rb).words.tobytes()
    assert TBitMask.full(n).words.tobytes() == RBitMask.full(n).words.tobytes()
    back = TBitMask.from_words(ra.words, n)
    np.testing.assert_array_equal(back.to_bool(), a)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_region_table_matches_reference(n, frac, itemsize):
    mask = _mask(n, frac, seed=3 * n + itemsize)
    rt = r_regions.RegionTable.from_mask(mask, itemsize)
    tt = t_regions.RegionTable.from_mask(mask, itemsize)
    assert tt.regions.tobytes() == rt.regions.tobytes()
    for attr in ("num_regions", "critical_count", "uncritical_count",
                 "full_bytes", "payload_bytes", "region_aux_bytes",
                 "bitmap_aux_bytes", "aux_encoding", "aux_bytes",
                 "optimized_bytes", "storage_saved", "uncritical_rate"):
        assert getattr(tt, attr) == getattr(rt, attr), attr
    words = np.packbits(mask)
    tw = t_regions.RegionTable.from_words(words, n, itemsize)
    assert tw.regions.tobytes() == rt.regions.tobytes()
    flat = np.random.RandomState(n).randn(n)
    pay_r = r_regions.pack_with_regions(flat, rt.regions)
    pay_t = t_regions.pack_with_regions(flat, tt.regions)
    assert pay_t.tobytes() == pay_r.tobytes()
    assert t_regions.unpack_with_regions(pay_t, tt.regions, n, 7).tobytes() \
        == r_regions.unpack_with_regions(pay_r, rt.regions, n, 7).tobytes()
    assert t_regions.regions_to_indices(tt.regions).tobytes() == \
        r_regions.regions_to_indices(rt.regions).tobytes()


def _trees():
    a = np.arange(3.0)
    return [
        {"b": a, "a": {"z": a, "c": [a, (a, a)], "b": a}},
        {"10": a, "9": a, "x": [a, {"q": a, "p": a}]},
        [a, (a, {"k": a}), None, {"j": None, "i": a}],
        a,
        {"only": {"nested": {"deep": a}}},
    ]


@pytest.mark.parametrize("i", range(len(_trees())))
def test_tree_names_and_order_match_jax(i):
    tree = _trees()[i]
    ref_flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    names, leaves = zip(*_tree.flatten_with_names(tree)[0])
    assert list(names) == [_path_str(p) for p, _ in ref_flat]
    assert all(x is y for x, (_, y) in zip(leaves, ref_flat))


@pytest.mark.parametrize("i", range(len(_trees())))
def test_tree_unflatten_roundtrip(i):
    tree = _trees()[i]
    named, treedef = _tree.flatten_with_names(tree)
    back = _tree.unflatten(treedef, [l for _, l in named])
    ref = jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_structure(back) == ref


DTYPES = [(torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16),
          (torch.float32, jnp.float32), (torch.int32, jnp.int32),
          (torch.bool, jnp.bool_), (torch.uint8, jnp.uint8),
          (torch.complex64, jnp.complex64)]


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_dtype_names_and_host_bits_match_reference(tdt, jdt):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(37) * 10, jdt)
    ref_host = np.asarray(x)
    assert _tensors.dtype_name(tdt) == str(x.dtype)
    assert _tensors.itemsize(str(x.dtype)) == ref_host.itemsize
    t = _tensors.from_host(ref_host.view(np.uint8).view(
        _tensors.host_dtype(str(x.dtype))), str(x.dtype))
    assert t.dtype == tdt
    host = _tensors.to_host(t)
    assert host.tobytes() == ref_host.tobytes()
    assert np.shares_memory(_tensors.to_host(t, copy=True), host) is False


def test_zero_dim_leaves_stay_zero_dim():
    t = _tensors.from_host(np.asarray(7, np.int32), "int32")
    assert t.shape == () and int(t) == 7
    assert _tensors.fill_host(1.5, "bfloat16") == np.uint16(0x3FC0)


@pytest.mark.parametrize("leaf,policy", [
    (torch.ones(2), LeafPolicy.AD),
    (torch.ones(2, dtype=torch.bfloat16), LeafPolicy.AD),
    (torch.ones(2, dtype=torch.float64), LeafPolicy.AD),
    (torch.ones(2, dtype=torch.complex64), LeafPolicy.AD),
    (torch.ones(2, dtype=torch.int32), LeafPolicy.ALWAYS_CRITICAL),
    (torch.ones(2, dtype=torch.bool), LeafPolicy.ALWAYS_CRITICAL),
    (np.ones(2, np.float32), LeafPolicy.AD),
    (3, LeafPolicy.ALWAYS_CRITICAL),
])
def test_default_leaf_policy(leaf, policy):
    assert default_leaf_policy(leaf) is policy


def test_published_stats_are_frozen():
    reg = MetricsRegistry(ObsState(False))
    live = {"a": 1, "stages": {"pack_s": 0.5}, "levels": {"d": {"k": [1]}}}
    snap = reg.publish("save", live)
    live["stages"]["pack_s"] = 9.0
    assert isinstance(snap, FrozenStats)
    assert snap["stages"]["pack_s"] == 0.5
    with pytest.raises(TypeError):
        snap["a"] = 2
