"""The port's NPB programs (``repro_torch.npb``) against the reference's.

Both packages run the same eight class-S programs on the CPU.  The AD
masks are bit-identical for every leaf except FT ``y``, whose off-lattice
bits are FFT round-off (ROADMAP Queue 3): there the 4,096 frequencies the
checksum reads exactly must be critical and the padding plane ``kx = 64``
uncritical in both.  The Table II counts, the storage accounting of Table
III, the rendered tables, the programs' outputs and the step directories
written for the FT and IS states under one mask are held against the
reference's.  The §IV-C restart matrix runs on the port alone, in
``test_torch_npb_restart.py``.
"""

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
from repro.core import report as r_report
from repro.npb.common import get_benchmark as r_get_benchmark
from repro.npb.common import verify_restart as r_verify_restart
import repro_torch.checkpoint as TC
from repro_torch import _tree
from repro_torch._tensors import itemsize, to_host
from repro_torch.convert import state_from_numpy
from repro_torch.core import report as t_report
from repro_torch.core.criticality import CriticalityReport, LeafReport
from repro_torch.core.policy import LeafPolicy
from repro_torch.core.regions import RegionTable
from repro_torch.npb import ALL_BENCHMARKS, get_benchmark
from repro_torch.npb import common as t_common
from repro_torch.npb.ft import lattice_mask

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

NAMES = ["bt", "cg", "ep", "ft", "is", "lu", "mg", "sp"]

# tests/test_npb_paper.py:16-31 (Table II, corrected for the published
# rho_i/rsd row swap); the AD engine's FT(y) is checked on its own below.
PAPER_TABLE2 = {
    "bt": {"u": (1500, 10140)},
    "sp": {"u": (1500, 10140)},
    "cg": {"x": (2, 1402)},
    "lu": {"u": (1628, 10140), "rho_i": (300, 2028), "qs": (300, 2028),
           "rsd": (1500, 10140)},
    "mg": {"u": (7176, 46480), "r": (10543, 46480)},
    "ft": {"sums": (3, 6)},
    "ep": {"q": (0, 10), "sx": (0, 1), "sy": (0, 1)},
    "is": {"key_array": (0, 65536), "bucket_ptrs": (0, 512)},
}

# Outputs and states: |port - reference| <= RTOL * max(|reference|, 1), the
# form of Benchmark.verify at 1e-4 of its 1e-8: the two packages sum in
# another order (CG's 200 CG steps and EP's 64 chunk sums lose the most,
# 3.4e-14 and 2.4e-14 of a value here).  IS is integer: exact.
RTOL = 1e-12


class _Runs:
    """Each program and its AD report in both packages, made on first use
    and shared by the tests of this module."""

    def __init__(self):
        self._cache = {}

    def __getitem__(self, name):
        if name not in self._cache:
            rb = r_get_benchmark(name)
            tb = get_benchmark(name, device="cpu")
            self._cache[name] = (rb, rb.scrutinize(), tb, tb.scrutinize())
        return self._cache[name]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    return dict(_tree.flatten_with_names(tree)[0])


def _port_report(r_rep, state) -> CriticalityReport:
    """A port report holding the reference report's masks and policies."""
    leaves = {}
    for name, leaf in _named(state).items():
        r_leaf = r_rep[name]
        dt = str(np.dtype(r_leaf.dtype))
        mask = np.asarray(r_leaf.mask, bool)
        leaves[name] = LeafReport(
            name=name, shape=tuple(leaf.shape), dtype=dt,
            policy=LeafPolicy(r_leaf.policy.value), mask=mask,
            table=RegionTable.from_mask(mask, itemsize(dt)))
    return CriticalityReport(leaves=leaves)


def _close(port, ref, name):
    port, ref = to_host(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    if port.dtype.kind in "iub":
        # IS's ``in_order`` is int64 in the reference (jnp.sum of int32
        # under x64) and int32 in the port, as every IS output is
        assert ref.dtype.kind in "iub", name
        np.testing.assert_array_equal(port, ref, err_msg=name)
        return
    assert port.dtype == ref.dtype, name
    err = np.abs(port - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max(initial=0.0) <= RTOL, (name, float(err.max()))


def test_registry_matches_reference():
    from repro.npb.common import ALL_BENCHMARKS as R_ALL
    assert list(ALL_BENCHMARKS) == list(R_ALL) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_ad_masks_match_reference(runs, name):
    _, r_rep, _, t_rep = runs[name]
    assert sorted(t_rep.leaves) == sorted(r_rep.leaves)
    for leaf, t_leaf in t_rep.leaves.items():
        r_leaf = r_rep[leaf]
        assert t_leaf.shape == tuple(r_leaf.shape), leaf
        assert t_leaf.dtype == str(np.dtype(r_leaf.dtype)), leaf
        assert t_leaf.policy.value == r_leaf.policy.value, leaf
        if (name, leaf) == ("ft", "y"):
            continue                        # round-off, checked below
        assert t_leaf.mask.tobytes() == np.asarray(r_leaf.mask).tobytes(), \
            leaf


def test_ft_y_mask_structure(runs):
    """FT ``y``: the checksum reads the lattice ``j·(5, 3, 1) mod 64``, so
    exactly the 4,096 frequencies with ``(5·kz + 3·ky + kx) mod 64 == 0``
    reach it with an O(1) gradient; the padding plane kx = 64 is never
    read.  Everything else is round-off of the FFT, whose bits differ
    between the packages (the reference: 56,176 critical)."""
    _, r_rep, _, t_rep = runs["ft"]
    lattice = lattice_mask()
    pad = (np.arange(64 * 64 * 65) % 65) == 64
    assert lattice.sum() == 4096 and pad.sum() == 4096
    for rep in (r_rep, t_rep):
        mask = np.asarray(rep["y"].mask)
        assert mask[lattice].all() and not mask[pad].any()
    assert r_rep["y"].critical == 56176
    assert 4096 <= t_rep["y"].critical <= 266240 - 4096


@pytest.mark.parametrize("name", NAMES)
def test_table2_counts(runs, name):
    _, r_rep, _, t_rep = runs[name]
    for var, (unc, tot) in PAPER_TABLE2[name].items():
        assert (t_rep[var].uncritical, t_rep[var].total) == (unc, tot), var
        assert (r_rep[var].uncritical, r_rep[var].total) == (unc, tot), var


@pytest.mark.parametrize("name", NAMES)
def test_storage_accounting_matches_reference(runs, name):
    """Table III: ``paper_storage_saved`` (payload only) and
    ``storage_saved`` (with the aux structures) equal the reference's, on
    the port's own report where the masks agree and, for every program,
    on the reference's masks."""
    _, r_rep, tb, t_rep = runs[name]
    reps = [_port_report(r_rep, tb.checkpoint_state())]
    if name != "ft":
        reps.append(t_rep)
    for rep in reps:
        assert rep.paper_storage_saved == r_rep.paper_storage_saved
        assert rep.storage_saved == r_rep.storage_saved
        assert (rep.full_bytes, rep.payload_bytes, rep.optimized_bytes) == \
            (r_rep.full_bytes, r_rep.payload_bytes, r_rep.optimized_bytes)


@pytest.mark.parametrize("name", NAMES)
def test_tables_render_identically(runs, name):
    _, r_rep, tb, t_rep = runs[name]
    rep = _port_report(r_rep, tb.checkpoint_state()) if name == "ft" \
        else t_rep
    assert t_report.summary_table(rep, name) == \
        r_report.summary_table(r_rep, name)
    assert t_report.storage_table(rep, name) == \
        r_report.storage_table(r_rep, name)
    for leaf in rep.leaves:
        assert t_report.leaf_lines(rep[leaf]) == \
            r_report.leaf_lines(r_rep[leaf])
        if not rep[leaf].shape:
            continue                # both render 1-D and up only
        assert t_report.render_distribution(rep[leaf].mask,
                                            rep[leaf].shape) == \
            r_report.render_distribution(r_rep[leaf].mask,
                                         r_rep[leaf].shape)


@pytest.mark.parametrize("name", NAMES)
def test_states_and_outputs_match_reference(runs, name):
    rb, _, tb, _ = runs[name]
    r_state, t_state = rb.checkpoint_state(), tb.checkpoint_state()
    r_named = _named(_np_tree(r_state))
    t_named = _named(t_state)
    assert sorted(r_named) == sorted(t_named)
    for leaf in t_named:
        _close(t_named[leaf], r_named[leaf], f"{name} state {leaf}")
    for tag, t_out, r_out in (
            ("resume", tb.resume(t_state), rb.resume(r_state)),
            ("reference", tb.reference(), rb.reference())):
        t_o, r_o = _named(t_out), _named(_np_tree(r_out))
        assert sorted(t_o) == sorted(r_o)
        for leaf in t_o:
            _close(t_o[leaf], r_o[leaf], f"{name} {tag} {leaf}")
    assert tb.verify(tb.resume(t_state), tb.reference())


@pytest.mark.parametrize("name,corrupt", [("bt", "uncritical"),
                                          ("ft", "uncritical"),
                                          ("lu", "critical"),
                                          ("ft", "critical")])
def test_corruption_hits_the_same_elements(runs, name, corrupt):
    """``verify_restart`` draws the garbage and the corrupted indices from
    ``RandomState(seed)`` in the reference's order: under the same masks
    both packages hand ``resume`` the same state."""
    rb, r_rep, tb, _ = runs[name]
    seen = {}

    def capture(tag, fn, bench):
        def resume(state):
            seen[tag] = _named(_np_tree(state) if tag == "r"
                               else {k: to_host(v) for k, v in
                                     _named(state).items()})
            return fn(state)
        bench.resume = resume

    r_resume, t_resume = rb.resume, tb.resume
    capture("r", r_resume, rb)
    capture("t", t_resume, tb)
    try:
        # the reference's verify_restart takes the reference state, so the
        # port's takes the same values
        r_state = _np_tree(rb.checkpoint_state())
        t_ckpt = tb.checkpoint_state
        tb.checkpoint_state = lambda: state_from_numpy(r_state, "cpu")
        t_rep = _port_report(r_rep, tb.checkpoint_state())
        r_ok = r_verify_restart(rb, r_rep, corrupt=corrupt, seed=5)
        t_ok = t_common.verify_restart(tb, t_rep, corrupt=corrupt, seed=5)
    finally:
        rb.resume, tb.resume = r_resume, t_resume
        tb.checkpoint_state = t_ckpt
    assert r_ok == t_ok == (corrupt == "uncritical")
    for leaf, v in seen["r"].items():
        assert seen["t"][leaf].tobytes() == np.asarray(v).tobytes(), leaf


def _tree_bytes(root, step):
    import os
    d = os.path.join(root, f"step_{step}")
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("name", ["ft", "is"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_step_directory_byte_identical(runs, tmp_path, name, engine):
    """The FT (complex128, f64 padding plane) and IS (int32 only) states,
    saved under the reference's AD masks: the port's step directory equals
    the reference's file by file, and it restores to the critical values
    with zeros elsewhere."""
    rb, r_rep, _, _ = runs[name]
    r_state = rb.checkpoint_state()
    np_state = _np_tree(r_state)
    t_state = state_from_numpy(np_state, "cpu")
    t_rep = _port_report(r_rep, t_state)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    with RC.CheckpointManager([RC.Level(dr, keep_n=1)],
                              scrutiny_fn=lambda s: r_rep,
                              save_mode="device") as rm:
        rm.save(1, r_state, block=True)
    with TC.CheckpointManager([TC.Level(dt, keep_n=1)],
                              scrutiny_fn=lambda s: t_rep,
                              pipeline_engine=engine, device="cpu") as tm:
        tm.save(1, t_state, block=True)
        step, got = tm.restore({k: torch.empty_like(v)
                                for k, v in t_state.items()})
    assert _tree_bytes(dr, 1) == _tree_bytes(dt, 1)
    assert step == 1
    for leaf, v in np_state.items():
        mask = np.asarray(r_rep[leaf].mask).reshape(v.shape)
        want = np.where(mask, v, np.zeros((), v.dtype))
        assert to_host(got[leaf]).tobytes() == want.tobytes(), leaf


def test_participation_waits_for_item_8(runs):
    """Item 8 has landed: ``Benchmark.participation`` gives the
    reference's masks (all eight programs: ``tests/test_torch_static.py``
    and ``tests/test_torch_taint.py``)."""
    rb, _, tb, _ = runs["bt"]
    got, want = tb.participation(), rb.participation()
    for name, leaf in want.leaves.items():
        np.testing.assert_array_equal(got[name].mask, leaf.mask)
    assert (got["u"].uncritical, got["u"].total) == (1500, 10140)


def test_get_benchmark_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_benchmark("bt")
    assert get_benchmark("bt", device="cpu").device.type == "cpu"
