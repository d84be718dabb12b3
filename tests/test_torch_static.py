"""The port's participation, static analyzer and soundness gate on the
paper's eight NPB programs, against the reference's, on the CPU.

One module fixture runs every program once: the port's participation
(``Benchmark.participation``), its static analyzer on the same trace, its
AD scrutiny plain and with ``static_prune=True``, and the reference's
participation (MG's comparison is in ``tests/test_torch_taint.py``, so
the reference's longest walk runs on another worker).  Participation masks
are value-independent apart from concrete indices, so they must be bit for
bit the reference's — no probe RNG stands between the packages — and give
the paper's Table II exactly, FT ``y`` included (4,096 of 266,240, where
the AD mask keeps FFT round-off).  IS's integer leaves get dataflow masks
from the static analyzer, the reference's (checked against its own
``analyze_static``).  Then the launcher: ``--scrutinize`` reduces with
participation through a model whose K6 and K7 are custom-op nodes, and
``--verify-static`` gates the pruned AD scrutiny on the soundness check.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import analyze_static as r_analyze_static
from repro.npb.common import get_benchmark as r_get_benchmark
from repro_torch.analysis import (SoundnessError, StaticReport,
                                  analyze_static, soundness_checker,
                                  verify_soundness)
from repro_torch.core import ScrutinyConfig, scrutinize
from repro_torch.core import criticality
from repro_torch.npb.common import ALL_BENCHMARKS, get_benchmark

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

# Paper Table II (``tests/test_npb_paper.py``), FT y included.
PAPER_TABLE2 = {
    "bt": {"u": (1500, 10140)},
    "sp": {"u": (1500, 10140)},
    "cg": {"x": (2, 1402)},
    "lu": {"u": (1628, 10140), "rho_i": (300, 2028), "qs": (300, 2028),
           "rsd": (1500, 10140)},
    "mg": {"u": (7176, 46480), "r": (10543, 46480)},
    "ft": {"y": (4096, 266240)},
    "ep": {"q": (0, 10), "sx": (0, 1), "sy": (0, 1)},
    "is": {"key_array": (0, 65536), "bucket_ptrs": (0, 512)},
}
# IS's integer leaves by dataflow (``tests/test_static_soundness.py``).
IS_INT_EXPECTED = {"bucket_ptrs": (512, 512), "key_array": (2, 65536)}


@pytest.fixture(scope="module")
def npb():
    out = {}
    for name in ALL_BENCHMARKS:
        b = get_benchmark(name, device="cpu")
        state = b.checkpoint_state()
        part = b.participation()
        static = analyze_static(b.resume, state, device="cpu")
        ad = scrutinize(b.resume, state, device="cpu")
        pruned = scrutinize(b.resume, state, device="cpu",
                            config=ScrutinyConfig(static_prune=True))
        ref = (r_get_benchmark(name).participation() if name != "mg"
               else None)
        out[name] = dict(bench=b, part=part, static=static, ad=ad,
                         pruned=pruned, ref=ref)
    return out


@pytest.mark.parametrize("name", [n for n in sorted(PAPER_TABLE2)
                                  if n != "mg"])
def test_participation_bit_identical_to_reference(npb, name):
    got, want = npb[name]["part"], npb[name]["ref"]
    assert set(got.leaves) == set(want.leaves)
    for var, leaf in want.leaves.items():
        np.testing.assert_array_equal(got[var].mask, leaf.mask,
                                      err_msg=f"{name}({var})")


@pytest.mark.parametrize("name", sorted(PAPER_TABLE2))
def test_participation_gives_table2(npb, name):
    part = npb[name]["part"]
    for var, (unc, tot) in PAPER_TABLE2[name].items():
        assert (part[var].uncritical, part[var].total) == (unc, tot), \
            f"{name}({var})"


@pytest.mark.parametrize("name", sorted(PAPER_TABLE2))
def test_soundness_and_static_equal_participation(npb, name):
    """AD ⊆ static on every swept leaf; static == participation on the
    inexact leaves (one taint walk); AD ⊆ participation everywhere."""
    r = npb[name]
    res = verify_soundness(r["ad"], r["static"])
    assert res.ok and res.checked_leaves + res.skipped_leaves >= 1
    if name != "is":
        assert res.checked_leaves >= 1
    assert isinstance(r["static"], StaticReport)
    for var, leaf in r["part"].leaves.items():
        if leaf.policy.value in ("ad", "horizon"):
            np.testing.assert_array_equal(r["static"][var].mask, leaf.mask)
        assert not (r["ad"][var].mask & ~leaf.mask).any(), f"{name}({var})"


@pytest.mark.parametrize("name", sorted(PAPER_TABLE2))
def test_pruned_sweep_equals_unpruned(npb, name):
    r = npb[name]
    for var, leaf in r["ad"].leaves.items():
        np.testing.assert_array_equal(r["pruned"][var].mask, leaf.mask,
                                      err_msg=f"{name}({var})")
    if name != "is":          # all-integer: no sweep, no prepass
        assert r["pruned"].stats["static_prune_s"] > 0.0


def test_is_integer_dataflow_matches_reference(npb):
    """The AD path can only call IS's integer leaves critical by policy;
    the static analyzer proves ``bucket_ptrs`` and two planted keys
    uncritical, bit for bit the reference's analyzer."""
    static = npb["is"]["static"]
    rb = r_get_benchmark("is")
    want = r_analyze_static(rb.resume, rb.checkpoint_state())
    for var in static.leaves:
        np.testing.assert_array_equal(static[var].mask, want[var].mask,
                                      err_msg=var)
    for var, counts in IS_INT_EXPECTED.items():
        assert (static[var].uncritical, static[var].total) == counts
        assert npb["is"]["ad"][var].uncritical == 0
        assert npb["is"]["part"][var].uncritical == 0
    assert static.provenance["bucket_ptrs"] == []
    assert static.provenance["key_array"][0].op == "aten.clone.default"
    assert verify_soundness(npb["is"]["ad"], static).skipped_leaves == 4


def test_prune_cache_keys_on_index_values():
    """The static prune is cached on a digest of the index-feeding leaves
    only: an equal state hits it, a state whose values feed no index
    hits it too, and one with other index values misses it."""
    def resume(s):
        return {"o": s["x"][s["i"]].sum() + s["y"].sum()}

    cfg = ScrutinyConfig(static_prune=True)
    base = {"x": torch.arange(6.0), "y": torch.ones(3),
            "i": torch.tensor([1, 2])}
    first = scrutinize(resume, base, config=cfg, device="cpu")
    assert not first.stats["static_prune_cached"]
    again = scrutinize(resume, dict(base, y=torch.zeros(3)), config=cfg,
                       device="cpu")
    assert again.stats["static_prune_cached"]
    moved = scrutinize(resume, dict(base, i=torch.tensor([4, 5])),
                       config=cfg, device="cpu")
    assert not moved.stats["static_prune_cached"]
    np.testing.assert_array_equal(moved["x"].mask,
                                  np.arange(6) >= 4)


def test_taint_pruned_leaf_is_flagged_not_checked():
    """A leaf overwritten whole before any read (through an indexed write,
    which the reads walk counts as a read of its base) is pruned on taint
    evidence: the gate lists it instead of counting it as checked, and
    ``check_pruned=True`` re-sweeps it."""
    def resume(s):
        y = s["x"].index_put((torch.arange(4),), torch.full((4,), 2.0))
        return {"o": (y * s["w"]).sum()}

    state = {"x": torch.ones(4), "w": torch.ones(4)}
    cfg = ScrutinyConfig(static_prune=True)
    rep = scrutinize(resume, state, config=cfg, device="cpu")
    assert rep.stats["static_taint_pruned_leaves"] == ["x"]
    res = soundness_checker(resume, config=cfg, device="cpu")(state, rep)
    assert res.ok and res.pruned_leaf_names == ("x",)
    res = soundness_checker(resume, config=cfg, check_pruned=True,
                            device="cpu")(state, rep)
    assert res.ok and res.pruned_leaf_names == ()


def test_violation_names_the_reading_nodes():
    """An AD mask outside the static one raises with the graph nodes that
    read the leaf."""
    def resume(s):
        return {"o": s["x"][:2].sum()}

    state = {"x": torch.ones(4)}
    ad = scrutinize(resume, state, device="cpu")
    bad = dict(ad.leaves)
    leaf = bad["x"]
    forged = dataclasses.replace(
        criticality.LeafReport(leaf.name, leaf.shape, leaf.dtype,
                               leaf.policy, leaf.mask, leaf.table),
        mask=np.ones(4, bool))
    forged_rep = criticality.CriticalityReport({"x": forged})
    with pytest.raises(SoundnessError, match="aten.slice"):
        verify_soundness(forged_rep, analyze_static(resume, state,
                                                    device="cpu"))


@pytest.mark.parametrize("arch,flag", [("recurrentgemma-2b", "--scrutinize"),
                                       ("xlstm-125m", "--verify-static")])
def test_launcher_static_paths(tmp_path, arch, flag):
    """The launcher's smoke run on the CPU: ``--scrutinize`` reduces with
    participation (the moments, which the next step's loss never reads,
    are dropped; the parameters kept whole), ``--verify-static`` runs the
    gated, pruned AD scrutiny instead of raising."""
    from repro_torch.launch.train import main

    d = str(tmp_path)
    losses = main(["--device", "cpu", "--arch", arch, "--preset", "smoke",
                   "--steps", "4", "--batch", "2", "--seq", "16",
                   "--ckpt-every", "2", "--ckpt-dir", d,
                   "--log-every", "100", flag])
    assert len(losses) == 4
    with open(os.path.join(d, "ram", "step_4", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    reduced = {e["name"] for e in leaves if e["encoding"] != "full"}
    moments = {e["name"] for e in leaves
               if e["name"].startswith(("opt/mu/", "opt/nu/"))}
    assert moments and reduced == moments
    assert all(e["num_regions"] == 0 for e in leaves
               if e["name"] in moments)
