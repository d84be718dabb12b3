"""The rest of the port's ``CheckpointManager`` against the reference's, on
the CPU: re-scrutiny (``rescrutinize_every`` with
``DeviceReport.reuse_unchanged``), precision tiers, ``delta_chunk_bytes``,
``io_chunk_bytes`` / ``io_threads``, ``writer_ttl_s``, the
``soundness_check`` hook, the device engine's save with no report
(``dev_raw``) and leaves with no critical element.  The same numpy-made
state and masks go through both packages and the step directories are
compared file by file.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
import repro.core as R
from repro.core.criticality import CriticalityReport as RReport
from repro.core.criticality import LeafReport as RLeaf
from repro.core.policy import LeafPolicy as RPolicy
from repro.core.policy import PrecisionPolicy as RPrecision
from repro.core.policy import PrecisionTier as RTier
from repro.core.regions import RegionTable as RTable
import repro_torch.checkpoint as TC
from repro_torch import ScrutinyConfig, scrutinize
from repro_torch._tensors import to_host
from repro_torch.convert import report_from_masks, state_from_numpy
from repro_torch.core.criticality import (CriticalityReport, DeviceReport,
                                          LeafReport)
from repro_torch.core.policy import (LeafPolicy, PrecisionPolicy,
                                     PrecisionTier)
from repro_torch.core.regions import RegionTable

torch.set_num_threads(1)


def _state(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(40, n // 40).astype(np.float32),
            "b": rng.randn(n // 8).astype(np.float32),
            "s": np.asarray(5, np.int32)}


def _masks(np_state, frac=0.3, seed=1):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(v.size) < frac for k, v in np_state.items()
            if v.dtype != np.int32}


def _r_report(np_state, masks, mags=None):
    leaves = {}
    for name, leaf in np_state.items():
        m = masks.get(name, np.ones(leaf.size, bool))
        leaves[name] = RLeaf(
            name=name, shape=tuple(leaf.shape), dtype=np.dtype(leaf.dtype),
            policy=RPolicy.AD, mask=m,
            table=RTable.from_mask(m, np.dtype(leaf.dtype).itemsize),
            magnitude=None if mags is None else mags.get(name))
    return RReport(leaves=leaves)


def _t_report(np_state, masks, mags):
    leaves = {}
    for name, leaf in np_state.items():
        m = masks.get(name, np.ones(leaf.size, bool))
        dt = str(leaf.dtype)
        leaves[name] = LeafReport(
            name=name, shape=tuple(leaf.shape), dtype=dt, policy=LeafPolicy.AD,
            mask=m, table=RegionTable.from_mask(m, leaf.dtype.itemsize),
            magnitude=mags.get(name))
    return CriticalityReport(leaves=leaves)


def _j(np_state):
    return {k: jnp.asarray(v) for k, v in np_state.items()}


def _tree_bytes(d, step):
    sd = os.path.join(d, f"step_{step}")
    out = {}
    for f in sorted(os.listdir(sd)):
        with open(os.path.join(sd, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _kind(mgr):
    return list(mgr.last_save_stats["levels"].values())[0]["kind"]


def test_constructor_takes_the_reference_arguments(tmp_path):
    import inspect
    ref = set(inspect.signature(RC.CheckpointManager).parameters)
    port = set(inspect.signature(TC.CheckpointManager).parameters)
    # the Pallas switches have no counterpart: the kernel follows the
    # tensor's device, and there is no interpret mode
    assert ref - port == {"pack_use_kernel", "pack_interpret"}
    assert port - ref == {"device"}
    with pytest.raises(ValueError, match="io_threads"):
        TC.CheckpointManager([TC.Level(str(tmp_path))], io_threads=0,
                             device="cpu")


@pytest.mark.parametrize("engine", ["host", "device"])
def test_rescrutinize_kinds_match_reference(tmp_path, engine):
    """A fresh report every second save breaks the chain in both packages
    alike (``tests/test_delta.py``'s new-report case), and the step
    directories stay byte-identical."""
    np_state = _state()
    masks = _masks(np_state)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    t_state = state_from_numpy(np_state, "cpu")
    level = dict(keep_n=20, max_chain=10)
    with RC.CheckpointManager([RC.Level(dr, **level)],
                              scrutiny_fn=lambda s: _r_report(np_state,
                                                              masks),
                              rescrutinize_every=2,
                              save_mode="device") as rm, \
            TC.CheckpointManager(
                [TC.Level(dt, **level)],
                scrutiny_fn=lambda s: report_from_masks(masks, t_state),
                rescrutinize_every=2, pipeline_engine=engine,
                device="cpu") as tm:
        kinds_r, kinds_t = [], []
        for step in range(1, 6):
            rm.save(step, _j(np_state), block=True)
            tm.save(step, t_state, block=True)
            kinds_r.append(_kind(rm))
            kinds_t.append(_kind(tm))
            assert _tree_bytes(dr, step) == _tree_bytes(dt, step), step
    assert kinds_t == kinds_r == ["base", "delta", "base", "delta", "base"]


def test_manager_incremental_rescrutiny(tmp_path):
    """``tests/test_device_scrutiny.py``'s case on the port: an unchanged
    re-scrutiny keeps the identical report object (so the chain stays a
    delta), a changed one reuses the unchanged leaves' objects, and the
    masks equal the reference's."""
    n = 512
    rng = np.random.RandomState(7)
    np_state = {"x": rng.randn(n).astype(np.float32),
                "gate": (rng.rand(n) < 0.5).astype(np.float32),
                "step": np.asarray(1, np.int32)}

    def resume(s):
        return torch.sum(s["x"] * s["gate"])

    mgr = TC.CheckpointManager(
        [TC.Level(str(tmp_path / "lv"), keep_n=5, max_chain=3)],
        scrutiny_fn=lambda s: scrutinize(resume, s,
                                         config=ScrutinyConfig(probes=2),
                                         device="cpu"),
        rescrutinize_every=1, pipeline_engine="device", device="cpu")
    state = state_from_numpy(np_state, "cpu")
    mgr.save(1, state, block=True)
    rep1 = mgr._report
    assert isinstance(rep1, DeviceReport)
    mgr.save(2, state, block=True)
    assert mgr._report is rep1
    assert _kind(mgr) == "delta"
    assert mgr.last_scrutiny_stats["reused_leaves"] == len(rep1.leaves)
    assert mgr.last_scrutiny_stats["changed_leaves"] == 0
    new_gate = np_state["gate"].copy()
    new_gate[:n // 4] = 1.0 - new_gate[:n // 4]
    state2 = dict(state, gate=torch.from_numpy(new_gate))
    mgr.save(3, state2, block=True)
    rep3 = mgr._report
    assert rep3 is not rep1 and _kind(mgr) == "base"
    assert rep3.leaves["gate"] is rep1.leaves["gate"]
    assert rep3.leaves["step"] is rep1.leaves["step"]
    assert rep3.leaves["x"] is not rep1.leaves["x"]
    assert mgr.last_scrutiny_stats["changed_leaves"] == 1
    mgr.close()

    def r_resume(s):
        return jnp.sum(s["x"] * s["gate"])

    r_state2 = dict(_j(np_state), gate=jnp.asarray(new_gate))
    want = R.scrutinize(r_resume, r_state2, config=R.ScrutinyConfig(probes=2))
    for name in np_state:
        np.testing.assert_array_equal(rep3[name].mask, want[name].mask)


TIERS_R = RPrecision(tiers=(RTier(quantile=0.5, dtype=None),
                            RTier(quantile=1.0, dtype=jnp.bfloat16)))
TIERS_T = PrecisionPolicy(tiers=(PrecisionTier(quantile=0.5, dtype=None),
                                 PrecisionTier(quantile=1.0,
                                               dtype="bfloat16")))


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("dense", [True, False], ids=["all", "masked"])
def test_precision_tiers_byte_identical(tmp_path, engine, dense):
    """``tests/test_checkpoint.py``'s tiered leaf (4096 f32, magnitudes
    from ``RandomState(1)``) through both managers: the same step
    directory, a host encode whatever the engine, and a round trip within
    the bf16 tier's error."""
    arr = np.random.RandomState(0).randn(4096).astype(np.float32)
    mag = np.abs(np.random.RandomState(1).randn(4096))
    np_state = {"x": arr, "s": np.asarray(3, np.int32)}
    masks = {"x": (np.ones(4096, bool) if dense
                   else np.random.RandomState(2).rand(4096) < 0.6)}
    mags = {"x": mag}
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    with RC.CheckpointManager([RC.Level(dr)], precision=TIERS_R,
                              scrutiny_fn=lambda s: _r_report(
                                  np_state, masks, mags)) as rm, \
            TC.CheckpointManager([TC.Level(dt)], precision=TIERS_T,
                                 scrutiny_fn=lambda s: _t_report(
                                     np_state, masks, mags),
                                 pipeline_engine=engine, device="cpu") as tm:
        rm.save(1, _j(np_state), block=True)
        tm.save(1, state_from_numpy(np_state, "cpu"), block=True)
        assert tm.last_save_stats["engine"] == "host"
        assert tm.last_save_stats["host_reason"] == "tiered"
    assert _tree_bytes(dr, 1) == _tree_bytes(dt, 1)
    leaf = [e for e in TC.read_manifest(dt, 1)["leaves"]
            if e["name"] == "x"][0]
    assert leaf["tier_dtypes"]
    with TC.CheckpointManager([TC.Level(dt)], device="cpu") as tm:
        _, got = tm.restore({"x": torch.zeros(4096),
                             "s": torch.zeros((), dtype=torch.int32)})
    assert tm.last_restore_stats["device_leaves"] == 0   # host expand
    out = to_host(got["x"])
    m = masks["x"]
    err = np.abs(out[m] - arr[m]) / np.maximum(np.abs(arr[m]), 1e-6)
    assert err.max() < 1 / 64 and (out[~m] == 0).all()


def test_tiered_save_is_the_one_host_engine_on_the_card(tmp_path,
                                                        monkeypatch):
    """On the card a "host" mode raises unless it comes from precision."""
    mgr = TC.CheckpointManager([TC.Level(str(tmp_path))], precision=TIERS_T,
                               device="cpu")
    monkeypatch.setattr(mgr, "device", torch.device("cuda"))
    mgr._check_mode("save engine", "host", tiered=True)
    with pytest.raises(ValueError, match="host"):
        mgr._check_mode("save engine", "host")
    mgr.close()


@pytest.mark.parametrize("opts", [
    dict(delta_chunk_bytes=512),
    dict(io_chunk_bytes=1000, io_threads=1),
    dict(delta_chunk_bytes=3000, io_chunk_bytes=333, io_threads=3),
], ids=["delta512", "io1000x1", "both"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_chunk_options_byte_identical(tmp_path, opts, engine):
    """A delta chain with non-default chunk sizes and io pool: the same
    step directories as the reference's with the same options."""
    np_state = _state(seed=3)
    masks = _masks(np_state, 0.4, seed=4)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    level = dict(keep_n=5, max_chain=3, shards=2, parity=True)
    w = np_state["w"].reshape(-1).copy()
    t_state = state_from_numpy(np_state, "cpu")
    rep_t = report_from_masks(masks, t_state)
    rep_r = _r_report(np_state, masks)
    with RC.CheckpointManager([RC.Level(dr, **level)],
                              scrutiny_fn=lambda s: rep_r,
                              save_mode="device", **opts) as rm, \
            TC.CheckpointManager([TC.Level(dt, **level)],
                                 scrutiny_fn=lambda s: rep_t,
                                 pipeline_engine=engine, device="cpu",
                                 **opts) as tm:
        for step in (1, 2, 3):
            cur = dict(np_state, w=w.reshape(40, 100))
            rm.save(step, _j(cur), block=True)
            tm.save(step, state_from_numpy(cur, "cpu"), block=True)
            assert _kind(tm) == _kind(rm) == ("base" if step == 1
                                              else "delta")
            assert _tree_bytes(dr, step) == _tree_bytes(dt, step), step
            w = w.copy()
            w[np.flatnonzero(masks["w"])[:9]] += step
    chunk = opts.get("delta_chunk_bytes", 2048)
    man = TC.read_manifest(dt, 3)
    assert {e["chunk_bytes"] for e in man["leaves"]} == {chunk}


@pytest.mark.parametrize("ttl", [50.0, 600.0])
def test_writer_ttl_sweeps_a_stale_foreign_tmp_dir(tmp_path, ttl):
    """A foreign writer's tmp dir whose liveness file is 100 s old is swept
    under ``writer_ttl_s=50`` and kept under the default 600, in both
    packages."""
    kept = {}
    for pkg, state in (("r", {"x": jnp.ones(3)}),
                       ("t", {"x": torch.ones(3)})):
        d = str(tmp_path / pkg)
        foreign = os.path.join(d, ".tmp_step_9.abcdef01")
        os.makedirs(foreign)
        alive = os.path.join(foreign, ".alive")
        open(alive, "w").close()
        old = time.time() - 100.0
        os.utime(alive, (old, old))
        os.utime(foreign, (old, old))
        if pkg == "r":
            with RC.CheckpointManager([RC.Level(d)],
                                      writer_ttl_s=ttl) as mgr:
                mgr.save(1, state, block=True)
        else:
            with TC.CheckpointManager([TC.Level(d)], writer_ttl_s=ttl,
                                      device="cpu") as mgr:
                mgr.save(1, state, block=True)
        kept[pkg] = os.path.isdir(foreign)
    assert kept["t"] == kept["r"] == (ttl > 100.0)


def test_raising_soundness_check_writes_nothing(tmp_path):
    calls = []

    def check(state, report):
        calls.append(report)
        raise AssertionError("unsound report")

    np_state = _state()
    t_state = state_from_numpy(np_state, "cpu")
    rep = report_from_masks(_masks(np_state), t_state)
    d = str(tmp_path)
    with TC.CheckpointManager([TC.Level(d)], scrutiny_fn=lambda s: rep,
                              soundness_check=check, device="cpu") as mgr:
        with pytest.raises(AssertionError, match="unsound"):
            mgr.save(1, t_state, block=True)
        assert mgr._report is None and mgr.latest() is None
    assert calls == [rep]
    assert not [e for e in os.listdir(d) if "step" in e]


@pytest.mark.parametrize("layout", [(1, False), (3, True)])
def test_no_report_save_takes_dev_raw(tmp_path, layout):
    """The device engine saves every leaf of an unscrutinized save as a
    device clone (``dev_raw``), streamed to the writer, and writes the
    bytes of the reference's full save (``test_save_checkpoint_byte_
    identical``'s full case)."""
    shards, parity = layout
    np_state = _state(seed=5)
    np_state["h"] = np.random.RandomState(6).randn(777).astype(np.float32)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    RC.save_checkpoint(dr, 1, _j(np_state), shards=shards, parity=parity)
    t_state = state_from_numpy(np_state, "cpu")
    with TC.CheckpointManager([TC.Level(dt, shards=shards, parity=parity)],
                              pipeline_engine="device",
                              io_chunk_bytes=700, device="cpu") as tm:
        tm.save(1, t_state, block=True)
        stats = tm.last_save_stats
    assert stats["engine"] == "device" and stats["mode"] == "device"
    assert stats["host_reason"] is None and stats["packed_leaves"] == 0
    assert stats["d2h_bytes"] == sum(v.nbytes for v in np_state.values())
    assert _tree_bytes(dr, 1) == _tree_bytes(dt, 1)


def test_zero_critical_leaves_cost_no_mask_work(tmp_path):
    """A device report's leaf with no critical element: the save reads
    none of its words (no D2H beyond the swept leaf's), the restore sends
    no mask bits for it, and the step directory is the reference's."""
    rng = np.random.RandomState(8)
    np_state = {"x": rng.randn(3000).astype(np.float32),
                "mu": rng.randn(30, 100).astype(np.float32),
                "step": np.asarray(2, np.int32)}
    gate = (rng.rand(3000) < 0.3).astype(np.float32)

    def resume(s):
        # mu is read (so swept) with a zero weight: all its gradients are 0
        return (torch.sum(s["x"] * torch.from_numpy(gate))
                + torch.sum(s["mu"] * 0.0))

    t_state = state_from_numpy(np_state, "cpu")
    rep = scrutinize(resume, t_state, device="cpu")
    assert rep["mu"].critical == 0 and rep["mu"].words_dev is not None
    d2h0 = rep.stats["d2h_bytes"]
    dt, dr = str(tmp_path / "t"), str(tmp_path / "r")
    with TC.CheckpointManager([TC.Level(dt)], scrutiny_fn=lambda s: rep,
                              pipeline_engine="device", device="cpu") as tm:
        tm.save(1, t_state, block=True)
    # only x's words crossed (for its regions and aux); mu's stayed put
    assert rep.stats["d2h_bytes"] - d2h0 == (3000 + 7) // 8
    masks = {"x": gate != 0, "mu": np.zeros(3000, bool)}
    RC.save_checkpoint(dr, 1, _j(np_state), report=_r_report(np_state, masks))
    assert _tree_bytes(dr, 1) == _tree_bytes(dt, 1)
    with TC.CheckpointManager([TC.Level(dt)], device="cpu") as tm:
        _, got = tm.restore({k: torch.ones_like(v)
                             for k, v in t_state.items()})
        stats = tm.last_restore_stats
    crit = int(masks["x"].sum())
    assert stats["device_leaves"] == 2
    assert stats["h2d_bytes"] == crit * 4 + (3000 + 7) // 8 + 4
    assert (to_host(got["mu"]) == 0).all()
    np.testing.assert_array_equal(to_host(got["x"])[masks["x"]],
                                  np_state["x"][masks["x"]])
