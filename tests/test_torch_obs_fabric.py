"""The port's telemetry fabric against the reference's, on the CPU.

* ``DriftTracker``: the records of the port (device words as torch
  tensors, counted with the uint8 table) equal the reference's (jnp words,
  ``population_count``) on the same pairs of reports, host masks too, with
  policy leaves, shape changes and the identical-report fast path;
* the barrier metrics of ``FileCollective`` (success and timeout);
* a coordinated 2-host save fuses per-host fragments into one
  ``telemetry.json`` with drift records, one trace process per host, and
  the port's report CLI renders it; the port's CLI renders the
  reference's ``telemetry.json`` line for line as the reference's CLI
  does; a missing telemetry file is an error.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as r_obs
from repro.checkpoint.coordinator import CoordinatedCheckpointManager as RCoord
from repro.checkpoint import Level as RLevel
from repro.distributed.collective import FileCollective as RFile
from repro.distributed.collective import ProcessContext as RCtx
from repro.obs import report as r_report_mod
from repro.obs.drift import DriftTracker as RDrift
from repro.obs.metrics import MetricsRegistry as RRegistry
from repro.obs.trace import ObsState as RState
import repro_torch.checkpoint as TC
from repro_torch import obs
from repro_torch.convert import report_from_masks, state_from_numpy
from repro_torch.distributed.collective import (BarrierTimeout,
                                                FileCollective,
                                                ProcessContext)
from repro_torch.obs import report as report_mod
from repro_torch.obs.drift import DriftTracker, popcount_sum
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ObsState

torch.set_num_threads(1)


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield obs.get_obs()
    obs.disable()
    obs.reset()


class _Words:
    def __init__(self, mask, torch_side):
        self.n = int(mask.size)
        w = np.packbits(mask)
        self.words_dev = torch.from_numpy(w) if torch_side else jnp.asarray(w)


class _Mask:
    def __init__(self, mask):
        self.n = int(mask.size)
        self.mask = mask


class _Policy:
    def __init__(self, n, critical):
        self.n, self.critical = n, critical


def _leaves(masks, kind, torch_side, policy=None):
    out = {}
    for k, m in masks.items():
        out[k] = _Words(m, torch_side) if kind == "words" else _Mask(m)
    if policy is not None:
        out["p"] = _Policy(7, policy)
    return out


def _sweeps(seed):
    rng = np.random.RandomState(seed)
    m0 = {"w": rng.rand(4096) < 0.3, "b": rng.rand(37) < 0.5,
          "z": np.zeros(9, bool)}
    m1 = {k: v.copy() for k, v in m0.items()}
    m1["w"][::7] ^= True
    m1["b"][3] ^= True
    m2 = dict(m1, b=rng.rand(41) < 0.5)         # b changes shape: "new"
    return [(m0, True), (m1, True), (m2, False)]


@pytest.mark.parametrize("kind", ["words", "mask"])
@pytest.mark.parametrize("seed", [0, 1])
def test_drift_records_equal_reference(kind, seed):
    rt, rr = RDrift(RRegistry(RState(True))), None
    tt = DriftTracker(MetricsRegistry(ObsState(True)))
    for step, (masks, pol) in enumerate(_sweeps(seed)):
        r_rec = rt.observe(_leaves(masks, kind, False, pol), step=step)
        t_rec = tt.observe(_leaves(masks, kind, True, pol), step=step)
        assert t_rec == r_rec, step
    # the same leaves object again: the zero-flip fast path, both sides
    same_r = _leaves(_sweeps(seed)[0][0], kind, False)
    same_t = _leaves(_sweeps(seed)[0][0], kind, True)
    rt.observe(same_r, step=8)
    tt.observe(same_t, step=8)
    assert tt.observe(same_t, step=9) == rt.observe(same_r, step=9)
    assert tt.registry.to_dict()["counters"] == \
        rt.registry.to_dict()["counters"]
    assert len(tt.history) == 5


def test_drift_identical_report_fast_path_and_popcount():
    rng = np.random.RandomState(3)
    leaves = {"w": _Mask(rng.rand(512) < 0.4)}
    tracker = DriftTracker(MetricsRegistry(ObsState(True)))
    first = tracker.observe(leaves, step=1)
    again = tracker.observe(leaves, step=2)
    assert again["total_flips"] == 0
    assert again["leaves"]["w"]["critical_count"] == \
        first["leaves"]["w"]["critical_count"]
    x = torch.from_numpy(rng.randint(0, 256, 100003).astype(np.uint8))
    assert int(popcount_sum(x)) == int(np.unpackbits(x.numpy()).sum())


def test_drift_on_a_device_report(tmp_path):
    """A scrutiny ``DeviceReport`` (resident words) feeds the tracker
    through the manager's save when telemetry is on."""
    from repro_torch import ScrutinyConfig, scrutinize
    state = {"w": torch.randn(300), "k": torch.arange(5)}
    obs.reset()
    obs.enable()
    try:
        rep = scrutinize(lambda s: (s["w"][:100] ** 2).sum(), state,
                         config=ScrutinyConfig(probes=1), device="cpu")
        with TC.CheckpointManager([TC.Level(str(tmp_path))],
                                  scrutiny_fn=lambda s: rep,
                                  device="cpu") as mgr:
            mgr.save(1, state, block=True)
            rec = mgr.obs.drift.last
    finally:
        obs.disable()
        obs.reset()
    assert rec["leaves"]["w"]["critical_count"] == 100
    assert rec["leaves"]["w"]["new"]


def test_barrier_metrics_success(obs_on, tmp_path):
    bundles = [obs.scoped(p) for p in range(2)]
    errors = [None, None]

    def host(p):
        try:
            coll = FileCollective(str(tmp_path), ctx=ProcessContext(p, 2),
                                  timeout_s=30)
            coll.obs = bundles[p]
            coll.barrier("sync", timeout=30)
        except BaseException as e:            # pragma: no cover
            errors[p] = e

    ts = [threading.Thread(target=host, args=(p,)) for p in range(2)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert errors == [None, None]
    for p in range(2):
        snap = bundles[p].registry.to_dict()
        assert snap["histograms"]["barrier.wait_s"]["count"] == 1
        assert {k for k in snap["gauges"]
                if k.startswith("barrier.arrival_gap_s.")} == \
            {"barrier.arrival_gap_s.host0", "barrier.arrival_gap_s.host1"}


def test_barrier_timeout_records_arrivals(obs_on, tmp_path):
    coll = FileCollective(str(tmp_path), ctx=ProcessContext(0, 2),
                          timeout_s=30)
    coll.obs = obs_on
    with pytest.raises(BarrierTimeout) as ei:
        coll.barrier("alone", timeout=0.3)
    assert ei.value.arrivals == {0: 0.0}
    snap = obs_on.registry.to_dict()
    assert snap["counters"]["barrier.timeouts"] == 1
    assert snap["histograms"]["barrier.wait_s"]["count"] == 1


def _np_state(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(512, 8).astype(np.float32),
            "b": rng.randn(40).astype(np.float32),
            "step": np.asarray(7, np.int32)}


def _masks():
    rng = np.random.RandomState(1)
    return {"w": rng.rand(512 * 8) < 0.4, "b": rng.rand(40) < 0.4}


def test_coordinated_fusion_and_report_cli(obs_on, tmp_path, capsys):
    root, coord = str(tmp_path / "lv"), str(tmp_path / "rdv")
    errors = [None, None]

    def host(p):
        try:
            coll = FileCollective(coord, ctx=ProcessContext(p, 2),
                                  timeout_s=30)
            st0 = state_from_numpy(_np_state(0), "cpu")
            rep = report_from_masks(_masks(), st0)
            mgr = TC.CoordinatedCheckpointManager(
                [TC.Level(root, keep_n=3)], collective=coll,
                scrutiny_fn=lambda s: rep, save_mode="device", device="cpu")
            mgr.save(1, st0)
            mgr.wait()
            mgr.save(2, state_from_numpy(_np_state(2), "cpu"))
            mgr.wait()
            mgr.close()
        except BaseException as e:            # pragma: no cover
            errors[p] = e

    ts = [threading.Thread(target=host, args=(p,)) for p in range(2)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert errors == [None, None]
    with open(os.path.join(root, "step_2", "telemetry.json")) as f:
        doc = json.load(f)
    assert sorted(doc["hosts"]) == ["0", "1"] and doc["step"] == 2
    for p, frag in doc["hosts"].items():
        assert {e["pid"] for e in frag["spans"]} <= {int(p)}
        assert frag["drift"], p
        assert frag["published"].get("save"), p
    merged = report_mod.merge_trace(doc)
    real = [e for e in merged["traceEvents"] if e["ph"] != "M"]
    assert len({(e["pid"], e["tid"]) for e in real}) >= 3
    assert {e["pid"] for e in real} == {0, 1}
    trace_out = str(tmp_path / "trace.json")
    assert report_mod.main([root, "--trace-out", trace_out]) == 0
    rendered = capsys.readouterr().out
    assert "save timeline" in rendered and "criticality drift" in rendered
    assert "host 0" in rendered and "host 1" in rendered
    with open(trace_out) as f:
        assert json.load(f)["traceEvents"]


def test_port_cli_renders_reference_telemetry_as_reference_cli(tmp_path,
                                                               capsys):
    """The reference's coordinated ``telemetry.json``: the port's CLI gives
    the reference CLI's timeline, drift table and metrics line for line."""
    root, coord = str(tmp_path / "lv"), str(tmp_path / "rdv")
    errors = [None, None]
    masks = _masks()

    def host(p):
        try:
            from repro.core.criticality import CriticalityReport, LeafReport
            from repro.core.policy import LeafPolicy
            from repro.core.regions import RegionTable
            leaves = {k: LeafReport(
                name=k, shape=_np_state(0)[k].shape,
                dtype=np.dtype(np.float32), policy=LeafPolicy.AD, mask=m,
                table=RegionTable.from_mask(m, 4), magnitude=None)
                for k, m in masks.items()}
            rep = CriticalityReport(leaves=leaves)
            coll = RFile(coord, ctx=RCtx(p, 2), timeout_s=30)
            mgr = RCoord([RLevel(root, keep_n=3)], collective=coll,
                         scrutiny_fn=lambda s: rep, save_mode="device",
                         pack_use_kernel=False, pack_interpret=True)
            mgr.save(1, {k: jnp.asarray(v) for k, v in _np_state(0).items()})
            mgr.close()
        except BaseException as e:            # pragma: no cover
            errors[p] = e

    r_obs.reset()
    r_obs.enable()
    try:
        ts = [threading.Thread(target=host, args=(p,)) for p in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    finally:
        r_obs.disable()
        r_obs.reset()
    assert errors == [None, None]
    step = os.path.join(root, "step_1")
    assert r_report_mod.main([step]) == 0
    want = capsys.readouterr().out
    assert report_mod.main([step]) == 0
    got = capsys.readouterr().out
    assert "criticality drift" in got
    assert got == want
    with open(os.path.join(step, "telemetry.json")) as f:
        doc = json.load(f)
    assert report_mod.merge_trace(doc) == r_report_mod.merge_trace(doc)


def test_report_cli_missing_telemetry(tmp_path, capsys):
    assert report_mod.main([str(tmp_path)]) == 2
    assert "no telemetry.json" in capsys.readouterr().out
