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
  does; a missing telemetry file is an error;
* spans on ``torch.profiler``'s clock (a span contains the profiler's
  event once converted), each ``X`` event's own id and its enclosing
  span's as ``args.parent`` (one thread, across threads, inside a stage),
  the null singletons with tracing off, and the restore's and the
  retention's spans at their call sites.
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
from repro_torch.obs import trace
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


# --------------------------------------------------------------------------
# spans: the profiler's clock, parents, call sites
# --------------------------------------------------------------------------

def test_spans_share_the_profilers_clock(obs_on):
    """An obs span around a ``record_function`` range contains the
    profiler's event once its ``ts`` is put back on the profiler's clock,
    and ``to_ns`` inverts ``ts`` exactly."""
    buf = obs_on.buffer
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with obs_on.tracer.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    [ev] = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "inner"]
    [sp] = [e for e in buf.events_since(0) if e.get("name") == "outer"]
    lo, hi = buf.to_ns(sp["ts"]), buf.to_ns(sp["ts"] + sp["dur"])
    assert lo <= ev.start_ns() <= ev.end_ns() <= hi
    for t in (buf.epoch_ns, trace.clock_ns(), buf.epoch_ns + 3 * 10 ** 12 + 7):
        assert buf.to_ns((t - buf.epoch_ns) / 1e3) == t


def test_nested_spans_carry_their_parent(obs_on):
    tr = obs_on.tracer

    def worker():
        with tr.span("w.outer"):
            with tr.span("w.inner"):
                pass

    with tr.span("outer"):
        with tr.span("mid"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with tr.span("leaf"):
                pass
        h = tr.begin("job")
        with h.stage("stage"):
            with tr.span("in_stage"):
                pass
        h.finish()
    assert not t.is_alive()
    ev = {e["name"]: e for e in obs_on.buffer.events_since(0)
          if e["ph"] == "X"}
    ids = {n: e["id"] for n, e in ev.items()}
    assert len(set(ids.values())) == len(ids) and h.id not in ids.values()
    assert "parent" not in ev["outer"]["args"]
    assert ev["mid"]["args"]["parent"] == ids["outer"]
    assert ev["leaf"]["args"]["parent"] == ids["mid"]
    # another thread keeps a stack of its own
    assert "parent" not in ev["w.outer"]["args"]
    assert ev["w.inner"]["args"]["parent"] == ids["w.outer"]
    # a stage keeps its handle; a span inside it points at the stage
    assert ev["stage"]["args"]["parent"] == h.id
    assert ev["in_stage"]["args"]["parent"] == ids["stage"]
    assert obs_on.buffer.open_spans() == []


def test_tracing_off_returns_the_null_singletons():
    obs.reset()
    obs.disable()
    bundle = obs.get_obs()
    n0 = len(bundle.buffer)
    assert bundle.tracer.span("x", a=1) is trace._NULL_SPAN
    assert bundle.tracer.begin("y") is trace._NULL_HANDLE
    with bundle.tracer.span("x"):
        assert bundle.buffer.open_spans() == []
    assert len(bundle.buffer) == n0


def test_restore_and_retention_spans(obs_on, tmp_path):
    """A device-mode restore: ``restore.step`` is the parent of the read
    and of each leaf's words, copies and K4 launch; each save's
    ``save.retention`` says what the sweep listed, read and removed."""
    st = state_from_numpy(_np_state(0), "cpu")
    rep = report_from_masks(_masks(), st)
    chained = TC.CheckpointManager(
        [TC.Level(str(tmp_path / "chain"), keep_n=1, max_chain=4)],
        scrutiny_fn=lambda s: rep, save_mode="device",
        restore_mode="device", device="cpu")
    plain = TC.CheckpointManager(
        [TC.Level(str(tmp_path / "plain"), keep_n=1)],
        scrutiny_fn=lambda s: rep, save_mode="device", device="cpu")
    for step in range(3):
        for mgr in (chained, plain):
            mark = obs_on.buffer.mark()
            mgr.save(step, st, block=True)
            [ret] = [e for e in obs_on.buffer.events_since(mark)
                     if e.get("name") == "save.retention"]
            kept = min(step, 1) if mgr is plain else step
            assert ret["args"] == {"steps_listed": kept + 1,
                                   "manifests_read": 1,
                                   "removed": min(step, 1) * (mgr is plain)}
            stages = mgr.last_save_stats["stages"]
            assert stages["retention_s"] >= 0
    plain.close()
    mark = obs_on.buffer.mark()
    step, out = chained.restore(st)
    chained.close()
    assert step == 2
    for k, v in _np_state(0).items():
        m = _masks().get(k)
        got = out[k].numpy()
        np.testing.assert_array_equal(got if m is None else got.reshape(-1)[m],
                                      v if m is None else v.reshape(-1)[m])
    ev = [e for e in obs_on.buffer.events_since(mark) if e["ph"] == "X"]
    [root] = [e for e in ev if e["name"] == "restore.step"]
    kids = [e for e in ev if e["args"].get("parent") == root["id"]]
    names = {e["name"] for e in kids}
    assert {"restore.read", "restore.mask", "restore.h2d",
            "restore.scatter"} <= names <= {
        "restore.read", "restore.mask", "restore.h2d", "restore.scatter",
        "restore.expand"}
    assert len(kids) == len(ev) - 1          # nothing nests deeper
    h2d = [e["args"] for e in kids if e["name"] == "restore.h2d"]
    assert sum(a["bytes"] for a in h2d) <= \
        chained.last_restore_stats["h2d_bytes"]
    # the chain walk reads the payload into a writable buffer, which moves
    # without a host copy; the stored mask crosses under restore.mask, not
    # here
    assert all(a["bytes"] > 0 == a["host_copy_bytes"] for a in h2d)
    assert chained.last_restore_stats["host_copy_bytes"] == 0
    masks = [e["args"] for e in kids if e["name"] == "restore.mask"
             and "regions" in e["args"]]
    assert len(masks) == len(_masks())
    assert all(a["elements"] > 0 for a in masks)
    assert chained.last_restore_stats["mask_words"] == {
        "regions_on_card": 0, "bitmap_aux": len(_masks())}
