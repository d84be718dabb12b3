"""The readers of the program's spans on synthetic windows, and the traced
run's attribution of idle and device time to the program's spans on
synthetic intervals and correlation ids."""

import types

import pytest

from portbench.tests import tiny  # noqa: F401  (puts src/ on the path)
from portbench import bench
from portbench.serving import Window
from portbench.spantrace import SpanSummary, innermost, program_spans


def _read(name, window):
    return bench.reader(name)(types.SimpleNamespace(window=window,
                                                    trace=None))


def _restore_window(spans=True):
    """Two restores of 10 s: read 1, two leaves of words 1.5 each, copies
    1 each, K4 0.25 each, one host expand 0.5: 6 s spanned, 4 s self."""
    w = Window(1.0)
    for _ in range(2):
        w.add("ops", "restore", 10.0)
        if not spans:
            continue
        w.add("program", "span.restore.step", 9.5)
        w.add("program", "span.restore.read", 1.0)
        for _ in range(2):
            w.add("program", "span.restore.mask", 1.5)
            w.add("program", "span.restore.h2d", 1.0)
            w.add("program", "span.restore.scatter", 0.25)
        w.add("program", "span.restore.expand", 0.5)
    return w


def test_restore_readers_sum_a_restores_spans():
    w = _restore_window()
    assert _read("mask_s", w) == pytest.approx(3.0)
    assert _read("h2d_s", w) == pytest.approx(2.0)
    assert _read("restore_self_s", w) == pytest.approx(9.5 - 7.0)
    # a program without the spans: nothing to read, and no error
    for name in ("mask_s", "h2d_s", "restore_self_s"):
        assert _read(name, _restore_window(spans=False)) is None
        assert _read(name, Window(1.0)) is None


def _snapshot_window(retention=True):
    """Two delta snapshots and a rebase: the rebase's spans are in the
    window's spans, its stats are not."""
    w = Window(1.0)
    w.add("ops", "snapshot", 0.050)
    w.add("ops", "rebase", 2.0)
    w.add("ops", "snapshot", 0.040)
    rows = [(0.001, 0.020, 0.005, 0.003), (0.002, 0.010, 0.006, 0.004)]
    for blocked, delta, write, ret in rows:
        w.add("program", "save.blocked_s", blocked)
        w.add("program", "save.stages.delta_s", delta)
        w.add("program", "save.stages.write_s", write)
        if retention:
            w.add("program", "save.stages.retention_s", ret)
    for v in (0.003, 0.5, 0.004):
        w.add("program", "span.save.retention", v)
    return w


def test_snapshot_readers_take_delta_snapshots_alone():
    w = _snapshot_window()
    assert _read("retention_ms", w) == pytest.approx(3.5)
    # (50 - 29) and (40 - 22) ms
    assert _read("save_unspanned_ms", w) == pytest.approx(19.5)
    for name in ("retention_ms", "save_unspanned_ms"):
        assert _read(name, _snapshot_window(retention=False)) is None
        assert _read(name, Window(1.0)) is None


def test_innermost_takes_the_program_then_the_latest_start():
    pieces = innermost([("p", 0, 10), ("q", 2, 4), ("r", 3, 5)],
                       [("bench", 1, 12)])
    assert pieces == [("p", 0, 2), ("q", 2, 3), ("r", 3, 5), ("p", 5, 10),
                      ("bench", 10, 12)]
    assert innermost([], []) == []


def _summary(extra=()):
    """Window 0-100 ns.  Device: A 10-20 launched at 5, B 50-60 launched at
    45, C 70-80 with no launch record.  The benchmark's ``restore`` 0-90;
    the program's step 2-88, mask 3-30, h2d 40-65."""
    dev = [("A", 10, 20, 1), ("B", 50, 60, 2), ("C", 70, 80, 3)] + list(extra)
    launches = {1: 5, 2: 45, 4: 64, 99: 0}
    program = [("restore.step", 2, 88), ("restore.mask", 3, 30),
               ("restore.h2d", 40, 65), ("gone", -20, -10)]
    return SpanSummary(dev, [("restore", 0, 90)], (0, 100), program,
                       launches)


def test_idle_seconds_by_innermost_span():
    got = dict((n, v) for n, v in _summary().idle_by_span())
    want = {"restore": 4, "restore.step": 24, "restore.mask": 17,
            "restore.h2d": 15, "other": 10}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(70 / 1e9)


def test_device_seconds_by_launching_span():
    got = dict((n, v) for n, v in _summary().device_by_launch())
    assert got == pytest.approx({"restore.mask": 10 / 1e9,
                                 "restore.h2d": 10 / 1e9,
                                 "restore.step": 10 / 1e9})


def test_operations_run_inside_the_span_that_launched_them():
    s = _summary(extra=[("B2", 62, 70, 4)])       # launched at 64 in h2d
    assert s.inside("restore.h2d", "B") == {"launched": 2, "inside": 1,
                                            "outside_ns": 5}
    assert s.inside("restore.mask", "") == {"launched": 1, "inside": 1,
                                            "outside_ns": 0}
    assert s.inside("restore.step", "") == {"launched": 4, "inside": 4,
                                            "outside_ns": 0}


def test_program_spans_on_the_profilers_clock():
    from repro_torch.obs.trace import ObsState, TraceBuffer
    buf = TraceBuffer(ObsState(True))
    buf.add({"ph": "X", "name": "a", "ts": 1.5, "dur": 2.25})
    buf.add({"ph": "b", "name": "h", "ts": 0.0, "id": 1})
    assert program_spans(buf) == [("a", buf.epoch_ns + 1500,
                                   buf.epoch_ns + 3750)]
    assert program_spans(buf, mark=1) == []
    # a program whose spans are on another clock gives none
    assert program_spans(types.SimpleNamespace(events_since=buf.events_since)
                         ) == []


def test_a_cpu_trace_names_its_gaps_by_the_programs_spans():
    import torch
    from repro_torch import obs
    from portbench.spantrace import Tracer
    tr = Tracer(torch.device("cpu"))
    tr.start()
    try:
        with obs.get_obs().tracer.span("outer"):
            with obs.get_obs().tracer.span("inner"):
                torch.ones(256).sum()
    finally:
        tr.stop()
    s = tr.summary()
    assert [n for n, *_ in s.program] == ["inner", "outer"]
    names = [n for n, _ in s.idle_by_span()]
    assert {"inner", "outer"} <= set(names)
    assert s.device_by_launch() == []
