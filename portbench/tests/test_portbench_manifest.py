"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import os
import re

import pytest

from portbench.tests import tiny  # noqa: F401  (puts src/ on the path)
from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def m():
    return bench.load_manifest()


def test_top_level_keys(m):
    assert set(m) == KEYS
    assert m["paths"] == ["portbench"]
    assert m["command"] == ["python3", "portbench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(bench.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_entries_have_only_their_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_and_units(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_every_named_file_is_found(m, kind):
    if kind == "configs":
        for c in m["configs"]:
            assert c["file"] == f"portbench/configs/{c['name']}.json"
            cfg = bench.config(c["name"])
            assert cfg["name"] == c["name"]
            assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    elif kind == "traffic":
        for w in m["workloads"]:
            loop = bench.loop(bench.traffic(w["traffic"])["loop"])
            assert callable(loop.run) and callable(loop.judge)
            assert w["config"] in {c["name"] for c in m["configs"]}
    elif kind == "limits":
        for w in m["workloads"]:
            assert bench.limits(w["name"])
    else:
        for x in m["end_to_end"] + m["per_layer"]:
            assert callable(bench.reader(x["name"]))


def test_every_cell_reports_enough(m):
    e2e = {x["name"] for x in m["end_to_end"]}
    for w in m["workloads"]:
        got = {x["name"] for x in bench.metrics_of(m, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        layer = bench.metrics_of(m, w["name"], True)
        assert layer
        for x in layer:
            assert x["moves"] in got and x["moves"] in e2e


def test_one_layer_name_a_layer(m):
    by = {}
    for x in m["per_layer"]:
        by.setdefault(x["layer"], set()).add(x["name"].split(".")[0])
    assert by["device"] == {"idle_frac"}


def test_unknown_workload_is_refused(m):
    with pytest.raises(KeyError):
        bench.workload(m, "no-such-cell")


def test_configs_name_no_width_in_reduced(m):
    widths = ("hidden", "intermediate", "head", "_dim", "_rank",
              "experts_per_tok", "num_experts")
    for c in m["configs"]:
        for k in c["reduced"]:
            assert not any(w in k for w in widths), k


def test_paths_hold_only_the_benchmark():
    for dirpath, _, files in os.walk(bench.HERE):
        for f in files:
            assert not f.endswith((".bin", ".pt", ".npy")), f
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        json.load(f)


@pytest.mark.parametrize("name", ["idle_frac.scrutiny", "idle_frac.restore",
                                  "idle_frac.anything_new"])
def test_a_name_without_a_file_is_read_by_its_stem(name):
    got, stem = bench.reader(name), bench.reader("idle_frac")
    assert got.__code__.co_filename == stem.__code__.co_filename


@pytest.mark.parametrize("name", ["no_such_loop", "../run", "a.b"])
def test_unknown_loop_is_refused(name):
    with pytest.raises((KeyError, ModuleNotFoundError)):
        bench.loop(name)


def test_every_number_of_the_programs_stats_is_recorded():
    from portbench import serving
    got = serving.flatten_numbers("save", {
        "blocked_s": 0.5, "stages": {"write_s": 2, "pack_s": 1.5},
        "levels": {"/x": {"kind": "delta"}}, "ok": True, "mode": "device"})
    assert got == {"save.blocked_s": 0.5, "save.stages.write_s": 2.0,
                   "save.stages.pack_s": 1.5}
