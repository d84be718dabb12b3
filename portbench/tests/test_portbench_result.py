"""The result line of every cell at a tiny size on the CPU: its keys, its
metrics by name and unit, the checks last, and a sound run correct."""

import json
import math
import os

import pytest

from portbench.tests import tiny
from portbench import bench

CELLS = [w["name"] for w in bench.load_manifest()["workloads"]]
# cells whose files stay under portbench/ (a loop, a limits file) while
# BENCHMARK.json leaves them out: their loops still run and judge
KEPT = sorted(f[:-len(".json")] for f in
              os.listdir(os.path.join(bench.HERE, "limits"))
              if f[:-len(".json")] not in CELLS)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS + KEPT)
def test_result_line(cell, traced):
    res = tiny.run(cell, traced=traced, seconds=0.3)
    json.dumps(res)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    specs = bench.metrics_of(bench.load_manifest(), cell, traced)
    units = {m["name"]: m["unit"] for m in specs}
    for name, v in res["metrics"].items():
        assert units[name] == v["unit"] and math.isfinite(v["value"])
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # the program's numbers and spans reach every reader; a kernel's
        # roofline needs the card's kernels
        assert set(res["metrics"]) == {n for n in units
                                       if not n.endswith("_roofline")}
    else:
        # every end-to-end metric of the cell is read on the CPU too
        assert set(res["metrics"]) == set(units)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_inputs():
    import torch
    from portbench import serving
    a = tiny.arguments("phi4-mini-3.8b.rescrutiny")
    w = a["workload"]
    config = dict(bench.config(w["config"]), **a["config_overrides"])
    traffic = dict(bench.traffic(w["traffic"]), **a["traffic_overrides"])
    big = 2 ** 31 + 2 ** 20 + 3
    h1, h2 = (serving.Host(config, traffic, big, torch.device("cpu"),
                           port_cfg=a["port_cfg"]) for _ in range(2))
    assert torch.equal(h1.prompts, h2.prompts)
    for n in h1.named:
        assert torch.equal(h1.named[n], h2.named[n])
    h3 = serving.Host(config, traffic, big + 1, torch.device("cpu"),
                      port_cfg=a["port_cfg"])
    assert not torch.equal(h1.prompts, h3.prompts)
