"""``BENCHMARK.json`` and the files it names, found by name.

- a cell (``workloads``) names a configuration and a traffic mix;
- a configuration is ``portbench/configs/<name>.json``;
- a traffic mix is ``portbench/traffic/<name>.json``, whose ``loop`` names
  the loop that drives it, ``portbench/loops/<loop>.py``;
- a cell's correctness limits are ``portbench/limits/<cell>.json``;
- a metric, end-to-end or per-layer, is read by
  ``portbench/metrics/<name>.py``, whose ``read(run)`` returns a number or
  None when the run gives it nothing to read; a name with no file of its
  own is read by the file of its stem, the part before the first dot
  (``idle_frac.scrutiny`` by ``idle_frac.py``).

A cell reports every end-to-end metric whose ``workloads`` lists it, or
that has no ``workloads``; the same for per-layer metrics in a traced run.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# names of modules that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def loop(name: str):
    """The module of the loop ``name``: ``run`` and ``judge``."""
    if not name.isidentifier():
        raise KeyError(f"no loop {name!r}")
    return importlib.import_module(f"portbench.loops.{name}")


def limits(cell: str) -> Dict[str, float]:
    return _json("limits", f"{cell}.json")["limits"]


def metrics_of(manifest: dict, cell: str, traced: bool) -> List[dict]:
    key = "per_layer" if traced else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(specs: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in specs:
        v: Optional[float] = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is, whole, one of FORBIDDEN."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
