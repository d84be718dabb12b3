"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``src/repro_torch``).  Set-up makes the cell's weights and
prompts on the card from ``--seed``, builds and warms everything the loop
uses, then the window runs the traffic mix's loop for ``--seconds``.  After
the window the program's state is freed and the timed path's outputs are
judged against the plain reference.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error repeat
the checks.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profile of
the window.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell asks for, when the checkout lacks the port, or when
JAX or the JAX package was loaded.  Build caches live in ``build/`` of the
checkout; checkpoints go to a directory under ``$TMPDIR``, removed at exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """The port's caches in fixed directories of the checkout; no library
    may pull JAX in behind the port's back."""
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_COMPILE_CACHE"] = os.path.join(build, "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_OBS", None)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def _bytes_written() -> dict:
    """This process's write counters (``/proc/self/io``), where readable."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in
                    (line.split(":") for line in f if ":" in line)
                    if k in ("wchar", "write_bytes")}
    except OSError:
        return {}


def _spread(values) -> dict:
    v = sorted(values)
    return {"n": len(v), "min": v[0], "median": v[len(v) // 2],
            "max": v[-1], "in_order": list(values)}


def _outliers(host_rows) -> dict:
    """What the host did in the slowest quarter of an operation's rounds
    against the fastest quarter: the median of each counter in each."""
    rows = sorted(host_rows, key=lambda r: r["s"])
    k = max(1, len(rows) // 4)

    def med(part):
        return {c: sorted(r[c] for r in part)[len(part) // 2]
                for c in part[0]}
    return {"fastest": med(rows[:k]), "slowest": med(rows[-k:])}


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device=None, port_cfg=None, config_overrides=None,
             traffic_overrides=None, limits=None, control=False,
             workload=None) -> dict:
    """One run of ``cell`` → the result object.  ``device`` (default the
    card), ``port_cfg``, the overrides, ``limits`` (in place of the cell's)
    and ``workload`` (a cell's entry that ``BENCHMARK.json`` does not hold):
    tests only, to run the whole path at a small size on the CPU.
    ``control``: also read the control's numbers (``control.py``) into
    ``result["control"]``.  ``result["ops"]``, ``["numbers"]`` and
    ``["host"]`` are for standard error and are popped before the line is
    printed."""
    import torch

    from portbench import bench, judge, serving
    from portbench.devtrace import Tracer

    manifest = bench.load_manifest()
    w = workload or bench.workload(manifest, cell)
    config = dict(bench.config(w["config"]), **(config_overrides or {}))
    traffic = dict(bench.traffic(w["traffic"]), **(traffic_overrides or {}))
    limits = dict(bench.limits(cell) if limits is None else limits)
    loop = bench.loop(traffic["loop"])
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    workdir = tempfile.mkdtemp(prefix="portbench_")
    tracer = Tracer(dev) if traced else None
    try:
        host = serving.Host(config, traffic, seed, dev, port_cfg=port_cfg)
        window = serving.Window(float(seconds))
        if tracer is not None:
            window.on_open = tracer.start
        try:
            kept = loop.run(host, window, os.path.join(workdir, "ckpt"))
        finally:
            if tracer is not None:
                tracer.stop()
        setup_s = window.started - T_START
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        served = host.served_tokens()
        host.free_program()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        numbers, controls = loop.judge(kept, control)
        del kept
        ts = judge.gap_thresholds(limits)
        if "logit_gap" in limits or ts:
            numbers.update(judge.served_gap_numbers(
                config, host.named, host.prompts, served, thresholds=ts))
            if control:
                controls.update(judge.served_gap_numbers(
                    config, host.named, host.prompts, served, quant="fp8",
                    thresholds=ts))
        checks = judge.verdict(numbers, limits)

        summary = tracer.summary() if tracer is not None else None
        run = types.SimpleNamespace(workload=w, config=config,
                                    traffic=traffic, setup_s=setup_s,
                                    window=window, trace=summary)
        metrics = bench.read_metrics(bench.metrics_of(manifest, cell, traced),
                                     run)
        ops = sum(len(v) for v in window.ops.values())
        result = {
            "correct": judge.is_correct(checks),
            "attempted": ops,
            "failed": 0 if judge.is_correct(checks) else ops,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": int(peak)},
        }
        if summary is not None:
            result["device"].update(busy_s=summary.busy_s,
                                    window_s=summary.window_s)
            result["breakdown"] = {"device_ops": summary.device_ops(),
                                   "idle_gaps": summary.idle_gaps()}
        if control:
            result["control"] = {"program": numbers, "control": controls}
        result["ops"] = {k: _spread(v) for k, v in window.ops.items()}
        result["numbers"] = numbers
        result["host"] = {k: _outliers(v) for k, v in window.host.items()}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("portbench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch
    from portbench import bench
    chips = bench.workload(bench.load_manifest(), a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    found = bench.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"portbench: bytes written by this process: "
          f"{json.dumps(_bytes_written())}; timed operations: "
          f"{json.dumps(result.pop('ops'))}", file=sys.stderr)
    print(f"portbench: numbers judged: {json.dumps(result.pop('numbers'))};"
          f" the host in the fastest and slowest quarter of each operation: "
          f"{json.dumps(result.pop('host'))}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
