"""Render a checkpoint's telemetry: save/restore timeline + drift table
(port of ``repro.obs.report``; it reads either package's files).

Usage::

    python -m repro_torch.obs.report <ckpt_dir> [--trace-out trace.json]

``<ckpt_dir>`` may be a committed step directory (containing
``telemetry.json``), a level directory (the newest ``step_*/telemetry.json``
is used), or the telemetry file itself.  The report shows:

* the per-host save **timeline** — each pipeline stage (snapshot, pack,
  D2H, write, replicate, land barrier, commit) as a scaled bar, so the
  phase that dominates a slow save is visible at a glance;
* the **criticality-drift table** — per-leaf mask flip rate and packed-
  word churn from the most recent sweep (the paper's criticality
  visualization, extended over time);
* headline **metrics** per host (barrier waits, degraded saves,
  partner-served restores, byte counters).

``--trace-out`` merges every host's span fragment into one Chrome
trace-event JSON, loadable at https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Tuple

BAR_WIDTH = 36

# stage key → display label, in pipeline order
STAGE_ORDER = [
    ("snapshot_s", "snapshot"),
    ("scrutiny_s", "scrutiny"),
    ("pack_s", "pack"),
    ("d2h_s", "d2h"),
    ("delta_s", "delta"),
    ("write_s", "write"),
    ("replicate_s", "replicate"),
    ("land_barrier_s", "land barrier"),
    ("commit_s", "commit"),
    ("total_s", "total"),
]


def find_telemetry(path: str) -> str:
    """Resolve a telemetry.json from a step dir, level dir, or file path."""
    if os.path.isfile(path):
        return path
    direct = os.path.join(path, "telemetry.json")
    if os.path.isfile(direct):
        return direct
    candidates = sorted(
        glob.glob(os.path.join(path, "step_*", "telemetry.json")),
        key=lambda p: int(os.path.basename(os.path.dirname(p))
                          .split("_")[-1]))
    if candidates:
        return candidates[-1]
    raise FileNotFoundError(
        f"no telemetry.json under {path!r} — run with observability "
        "enabled (repro_torch.obs.enable() or REPRO_OBS=1)")


def _bar(frac: float, width: int = BAR_WIDTH) -> str:
    n = max(0, min(width, int(round(frac * width))))
    return "█" * n + "·" * (width - n)


def _stage_rows(save_stats: Dict[str, Any]) -> List[Tuple[str, str, float]]:
    """(level, stage label, seconds) rows out of one host's save stats."""
    rows: List[Tuple[str, str, float]] = []
    stages = save_stats.get("stages")
    if isinstance(stages, dict):                    # single-host manager
        for key, label in STAGE_ORDER:
            if key in stages:
                rows.append(("", label, float(stages[key])))
    for lvdir, lv in (save_stats.get("levels") or {}).items():
        if not isinstance(lv, dict):
            continue
        name = os.path.basename(str(lvdir).rstrip("/")) or str(lvdir)
        for key, label in STAGE_ORDER:
            if key in lv and isinstance(lv[key], (int, float)):
                rows.append((name, label, float(lv[key])))
    return rows


def render_timeline(doc: Dict[str, Any], out=print) -> None:
    hosts = doc.get("hosts") or {}
    out(f"== save timeline (step {doc.get('step')}, "
        f"{len(hosts)} host(s)) ==")
    all_rows = {p: _stage_rows((frag.get("published") or {}).get("save")
                               or frag.get("save_stats") or {})
                for p, frag in hosts.items()}
    scale = max((s for rows in all_rows.values() for _, _, s in rows),
                default=0.0) or 1.0
    for p in sorted(hosts, key=lambda x: int(x)):
        frag = hosts[p]
        save = (frag.get("published") or {}).get("save") \
            or frag.get("save_stats") or {}
        line = f"-- host {p}"
        extras = []
        for k in ("d2h_bytes", "host_bytes_written"):
            if isinstance(save.get(k), (int, float)):
                extras.append(f"{k}={save[k]/1e6:.2f}MB")
        if isinstance(save.get("blocked_s"), (int, float)):
            extras.append(f"blocked={save['blocked_s']*1e3:.1f}ms")
        out(line + ("  (" + ", ".join(extras) + ")" if extras else ""))
        rows = all_rows[p]
        if not rows:
            out("   (no save stats in this fragment)")
            continue
        for level, label, sec in rows:
            tag = f"{level[:14]:>14s} {label:>12s}" if level \
                else f"{'':>14s} {label:>12s}"
            out(f"  {tag} {_bar(sec / scale)} {sec*1e3:9.2f} ms")
    out("")


def render_drift(doc: Dict[str, Any], out=print) -> None:
    hosts = doc.get("hosts") or {}
    printed_header = False
    for p in sorted(hosts, key=lambda x: int(x)):
        history = hosts[p].get("drift") or []
        if not history:
            continue
        rec = history[-1]
        if not printed_header:
            out("== criticality drift (latest sweep per host) ==")
            out(f"{'host':>4} {'leaf':<28} {'elements':>10} {'crit%':>7} "
                f"{'flips':>9} {'flip%':>8} {'churn%':>7}")
            printed_header = True
        for name, e in sorted((rec.get("leaves") or {}).items()):
            crit = e.get("critical_fraction")
            out(f"{p:>4} {name[:28]:<28} {e.get('n', 0):>10} "
                f"{(f'{crit:.1%}' if crit is not None else '-'):>7} "
                f"{e.get('flips', 0):>9} "
                f"{e.get('flip_rate', 0.0):>8.2%} "
                f"{e.get('word_churn', 0.0):>7.1%}"
                + ("  (new)" if e.get("new") else ""))
        out(f"{'':>4} {'TOTAL':<28} {rec.get('total_elements', 0):>10} "
            f"{'':>7} {rec.get('total_flips', 0):>9} "
            f"{rec.get('flip_rate', 0.0):>8.2%} "
            f"(over {len(history)} sweep(s))")
    if printed_header:
        out("")


def render_metrics(doc: Dict[str, Any], out=print) -> None:
    hosts = doc.get("hosts") or {}
    out("== metrics ==")
    for p in sorted(hosts, key=lambda x: int(x)):
        m = hosts[p].get("metrics") or {}
        counters = m.get("counters") or {}
        gauges = m.get("gauges") or {}
        hists = m.get("histograms") or {}
        if not (counters or gauges or hists):
            continue
        out(f"-- host {p}")
        for k, v in counters.items():
            out(f"  counter   {k:<38} {v}")
        for k, v in gauges.items():
            if isinstance(v, dict):
                out(f"  gauge     {k:<38} {v.get('value')} "
                    f"(max {v.get('max')})")
        for k, v in hists.items():
            if isinstance(v, dict) and v.get("count"):
                out(f"  histogram {k:<38} n={v['count']} "
                    f"mean={v['mean']:.6g} max={v['max']:.6g}")
    out("")


def merge_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    seen = set()
    for p in sorted(doc.get("hosts") or {}, key=lambda x: int(x)):
        for ev in hosts_spans(doc, p):
            key = (ev.get("ph"), ev.get("pid"), ev.get("tid"),
                   ev.get("ts"), ev.get("name"), ev.get("id"))
            if ev.get("ph") == "M":
                if key in seen:
                    continue
                seen.add(key)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def hosts_spans(doc: Dict[str, Any], p: str) -> List[Dict[str, Any]]:
    return (doc.get("hosts", {}).get(p, {}) or {}).get("spans") or []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a checkpoint's telemetry.json")
    ap.add_argument("ckpt_dir", help="step dir, level dir, or telemetry.json")
    ap.add_argument("--trace-out", default=None,
                    help="write merged Chrome trace JSON here")
    args = ap.parse_args(argv)
    try:
        path = find_telemetry(args.ckpt_dir)
    except FileNotFoundError as e:
        print(e)
        return 2
    with open(path) as f:
        doc = json.load(f)
    print(f"telemetry: {path}")
    render_timeline(doc)
    render_drift(doc)
    render_metrics(doc)
    if args.trace_out:
        trace = merge_trace(doc)
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.trace_out} "
              f"({len(trace['traceEvents'])} events) — open in "
              f"https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
