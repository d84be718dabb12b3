"""A cell's traced run with the program's own spans laid over the card's
timeline, and the program's spans without the profiler.

``repro_torch.obs`` stamps its spans on the host clock that
``torch.profiler`` stamps with (``TraceBuffer.to_ns``), so the window's
trace can say which span of the program each stretch of time fell under:

- idle seconds of the window by the innermost program span open at each
  instant of a gap; where no program span is open, by the benchmark's own
  span (``decode``, ``save``, ``restore``...), else ``other``;
- device seconds of each operation on the card by the innermost program
  span open when it was launched: the CUDA call on the host that shares
  its correlation id.  A span that only enqueues asynchronous work
  (``scrutiny.sweep``, the save's ``pack``) gets its device time this way,
  with no synchronize.

Spans nest on a thread, so the innermost open span is the one that
started last; a program span comes before any benchmark span.

    python3 portbench/spantrace.py --workload <cell> --seed <n> \
        --seconds <s> [--obs 1]

runs the cell as ``run.py --trace 1`` does, prints its result line, then
both tables, and which launches of each program span's copies and kernels
ran inside the span, on standard error.  With ``--obs 1`` it runs the cell
as ``run.py --trace 0`` does with the program's spans on and no profiler:
the cost of the program's tracing.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import devtrace  # noqa: E402

Interval = Tuple[str, int, int]


def program_spans(buffer, mark: int = 0) -> List[Interval]:
    """The ``X`` spans of a ``repro_torch.obs`` buffer since ``mark`` as
    (name, start, end) on the profiler's clock; none from a program whose
    buffer has no such clock."""
    to_ns = getattr(buffer, "to_ns", None)
    if to_ns is None:
        return []
    return [(ev["name"], to_ns(ev["ts"]), to_ns(ev["ts"] + ev["dur"]))
            for ev in buffer.events_since(mark)
            if ev.get("ph") == "X" and "dur" in ev]


def innermost(program: Sequence[Interval],
              bench: Sequence[Interval] = ()) -> List[Interval]:
    """The timeline cut at every span's start and end, each piece named by
    the innermost span open over it (the program's first, then the
    benchmark's, each the latest started); pieces under no span left out.
    Sorted and disjoint."""
    edges = []
    for rank, spans in ((1, program), (0, bench)):
        for i, (name, s, e) in enumerate(spans):
            if e > s:
                key = (rank, i)
                edges.append((s, 1, key, name))
                edges.append((e, 0, key, name))
    edges.sort(key=lambda x: (x[0], x[1]))
    open_: list = []                   # heap of (-rank, -start, key, name)
    closed = set()
    pieces: List[Interval] = []
    prev = None
    for t, starts, key, name in edges:
        while open_ and open_[0][2] in closed:
            heapq.heappop(open_)
        if open_ and prev is not None and t > prev:
            top = open_[0][3]
            if pieces and pieces[-1][0] == top and pieces[-1][2] == prev:
                pieces[-1] = (top, pieces[-1][1], t)
            else:
                pieces.append((top, prev, t))
        prev = t
        if starts:
            heapq.heappush(open_, (-key[0], -t, key, name))
        else:
            closed.add(key)
    return pieces


def _ranked(by: Dict[str, int], top: int) -> List[list]:
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, v / 1e9] for n, v in ranked]


class SpanSummary(devtrace.Summary):
    """``devtrace.Summary`` plus the program's spans on the same clock and
    each device operation's launch time.

    ``device_events``: (name, start, end, correlation id); ``launches``:
    correlation id -> the start of the host call that launched it."""

    def __init__(self, device_events: List[Tuple[str, int, int, int]],
                 spans: List[Interval], window: Tuple[int, int],
                 program: List[Interval], launches: Dict[int, int]):
        super().__init__([(n, s, e) for n, s, e, _ in device_events], spans,
                         window)
        lo, hi = window
        self.program = [sp for sp in program if sp[2] > lo and sp[1] < hi]
        self.launched = [(n, max(s, lo), min(e, hi), launches.get(c, s))
                         for n, s, e, c in device_events if e > lo and s < hi]
        self.pieces = innermost(self.program, spans)

    def idle_by_span(self, top: int = 15) -> List[list]:
        """Idle seconds of the window by the innermost span over them."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.intervals for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        by: Dict[str, int] = {}
        j = 0
        pieces = self.pieces
        for a, b in gaps:
            covered = 0
            while j < len(pieces) and pieces[j][2] <= a:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][1] < b:
                name, s, e = pieces[k]
                d = min(e, b) - max(s, a)
                if d > 0:
                    by[name] = by.get(name, 0) + d
                    covered += d
                k += 1
            if b - a > covered:
                by["other"] = by.get("other", 0) + b - a - covered
        return _ranked(by, top)

    def device_by_launch(self, top: int = 15) -> List[list]:
        """Device seconds by the innermost span open at each launch."""
        starts = [p[1] for p in self.pieces]
        by: Dict[str, int] = {}
        for _, s, e, t in self.launched:
            i = bisect.bisect_right(starts, t) - 1
            name = (self.pieces[i][0] if i >= 0 and self.pieces[i][2] > t
                    else "other")
            by[name] = by.get(name, 0) + e - s
        return _ranked(by, top)

    def inside(self, span: str, op_prefix: str) -> Dict[str, int]:
        """Of the device operations whose name starts with ``op_prefix``
        launched inside a program span ``span``: how many, how many also
        ran inside it, and the most nanoseconds one ran outside it."""
        spans = sorted((s, e) for n, s, e in self.program if n == span)
        starts = [s for s, _ in spans]
        out = {"launched": 0, "inside": 0, "outside_ns": 0}
        for n, s, e, t in self.launched:
            if not n.startswith(op_prefix):
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or spans[i][1] < t:
                continue
            lo, hi = spans[i]
            out["launched"] += 1
            out["inside"] += lo <= s and e <= hi
            out["outside_ns"] = max(out["outside_ns"], lo - s, e - hi)
        return out


class Tracer(devtrace.Tracer):
    """``devtrace.Tracer`` that also reads the program's spans of the
    window and the launches of the card's operations."""

    def start(self) -> None:
        from repro_torch import obs
        self.buffer = obs.get_obs().buffer
        self.mark = self.buffer.mark()
        super().start()

    def summary(self) -> SpanSummary:
        base = super().summary()
        dev, launches = [], {}
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if "CUDA" in str(ev.device_type()):
                if not devtrace._annotation(ev):
                    dev.append((name, ev.start_ns(), ev.end_ns(),
                                ev.correlation_id()))
            elif name.startswith("cu"):        # CUDA runtime/driver calls
                launches[ev.correlation_id()] = ev.start_ns()
        return SpanSummary(dev, base.spans, base.window_ns,
                           program_spans(self.buffer, self.mark), launches)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--obs", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from portbench import run
    args = ["--workload", a.workload, "--seed", str(a.seed), "--seconds",
            str(a.seconds)]
    if a.obs:
        run._environment()
        from repro_torch import obs
        obs.enable()
        return run.main(args + ["--trace", "0"])
    made: List[SpanSummary] = []

    class Keeping(Tracer):
        def summary(self) -> SpanSummary:
            made.append(super().summary())
            return made[-1]

    devtrace.Tracer = Keeping
    rc = run.main(args + ["--trace", "1"])
    if rc or not made:
        return rc or 1
    s = made[-1]
    for label, table in (
            ("idle seconds by innermost span", s.idle_by_span()),
            ("device seconds by launching span", s.device_by_launch()),
            ("restore.h2d copies run inside the span",
             s.inside("restore.h2d", "Memcpy HtoD")),
            ("restore.scatter launches run inside the span",
             s.inside("restore.scatter", ""))):
        print(f"portbench: {label}: {json.dumps(table)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
