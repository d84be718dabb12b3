"""The traced run's reading of the card: ``torch.profiler`` over the measured
window, reduced to busy time, kernel time by name and idle gaps named by the
benchmark's own host spans (``decode``, ``scrutiny``, ``save``,
``rebase``, ``restore``).

Busy time is the union of the intervals in which any operation (kernel,
copy, set) ran on the card, so overlapping streams count once.  An idle gap
is a stretch of the window between two busy intervals; it is named by the
innermost host span that covers its middle, or ``other``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

import torch

SPANS = ("decode", "scrutiny", "save", "rebase", "restore")


class Summary:
    def __init__(self, device_events: List[Tuple[str, int, int]],
                 spans: List[Tuple[str, int, int]], window: Tuple[int, int]):
        self.window_ns = window
        lo, hi = window
        self.events = [(n, max(s, lo), min(e, hi)) for n, s, e in
                       device_events if e > lo and s < hi]
        self.spans = spans
        self.intervals = _union([(s, e) for _, s, e in self.events])

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals) / 1e9

    def kernel_seconds(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels called by one of ``names`` (the
        function's name, without return type, namespace, template
        arguments or parameters)."""
        names = frozenset(names)
        return sum(e - s for n, s, e in self.events
                   if kernel_name(n) in names) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for n, s, e in self.events:
            by[n] = by.get(n, 0) + e - s
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], v / 1e9] for n, v in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the window by the host span that was running
        (the spans do not nest)."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.intervals for x in iv] + [hi]
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [s for _, s, _ in spans]
        by: Dict[str, int] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = spans[i][0] if i >= 0 and spans[i][2] > mid else "other"
            by[name] = by.get(name, 0) + b - a
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in ranked]


def _annotation(ev) -> bool:
    """A ``record_function`` range mirrored on the card's timeline: no
    operation of its own."""
    name = ev.name()
    return (name == "portbench.window" or name in SPANS
            or bool(getattr(ev, "is_user_annotation", lambda: False)()))


def kernel_name(full: str) -> str:
    """``void (anonymous namespace)::scatter_kernel<unsigned short>(...)``
    -> ``scatter_kernel``."""
    full = full.replace("(anonymous namespace)", "anonymous")
    head = full.split("(", 1)[0].split("<", 1)[0].split()
    return head[-1].split("::")[-1] if head else full


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Profiles from ``start`` to ``stop``, with the port's own spans
    (``repro_torch.obs``) on; ``summary()`` afterwards."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.running = False

    def start(self) -> None:
        from repro_torch import obs
        obs.enable()
        self.prof.__enter__()
        self.running = True
        with torch.profiler.record_function("portbench.window"):
            pass

    def stop(self) -> None:
        """Idempotent; a tracer never started stops nothing."""
        if not self.running:
            return
        from repro_torch import obs
        with torch.profiler.record_function("portbench.window"):
            pass
        self.prof.__exit__(None, None, None)
        self.running = False
        obs.disable()

    def summary(self) -> Summary:
        dev, spans, marks = [], [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            s, e = ev.start_ns(), ev.end_ns()
            on_card = "CUDA" in str(ev.device_type())
            if on_card and not _annotation(ev):
                dev.append((name, s, e))
            elif on_card:
                continue
            elif name == "portbench.window":
                marks.append(s)
            elif name in SPANS:
                spans.append((name, s, e))
        if len(marks) < 2:
            raise RuntimeError("the profiler lost the window's marks")
        return Summary(dev, spans, (min(marks), max(marks)))

