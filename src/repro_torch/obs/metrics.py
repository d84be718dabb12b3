"""Metrics registry: counters / gauges / histograms + frozen stat views.

Two jobs live here:

1. **Live metrics** — named counters (monotonic byte/op totals), gauges
   (last value + running max, e.g. per-host heartbeat gaps), and
   histograms (latency samples: barrier waits, sweep times).  Recording
   is a no-op while observability is disabled, so instrumented hot paths
   stay free by default; ``to_dict()`` snapshots everything for the
   per-checkpoint ``telemetry.json``.

2. **Published stat snapshots** — the managers' ``last_save_stats`` /
   ``last_restore_stats`` / ``last_scrutiny_stats`` become *immutable*
   :class:`FrozenStats` views published through
   :meth:`MetricsRegistry.publish`.  Writer threads keep mutating their
   private working dict; readers only ever see a deep-frozen snapshot
   (one at dispatch, a finalized one when the level jobs drain), which
   closes the historical publication race.  ``FrozenStats`` subclasses
   ``dict`` so ``json.dump`` and ``dict(stats)`` keep working; every
   mutating method raises ``TypeError``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from repro_torch.obs.trace import ObsState


class FrozenStats(dict):
    """A dict whose mutators raise — a published stats snapshot."""

    def _frozen(self, *a, **k):
        raise TypeError("stats snapshot is immutable — it was published by "
                        "the checkpoint manager; copy with dict(stats) to "
                        "mutate")

    __setitem__ = _frozen
    __delitem__ = _frozen
    pop = _frozen
    popitem = _frozen
    clear = _frozen
    update = _frozen
    setdefault = _frozen
    __ior__ = _frozen

    def __reduce__(self):
        return (FrozenStats, (dict(self),))


def freeze_stats(obj: Any) -> Any:
    """Deep-freeze a stats tree: dicts → FrozenStats; lists are detached
    copies (kept as lists so ``== [...]`` comparisons hold)."""
    if isinstance(obj, dict):
        return FrozenStats({k: freeze_stats(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [freeze_stats(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(freeze_stats(v) for v in obj)
    return obj


class _NullMetric:
    __slots__ = ()

    def inc(self, v: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_METRIC = _NullMetric()


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, v: float = 1) -> None:
        with self._lock:
            self.value += v

    def to_value(self):
        return self.value


class Gauge:
    """Last value + running max (the max is what barrier gaps report)."""

    __slots__ = ("value", "max", "_lock")

    def __init__(self):
        self.value = None
        self.max = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            self.max = v if self.max is None else max(self.max, v)

    def to_value(self):
        return {"value": self.value, "max": self.max}


class Histogram:
    __slots__ = ("count", "total", "min", "max", "last", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v

    def to_value(self):
        mean = self.total / self.count if self.count else None
        return {"count": self.count, "sum": self.total, "mean": mean,
                "min": self.min, "max": self.max, "last": self.last}


class MetricsRegistry:
    """Thread-safe, get-or-create registry of named metrics.

    Names are flat dotted paths (``barrier.wait_s``,
    ``drift.flip_rate.w``).  While the shared :class:`ObsState` is
    disabled every accessor returns a null metric, so recording costs one
    branch; :meth:`publish` is *never* gated — frozen stat snapshots are
    the managers' public API regardless of observability.
    """

    def __init__(self, state: Optional[ObsState] = None):
        self.state = state or ObsState(True)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.published: Dict[str, FrozenStats] = {}

    def _get(self, table: Dict[str, Any], name: str, cls):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.setdefault(name, cls())
        return m

    def counter(self, name: str):
        if not self.state.enabled:
            return _NULL_METRIC
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str):
        if not self.state.enabled:
            return _NULL_METRIC
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str):
        if not self.state.enabled:
            return _NULL_METRIC
        return self._get(self._histograms, name, Histogram)

    # -- published stat snapshots (always on) ------------------------------

    def publish(self, kind: str, stats: Dict[str, Any]) -> FrozenStats:
        """Freeze ``stats`` and record it as the latest ``kind`` snapshot.

        Returns the frozen snapshot so callers can expose it directly
        (``self.last_save_stats = registry.publish("save", stats)``).
        """
        frozen = freeze_stats(stats)
        with self._lock:
            self.published[kind] = frozen
        return frozen

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {k: v.to_value()
                             for k, v in sorted(self._counters.items())},
                "gauges": {k: v.to_value()
                           for k, v in sorted(self._gauges.items())},
                "histograms": {k: v.to_value()
                               for k, v in sorted(self._histograms.items())},
            }
