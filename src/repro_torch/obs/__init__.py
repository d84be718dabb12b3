"""Checkpoint telemetry: spans and metrics (port of ``repro.obs``).

One :class:`Observability` bundle = a span :class:`~repro_torch.obs.trace.Tracer`
(bound to a host's Chrome-trace ``pid``) and a
:class:`~repro_torch.obs.metrics.MetricsRegistry`.  The module-level
singleton (:func:`get_obs`) serves single-process users; :func:`scoped`
gives a per-host bundle over the shared trace buffer.  The criticality
drift tracker of the reference is not part of this package yet, so a
fragment carries no ``drift`` records.

Observability is **off by default** and off-cheap: ``span()``/``begin()``
return no-op singletons and metric accessors return a null metric.  Enable
with :func:`enable`, the ``REPRO_OBS=1`` environment variable, or per-test
via ``enable()``/``disable()`` in a try/finally.

The manager's ``last_*_stats`` attributes are published *through* the
registry (:meth:`MetricsRegistry.publish`) as immutable deep-frozen
snapshots regardless of the enabled switch — freezing is correctness (a
reader must never see a dict a writer thread is still filling), not
telemetry.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs.metrics import (FrozenStats, MetricsRegistry,
                                     freeze_stats)
from repro_torch.obs.trace import ObsState, TraceBuffer, Tracer

__all__ = [
    "Observability", "get_obs", "scoped", "enable", "disable", "enabled",
    "reset", "FrozenStats", "freeze_stats", "MetricsRegistry", "Tracer",
    "TraceBuffer", "ObsState",
]


class Observability:
    """One host's telemetry bundle over the shared state + trace buffer."""

    def __init__(self, state: ObsState, buffer: TraceBuffer,
                 process: int = 0, process_name: Optional[str] = None):
        self.state = state
        self.buffer = buffer
        self.process = int(process)
        self.tracer = Tracer(state, buffer, pid=self.process,
                             process_name=process_name)
        self.registry = MetricsRegistry(state)

    @property
    def enabled(self) -> bool:
        return self.state.enabled

    def span_snapshot(self, since_mark: int = 0) -> list:
        """Own-pid events since ``since_mark`` (thread-simulated hosts share
        one buffer, and a fragment must not duplicate its peers' spans)."""
        return [ev for ev in self.buffer.events_since(since_mark)
                if ev.get("pid") == self.process]

    def telemetry_fragment(self, since_mark: int = 0,
                           events: Optional[list] = None, **extra) -> dict:
        """This host's share of a checkpoint's ``telemetry.json``.

        ``events``: a pre-captured :meth:`span_snapshot` — pass one when
        the fragment is serialized off the save path, so later saves'
        spans don't smear into this checkpoint's fragment.
        """
        frag = {
            "process": self.process,
            "metrics": self.registry.to_dict(),
            "published": {k: dict(v) for k, v
                          in list(self.registry.published.items())},
            "spans": (self.span_snapshot(since_mark) if events is None
                      else events),
        }
        frag.update(extra)
        return frag


_STATE = ObsState(os.environ.get("REPRO_OBS", "") not in ("", "0"))
_BUFFER = TraceBuffer(_STATE)
_GLOBAL = Observability(
    _STATE, _BUFFER,
    process=int(os.environ.get("REPRO_PROCESS_INDEX", "0") or 0))


def get_obs() -> Observability:
    """The process-wide default bundle (host/pid from REPRO_PROCESS_INDEX)."""
    return _GLOBAL


def scoped(process: int, process_name: Optional[str] = None) -> Observability:
    """A per-host bundle: fresh registry, shared switch and trace buffer."""
    return Observability(_STATE, _BUFFER, process=process,
                         process_name=process_name)


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Test hygiene: drop buffered spans and the global registry state."""
    global _GLOBAL
    _BUFFER.clear()
    _GLOBAL = Observability(
        _STATE, _BUFFER,
        process=int(os.environ.get("REPRO_PROCESS_INDEX", "0") or 0))
