"""Thread-safe span tracer exporting Chrome trace-event JSON.

Two span shapes cover every path in the checkpoint stack:

* ``Tracer.span(name)`` — a context manager emitting one ``ph: "X"``
  *complete* event on the current thread.  Use for work that starts and
  ends on the same thread (a barrier wait, a pack stage, a D2H chunk).

* ``Tracer.begin(name)`` — an explicit cross-thread ``SpanHandle``: a
  ``ph: "b"`` *async-begin* event is emitted on the calling thread (the
  dispatcher), stage sub-spans are emitted from whatever thread runs them
  via ``handle.stage(name)``, and ``handle.finish()`` emits the matching
  ``ph: "e"`` async-end — possibly on a writer/io-pool thread.  Chrome
  matches begin/end by ``(cat, id)``, so the pair may cross threads;
  stage sub-spans carry ``args.parent = <id>`` linking them back.

While tracing is on, each thread keeps a stack of its open spans: every
``X`` event carries its own ``id`` and, inside another span or stage on
the same thread, ``args.parent`` = the id of the innermost one (the span
that caused it).  A stage's ``parent`` stays its handle's id.

Every timestamp comes from :func:`clock_ns`, the host clock that
``torch.profiler`` stamps its events with (the wall clock, as
``time.time_ns``), relative to the buffer's ``epoch_ns`` on that same
clock: ``TraceBuffer.to_ns(ts)`` is a span's start in the profiler's
nanoseconds, so a traced run can lay the program's spans over the
card's timeline.

Every simulated or real host binds its own ``pid`` (one process-track per
host in Perfetto) while sharing one :class:`TraceBuffer`, so a thread-
simulated multi-host run still exports a single loadable trace file.

The disabled fast path allocates nothing: ``span()``/``begin()`` return
module-level null singletons whose methods are empty — the only cost of
leaving instrumentation in a hot loop is one attribute load and one
predictable branch.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

#: the host clock of every span: the one ``torch.profiler`` stamps its host
#: events with, and aligns the card's events to
clock_ns = time.time_ns


class ObsState:
    """The one mutable switch shared by tracer, registry and buffer."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)


class _NullSpan:
    """No-op stand-in for both ``span()`` and ``stage()`` results."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


class _NullHandle:
    __slots__ = ()

    def stage(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **args) -> None:
        pass

    def finish(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()
_NULL_HANDLE = _NullHandle()


class TraceBuffer:
    """Append-only event list shared by every tracer in the process.

    ``mark()``/``events_since(mark)`` give per-checkpoint fragments (the
    coordinator snapshots its host's spans into ``telemetry.host<p>.json``)
    without draining the buffer, so a full-run ``export()`` still holds
    everything.
    """

    def __init__(self, state: Optional[ObsState] = None):
        self.state = state or ObsState(True)
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        # process/thread-name metadata lives apart from the event stream:
        # a fragment taken after a mark still needs the names emitted
        # before it, so every readout prepends the full metadata set
        self._meta: List[Dict[str, Any]] = []
        self._meta_seen: set = set()
        self.epoch_ns = clock_ns()
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- time / ids --------------------------------------------------------

    def now_us(self) -> float:
        return (clock_ns() - self.epoch_ns) / 1e3

    def to_ns(self, ts_us: float) -> int:
        """A ``ts`` (µs from the epoch) on :func:`clock_ns`, exactly."""
        return self.epoch_ns + round(ts_us * 1e3)

    def next_id(self) -> int:
        return next(self._ids)

    def open_spans(self) -> List[int]:
        """The calling thread's stack of open span ids, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- event intake ------------------------------------------------------

    def add(self, ev: Dict[str, Any]) -> None:
        pid, tid = ev.get("pid", 0), ev.get("tid", 0)
        with self._lock:
            self._ensure_meta_locked(pid, tid)
            self._events.append(ev)

    def _ensure_meta_locked(self, pid: int, tid: int) -> None:
        if pid not in self._meta_seen:
            self._meta_seen.add(pid)
            self._meta.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"host{pid}"}})
        if (pid, tid) not in self._meta_seen:
            self._meta_seen.add((pid, tid))
            self._meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": threading.current_thread().name}})

    def set_process_name(self, pid: int, name: str) -> None:
        with self._lock:
            self._meta_seen.add(pid)
            self._meta.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name}})

    # -- readout -----------------------------------------------------------

    def mark(self) -> int:
        with self._lock:
            return len(self._events)

    def events_since(self, mark: int = 0) -> List[Dict[str, Any]]:
        """Metadata (all of it) + the events appended after ``mark``."""
        with self._lock:
            return list(self._meta) + self._events[mark:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._meta) + len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._meta.clear()
            self._meta_seen.clear()

    def to_chrome(self, events: Optional[List[Dict[str, Any]]] = None) -> Dict:
        evs = self.events_since(0) if events is None else events
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the whole buffer as Chrome trace JSON; returns #events."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


class _Span:
    """Same-thread complete event (``ph: "X"``) with its own ``id``; its
    ``args.parent`` is the enclosing span's on this thread, unless given
    (a stage's handle)."""

    __slots__ = ("_buf", "_pid", "name", "cat", "args", "id", "_t0")

    def __init__(self, buf: TraceBuffer, pid: int, name: str, cat: str,
                 args: Dict[str, Any]):
        self._buf = buf
        self._pid = pid
        self.name = name
        self.cat = cat
        self.args = args
        self.id = 0
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        stack = self._buf.open_spans()
        self.id = self._buf.next_id()
        if stack and "parent" not in self.args:
            self.args["parent"] = stack[-1]
        stack.append(self.id)
        self._t0 = self._buf.now_us()
        return self

    def set(self, **args) -> None:
        self.args.update(args)

    def __exit__(self, *exc) -> bool:
        t1 = self._buf.now_us()
        self._buf.open_spans().remove(self.id)
        self._buf.add({
            "ph": "X", "name": self.name, "cat": self.cat,
            "pid": self._pid, "tid": threading.get_ident(),
            "ts": self._t0, "dur": t1 - self._t0, "id": self.id,
            "args": self.args})
        return False


class SpanHandle:
    """Cross-thread async span: begun here, staged and finished anywhere."""

    __slots__ = ("_buf", "_pid", "name", "cat", "id")

    def __init__(self, buf: TraceBuffer, pid: int, name: str, cat: str,
                 args: Dict[str, Any]):
        self._buf = buf
        self._pid = pid
        self.name = name
        self.cat = cat
        self.id = buf.next_id()
        buf.add({
            "ph": "b", "name": name, "cat": cat, "id": self.id,
            "pid": pid, "tid": threading.get_ident(),
            "ts": buf.now_us(), "args": args})

    def stage(self, name: str, **args) -> _Span:
        """A complete event on *the calling thread*, linked via args.parent."""
        args["parent"] = self.id
        return _Span(self._buf, self._pid, name, self.cat, args)

    def event(self, name: str, **args) -> None:
        args["parent"] = self.id
        self._buf.add({
            "ph": "i", "name": name, "cat": self.cat, "s": "t",
            "pid": self._pid, "tid": threading.get_ident(),
            "ts": self._buf.now_us(), "args": args})

    def finish(self, **args) -> None:
        self._buf.add({
            "ph": "e", "name": self.name, "cat": self.cat, "id": self.id,
            "pid": self._pid, "tid": threading.get_ident(),
            "ts": self._buf.now_us(), "args": args})


class Tracer:
    """Per-host view over a shared :class:`TraceBuffer`.

    ``pid`` becomes the Chrome process id — one track per (simulated)
    host.  All tracers sharing one buffer write into one exported file.
    """

    __slots__ = ("state", "buffer", "pid")

    def __init__(self, state: ObsState, buffer: TraceBuffer, pid: int = 0,
                 process_name: Optional[str] = None):
        self.state = state
        self.buffer = buffer
        self.pid = int(pid)
        if process_name is not None:
            buffer.set_process_name(self.pid, process_name)

    @property
    def enabled(self) -> bool:
        return self.state.enabled

    def span(self, name: str, cat: str = "ckpt", **args):
        if not self.state.enabled:
            return _NULL_SPAN
        return _Span(self.buffer, self.pid, name, cat, args)

    def begin(self, name: str, cat: str = "ckpt", **args):
        if not self.state.enabled:
            return _NULL_HANDLE
        return SpanHandle(self.buffer, self.pid, name, cat, args)
