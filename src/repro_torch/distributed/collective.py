"""Multi-host coordination primitives for coordinated checkpointing (port
of ``repro.distributed.collective``).

Checkpointing a job that spans processes is a *collective* operation:
every process writes only the shards it owns, then all of them must agree
the step is complete before it becomes visible
(``checkpoint/coordinator.py`` runs the two-phase commit on top of these
primitives).  This module owns what the coordinator needs from outside:

- **Process identity** (``ProcessContext``): who am I, how many of us are
  there, who is the leader.  Resolved from ``torch.distributed``'s rank
  and world size when the caller has initialized a process group, or from
  the ``REPRO_PROCESS_INDEX`` / ``REPRO_PROCESS_COUNT`` environment
  variables when multi-host is *simulated* by independent processes (the
  names are the reference's, so one launch script drives either package).

- **Barriers** (``Collective.barrier``): rendezvous points between the
  commit phases.  Two interchangeable backends:

  * ``TorchCollective`` — a ``torch.distributed`` process group (gloo:
    the card's machine has one GPU, so the group's hosts share it).  The
    rendezvous runs through the group's c10d store, with one arrival key
    per rank and barrier, so a timeout turns into ``BarrierTimeout``
    naming the ranks that never arrived, on every survivor, and a quorum
    of survivors can rendezvous without the dead.  (``monitored_barrier``
    names the missing ranks only on rank 0 and has no quorum.)
  * ``FileCollective`` — filesystem rendezvous over a shared directory:
    each participant touches ``b_<name>.p<i>`` and spins until all
    ``count`` files exist, with a timeout so the death of one host turns
    into a ``BarrierTimeout`` on the survivors instead of a hang.

Barrier names must be unique per rendezvous (the coordinator derives them
from a per-manager monotonically increasing sequence number, which stays
consistent across hosts because every host calls ``save`` in the same
order).  Stale barrier files from a crashed previous run are cleared by
the leader at construction; a live host whose file was swept by that
cleanup re-touches it from its wait loop.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

_ENV_INDEX = "REPRO_PROCESS_INDEX"
_ENV_COUNT = "REPRO_PROCESS_COUNT"
_ENV_COORD = "REPRO_COORD_DIR"

_NAME_RE = re.compile(r"[^A-Za-z0-9._-]")


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    """Identity of this process within the coordinated job."""
    index: int
    count: int

    def __post_init__(self):
        if not 0 <= self.index < self.count:
            raise ValueError(
                f"process index {self.index} outside [0, {self.count})")

    @property
    def is_leader(self) -> bool:
        return self.index == 0


def _dist_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def current_context() -> ProcessContext:
    """Resolve this process's identity.

    ``REPRO_PROCESS_INDEX``/``REPRO_PROCESS_COUNT`` (the simulated
    multi-host harness) win over ``torch.distributed``'s rank and world
    size, which count when the caller has initialized a process group;
    otherwise the job is one process."""
    if _ENV_COUNT in os.environ:
        return ProcessContext(index=int(os.environ.get(_ENV_INDEX, "0")),
                              count=int(os.environ[_ENV_COUNT]))
    if _dist_initialized():
        import torch.distributed as dist
        return ProcessContext(index=dist.get_rank(),
                              count=dist.get_world_size())
    return ProcessContext(index=0, count=1)


class BarrierTimeout(TimeoutError):
    """A barrier's deadline passed with participants still missing.

    ``missing`` carries the process indices that never arrived, so the
    coordinator can compute the surviving quorum and recover the dead
    hosts' segments from their partners' L2 copies instead of aborting the
    save.
    """

    def __init__(self, name: str, missing: Sequence[int], expected: int,
                 waited_s: float, arrivals: Optional[dict] = None):
        self.barrier_name = name
        self.missing = sorted(int(m) for m in missing)
        self.expected = int(expected)
        self.waited_s = float(waited_s)
        # per-host first-seen arrival delay (seconds after this process
        # entered the barrier); absent hosts have no entry
        self.arrivals = dict(arrivals or {})
        hosts = ", ".join(f"host {m}" for m in self.missing)
        super().__init__(
            f"barrier {name!r}: processes {self.missing} of "
            f"{self.expected} never arrived within {self.waited_s:.1f}s "
            f"({hosts} presumed dead)")


class Collective:
    """Barrier provider bound to a ``ProcessContext``.

    ``participants``: optional explicit quorum (sorted process indices):
    after a detected host death the coordinator re-runs its commit
    barriers over the surviving quorum only.
    """

    def __init__(self, ctx: ProcessContext):
        self.ctx = ctx
        # optional repro_torch.obs bundle; backends that poll record
        # barrier waits / per-host arrival gaps through it
        self.obs: Optional[Any] = None

    def barrier(self, name: str, timeout: Optional[float] = None,
                participants: Optional[Sequence[int]] = None,
                heartbeat: Optional[Any] = None) -> None:
        """Rendezvous ``name`` with the other participants.  ``heartbeat``
        (a zero-arg callable) is invoked on every poll iteration — a
        barrier running on a writer thread uses it to keep ``.alive``
        liveness tokens fresh."""
        raise NotImplementedError

    def cleanup(self, before_seq: int) -> None:
        """Drop this process's rendezvous residue for barriers whose
        sequence number is ``< before_seq``."""

    def close(self) -> None:
        pass

    def _record_barrier(self, waited_s: float, arrivals: dict,
                        timed_out: bool) -> None:
        """Feed the barrier wait + per-host arrival gaps to the attached
        telemetry registry (success *and* timeout paths)."""
        obs = self.obs
        if obs is None or not obs.enabled:
            return
        reg = obs.registry
        reg.histogram("barrier.wait_s").observe(waited_s)
        for j, gap in sorted(arrivals.items()):
            reg.gauge(f"barrier.arrival_gap_s.host{j}").set(gap)
        if timed_out:
            reg.counter("barrier.timeouts").inc()

    def _poll(self, name: str, procs: List[int], arrived, announce,
              wait_s: float, heartbeat) -> None:
        """The shared wait loop: ``arrived(j)`` tells whether participant
        ``j`` reached the barrier, ``announce()`` (re)marks this process's
        own arrival.  Exponential backoff with jitter from ``poll_s`` to
        ``max_poll_s``, reset whenever a participant arrives; raises
        ``BarrierTimeout`` naming the missing participants."""
        t0 = time.monotonic()
        deadline = t0 + wait_s
        poll = self.poll_s
        last_missing = len(procs)
        arrivals = {self.ctx.index: 0.0}    # host -> first-seen delay (s)
        while True:
            if heartbeat is not None:
                heartbeat()
            now = time.monotonic()
            missing = [j for j in procs if not arrived(j)]
            for j in procs:
                if j not in missing:
                    arrivals.setdefault(j, now - t0)
            if not missing:
                self._record_barrier(time.monotonic() - t0, arrivals,
                                     timed_out=False)
                return
            if self.ctx.index in missing:   # swept by a leader cleanup
                announce()
            if time.monotonic() > deadline:
                self._record_barrier(time.monotonic() - t0, arrivals,
                                     timed_out=True)
                raise BarrierTimeout(name, missing, len(procs), wait_s,
                                     arrivals=arrivals)
            if len(missing) < last_missing:     # progress: stay responsive
                poll = self.poll_s
            last_missing = len(missing)
            time.sleep(poll * (0.75 + 0.5 * random.random()))
            poll = min(poll * 2.0, self.max_poll_s)

    def _procs(self, participants) -> List[int]:
        return (sorted(set(int(p) for p in participants))
                if participants is not None else list(range(self.ctx.count)))


class NullCollective(Collective):
    """Single-process job: every barrier is trivially satisfied."""

    def __init__(self, ctx: Optional[ProcessContext] = None):
        super().__init__(ctx or ProcessContext(0, 1))
        if self.ctx.count != 1:
            raise ValueError("NullCollective requires process_count == 1")

    def barrier(self, name: str, timeout: Optional[float] = None,
                participants: Optional[Sequence[int]] = None,
                heartbeat: Optional[Any] = None) -> None:
        return None


class TorchCollective(Collective):
    """A ``torch.distributed`` process group: each rank sets its arrival
    key ``b/<epoch>/<name>/<rank>`` in the group's c10d store and polls for
    the other participants' keys, with the same backoff, timeout and
    ``BarrierTimeout`` as ``FileCollective`` (the store is the default
    process group's).

    Barrier names restart at ``q1.`` with every manager, and the store
    outlives a collective, so each collective takes an epoch: the count of
    collectives this rank has built in the group (``store.add`` on a
    per-rank key).  Ranks build them in the same order, so the epochs
    agree, and a later collective never meets an earlier one's keys.  A
    rank that built one more or fewer waits for keys no other rank sets
    and times out, naming them."""

    def __init__(self, ctx: Optional[ProcessContext] = None,
                 poll_s: float = 0.01, timeout_s: float = 120.0,
                 max_poll_s: float = 0.25):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d
        if not _dist_initialized():
            raise RuntimeError("TorchCollective needs an initialized "
                               "torch.distributed process group")
        super().__init__(ctx or ProcessContext(dist.get_rank(),
                                               dist.get_world_size()))
        self.store = distributed_c10d._get_default_store()
        self.epoch = int(self.store.add(f"b/epoch/{self.ctx.index}", 1))
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.max_poll_s = max(float(max_poll_s), self.poll_s)
        self._mine: List[Tuple[str, str]] = []     # (name, key) set here

    def _key(self, name: str, index: int) -> str:
        return f"b/{self.epoch}/{_NAME_RE.sub('_', name)}/{index}"

    def barrier(self, name: str, timeout: Optional[float] = None,
                participants: Optional[Sequence[int]] = None,
                heartbeat: Optional[Any] = None) -> None:
        procs = self._procs(participants)
        if self.ctx.index not in procs:
            return
        mine = self._key(name, self.ctx.index)

        def announce():
            self.store.set(mine, str(self.ctx.index))

        announce()
        self._mine.append((name, mine))
        wait_s = self.timeout_s if timeout is None else float(timeout)
        self._poll(name, procs,
                   lambda j: self.store.check([self._key(name, j)]),
                   announce, wait_s, heartbeat)

    def cleanup(self, before_seq: int) -> None:
        """Delete this rank's own keys of barriers ``q<seq>.`` with ``seq <
        before_seq`` (every participant passed them)."""
        keep = []
        for name, key in self._mine:
            seq = _seq_of(name)
            if seq is not None and seq < before_seq:
                try:
                    self.store.delete_key(key)
                except (RuntimeError, NotImplementedError):
                    pass
            else:
                keep.append((name, key))
        self._mine = keep


def _seq_of(name: str) -> Optional[int]:
    if not name.startswith("q"):
        return None
    try:
        return int(name[1:].split(".", 1)[0])
    except ValueError:
        return None


class FileCollective(Collective):
    """Filesystem rendezvous over a shared directory.

    Each participant touches ``b_<name>.p<index>`` and polls until all
    participant files for that name exist (all ``count`` processes, or the
    explicit ``participants`` quorum).  The poll loop re-touches its own
    file if it goes missing, backs off exponentially with jitter from
    ``poll_s`` up to ``max_poll_s`` (resetting whenever a participant
    arrives), and raises ``BarrierTimeout`` carrying the indices of the
    participants that never arrived.
    """

    def __init__(self, directory: str, ctx: Optional[ProcessContext] = None,
                 poll_s: float = 0.01, timeout_s: float = 120.0,
                 max_poll_s: float = 0.25):
        super().__init__(ctx or current_context())
        self.directory = directory
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.max_poll_s = max(float(max_poll_s), self.poll_s)
        os.makedirs(directory, exist_ok=True)
        # Leftovers from a crashed previous run would satisfy this run's
        # barriers instantly (sequence numbers restart every run), so the
        # leader sweeps *every* barrier file at construction.  A live host
        # whose in-flight file got swept re-touches it from its wait loop.
        # (One coordination dir therefore serves one job at a time.)
        if self.ctx.is_leader:
            for f in os.listdir(directory):
                if not f.startswith("b_"):
                    continue
                try:
                    os.unlink(os.path.join(directory, f))
                except OSError:
                    continue

    def _path(self, name: str, index: int) -> str:
        return os.path.join(self.directory,
                            f"b_{_NAME_RE.sub('_', name)}.p{index}")

    def barrier(self, name: str, timeout: Optional[float] = None,
                participants: Optional[Sequence[int]] = None,
                heartbeat: Optional[Any] = None) -> None:
        procs = self._procs(participants)
        if self.ctx.index not in procs:
            return              # not part of this quorum's rendezvous
        mine = self._path(name, self.ctx.index)

        def announce():
            with open(mine, "w") as f:
                f.write(str(self.ctx.index))

        announce()
        wait_s = self.timeout_s if timeout is None else float(timeout)
        self._poll(name, procs,
                   lambda j: os.path.exists(self._path(name, j)),
                   announce, wait_s, heartbeat)

    def cleanup(self, before_seq: int) -> None:
        """Unlink this process's *own* files for barriers tagged ``q<seq>.``
        with ``seq < before_seq``.  Safe because barriers are strictly
        ordered per process."""
        suffix = f".p{self.ctx.index}"
        for f in os.listdir(self.directory):
            if not (f.startswith("b_q") and f.endswith(suffix)):
                continue
            seq = _seq_of(f[len("b_"):])
            if seq is not None and seq < before_seq:
                try:
                    os.unlink(os.path.join(self.directory, f))
                except OSError:
                    pass


def get_collective(backend: str = "auto",
                   coord_dir: Optional[str] = None,
                   ctx: Optional[ProcessContext] = None,
                   **kwargs) -> Collective:
    """Pick the coordination backend.

    ``auto``: a simulated multi-host context (``REPRO_PROCESS_COUNT`` env)
    uses the filesystem rendezvous (``coord_dir`` or ``REPRO_COORD_DIR``
    must name the shared directory); an initialized ``torch.distributed``
    group of several ranks uses ``TorchCollective``; an explicit ``ctx``
    with ``count > 1`` and neither uses the filesystem; anything else is
    the single-process no-op.
    """
    if backend not in ("auto", "torch", "file", "null"):
        raise ValueError(f"unknown collective backend {backend!r}")
    ctx = ctx or current_context()
    coord_dir = coord_dir or os.environ.get(_ENV_COORD)
    if backend == "null" or (backend == "auto" and ctx.count == 1):
        return NullCollective(ctx if ctx.count == 1 else None)
    if backend == "torch" or (backend == "auto" and _ENV_COUNT
                              not in os.environ and _dist_initialized()):
        return TorchCollective(ctx, **kwargs)
    # The simulation env means every participant is an *independent*
    # process: without a shared rendezvous dir the commit protocol would
    # run unsynchronized, so a missing dir is a hard error.
    if coord_dir is None:
        raise ValueError("file collective needs coord_dir "
                         f"(or ${_ENV_COORD})")
    return FileCollective(coord_dir, ctx=ctx, **kwargs)


# --------------------------------------------------------------------------
# Shard ownership: which flat element ranges of a leaf this process writes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostPinned:
    """Ownership sentinel: the whole leaf lives on exactly one process.

    Serving state (a decode session's KV cache, position, token tail) is
    *host-local*; ``HostPinned(owner)`` as a leaf's sharding pins every
    byte of it to ``owner``: that process writes the whole leaf, every
    other process writes nothing.  The ``spec`` attribute makes the
    sentinel duck-type as a sharding for the tree-flattening layers, so a
    shardings tree may mix ``LeadingAxisSharding``, ``None`` and
    ``HostPinned`` per leaf.
    """
    owner: int
    spec: Any = None

    def __post_init__(self):
        if self.owner < 0:
            raise ValueError(f"HostPinned owner must be >= 0: {self.owner}")


def process_segments(shape: Tuple[int, ...], count: int,
                     sharding=None) -> List[Tuple[int, int, int]]:
    """Partition a leaf's leading axis into per-process owned segments.

    Returns ``[(row_start, row_stop, owner_process)]`` covering
    ``[0, shape[0])`` exactly, sorted.  Ownership is *deterministic* —
    every process computes the same table:

    - When ``sharding`` (a ``LeadingAxisSharding``) tiles the leading axis
      over pieces held by several processes, each piece is owned by the
      lowest process index holding a replica of it.
    - Otherwise the leading axis is split into ``count`` near-equal
      contiguous blocks.  Scalars and leaves with fewer rows than
      processes collapse to leader ownership of the whole leaf.
    """
    if count < 1:
        raise ValueError("process count must be >= 1")
    rows = int(shape[0]) if shape else 0
    if isinstance(sharding, HostPinned):
        # modulo keeps the table well-defined if the job shrank elastically
        return [(0, rows, sharding.owner % count)]
    if not shape or rows == 0:
        return [(0, rows, 0)] if shape else [(0, 0, 0)]
    seg = _device_process_segments(shape, sharding)
    if seg is not None:
        return seg
    if rows < count or count == 1:
        return [(0, rows, 0)]
    base, rem = divmod(rows, count)
    out = []
    start = 0
    for p in range(count):
        stop = start + base + (1 if p < rem else 0)
        out.append((start, stop, p))
        start = stop
    return out


def _device_process_segments(shape, sharding):
    """Leading-axis segments mapped to owning processes via the sharding's
    placement; None when the layout is unsupported or held by one process
    (the uniform split is then authoritative)."""
    if sharding is None or not hasattr(sharding, "devices_indices_map"):
        return None
    try:
        idx_map = sharding.devices_indices_map(tuple(shape))
    except (TypeError, ValueError):
        return None
    owners = {}
    stops = {}
    procs = set()
    for dev, idx in idx_map.items():
        if idx is None or len(idx) != len(shape):
            return None
        for d, sl in enumerate(idx[1:], start=1):
            if sl.step not in (None, 1) or sl.start not in (None, 0):
                return None
            if sl.stop is not None and sl.stop != shape[d]:
                return None
        sl0 = idx[0]
        if sl0.step not in (None, 1):
            return None
        s = sl0.start or 0
        e = shape[0] if sl0.stop is None else sl0.stop
        proc = getattr(dev, "process_index", 0)
        procs.add(proc)
        if s not in owners or proc < owners[s]:
            owners[s] = proc
            stops[s] = e
    if len(procs) <= 1:
        return None
    starts = sorted(owners)
    if not starts or starts[0] != 0 or stops[starts[-1]] != shape[0]:
        return None
    for a, b in zip(starts, starts[1:]):
        if stops[a] != b:
            return None
    return [(s, stops[s], owners[s]) for s in starts]


def owned_ranges(shape: Tuple[int, ...], ctx: ProcessContext,
                 sharding=None) -> List[Tuple[int, int]]:
    """Flat element ranges of a leaf this process owns: each owned
    leading-axis segment ``[lo, hi)`` spans flat ``[lo*row, hi*row)``
    where ``row`` is the product of the non-leading dims."""
    row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    n = int(np.prod(shape)) if shape else 1
    if isinstance(sharding, HostPinned):
        # before the scalar branch: a pinned scalar belongs to its owner
        return [(0, n)] if ctx.index == sharding.owner % ctx.count else []
    if not shape:
        return [(0, 1)] if ctx.index == 0 else []
    out = []
    for lo, hi, owner in process_segments(shape, ctx.count, sharding):
        if owner == ctx.index and hi > lo:
            out.append((lo * row, hi * row))
    if not out and n == 0 and ctx.index == 0:
        out.append((0, 0))
    return out
