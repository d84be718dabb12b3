"""Fault-injection harness for the multi-level resilience hierarchy (port
of ``repro.testing.faults``).

The kill-a-host test matrix (tests/test_torch_resilience.py) needs repeatable,
precisely-placed failures: a host dying *between* two protocol phases, a
shard file torn mid-write, a replica whose CRC lies, a writer that
stalls, a partner that dies during an L2 fetch.  This module packages
those as reusable injectors so every test states its failure scenario in
one line instead of hand-rolled monkeypatching:

- ``FaultInjector`` + the coordinator's named seams (``pack_done``,
  ``after_replicate``, ``after_land_write``, ``before_commit_barrier``,
  ``after_commit``) place a failure between any two save phases;
- ``FaultyCollective`` wraps any ``Collective`` to kill a host exactly at
  (before/after) a named barrier;
- file-level helpers (``tear_file``, ``corrupt_crc``) damage durable
  state the way real torn writes and bit rot do;
- ``stalled_writer`` / ``partner_fetch_failure`` context managers patch
  the store/replica I/O paths for slow-writer and dead-partner
  scenarios;
- ``injector_from_env`` builds an injector from ``REPRO_FAULT`` so the
  *subprocess* multi-host harness can arm faults in its children
  (``hard=True`` kills via ``os._exit`` — a real process death, not an
  exception the save path could catch).

Thread-simulated hosts die by raising ``HostKilled`` — a
``BaseException`` so no production ``except Exception`` handler can
swallow the death, mirroring how a real process loss is invisible to the
dying host's own code.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.distributed.collective import Collective

FAULT_ENV = "REPRO_FAULT"

#: the coordinator's save-path seams, in protocol order
SAVE_POINTS = ("pack_done", "after_replicate", "after_land_write",
               "before_commit_barrier", "after_commit")


class HostKilled(BaseException):
    """Simulated abrupt host death (thread-simulated harness)."""

    def __init__(self, where: str):
        self.where = where
        super().__init__(f"host killed at {where}")


def _default_kill(hard: bool, where: str) -> None:
    if hard:
        os._exit(17)            # noqa: SLF001 - simulate a real host death
    raise HostKilled(where)


class _Rule:
    def __init__(self, point: str, action: Optional[Callable] = None,
                 match: Optional[str] = None, times: int = 1,
                 hard: bool = False):
        self.point = point
        self.action = action
        self.match = match
        self.times = int(times)
        self.hard = hard

    def applies(self, point: str, ctx: Dict[str, Any]) -> bool:
        if self.times <= 0 or self.point != point:
            return False
        if self.match is not None:
            hay = str(ctx.get("name", "")) or " ".join(
                f"{k}={v}" for k, v in sorted(ctx.items()))
            if self.match not in hay:
                return False
        return True


class FaultInjector:
    """Named-seam fault registry.

    Instrumented code calls ``fire(point, **ctx)`` at its seams; each
    armed rule matching ``point`` (and, optionally, a substring of the
    context's ``name``) fires up to ``times`` times.  A rule without an
    explicit action kills the host (``HostKilled``, or ``os._exit`` when
    ``hard`` — for subprocess harnesses where a catchable exception would
    understate the failure).
    """

    def __init__(self):
        self.rules: List[_Rule] = []
        self.fired: List[str] = []

    def at(self, point: str, action: Optional[Callable] = None, *,
           match: Optional[str] = None, times: int = 1,
           hard: bool = False) -> "FaultInjector":
        self.rules.append(_Rule(point, action, match, times, hard))
        return self

    def kill_at(self, point: str, *, match: Optional[str] = None,
                hard: bool = False) -> "FaultInjector":
        return self.at(point, match=match, hard=hard)

    def fire(self, point: str, **ctx) -> None:
        for r in self.rules:
            if not r.applies(point, ctx):
                continue
            r.times -= 1
            self.fired.append(point)
            if r.action is None:
                _default_kill(r.hard, point)
            else:
                r.action(ctx)


class FaultyCollective(Collective):
    """A ``Collective`` whose host dies at a chosen barrier.

    Wraps any backend; ``kill_before(substr)`` / ``kill_after(substr)``
    arm a death at the first barrier whose name contains ``substr`` —
    before touching the rendezvous (the host never arrives: survivors
    get a ``BarrierTimeout`` naming it) or after passing it (the host
    saw the rendezvous complete, then died).
    """

    def __init__(self, inner: Collective, hard: bool = False):
        super().__init__(inner.ctx)
        self.inner = inner
        self.hard = hard
        self._before: List[List] = []   # [substr, times]
        self._after: List[List] = []
        self.barriers_seen: List[str] = []

    def kill_before(self, substr: str, times: int = 1) -> "FaultyCollective":
        self._before.append([substr, int(times)])
        return self

    def kill_after(self, substr: str, times: int = 1) -> "FaultyCollective":
        self._after.append([substr, int(times)])
        return self

    def _check(self, rules: List[List], name: str) -> None:
        for r in rules:
            if r[1] > 0 and r[0] in name:
                r[1] -= 1
                _default_kill(self.hard, f"barrier {name!r}")

    def barrier(self, name: str, timeout: Optional[float] = None,
                participants: Optional[Sequence[int]] = None,
                heartbeat: Optional[Callable] = None) -> None:
        self.barriers_seen.append(name)
        self._check(self._before, name)
        self.inner.barrier(name, timeout=timeout, participants=participants,
                           heartbeat=heartbeat)
        self._check(self._after, name)

    def cleanup(self, before_seq: int) -> None:
        self.inner.cleanup(before_seq)

    def close(self) -> None:
        self.inner.close()


# --------------------------------------------------------------------------
# Durable-state damage: torn writes and bit rot
# --------------------------------------------------------------------------

def tear_file(path: str, keep_bytes: Optional[int] = None,
              frac: float = 0.5) -> int:
    """Truncate ``path`` as a torn write would: keep ``keep_bytes`` (or
    ``frac`` of the file).  Returns the new size."""
    size = os.path.getsize(path)
    keep = int(size * frac) if keep_bytes is None else int(keep_bytes)
    keep = max(0, min(keep, size))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def corrupt_crc(path: str, offset: Optional[int] = None) -> None:
    """Flip one payload byte so every CRC covering it fails."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    off = (size // 2) if offset is None else int(offset)
    off = min(max(off, 0), size - 1)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def shard_files(step_dir: str) -> List[str]:
    """Every payload file of a (pending or committed) checkpoint dir."""
    return sorted(os.path.join(step_dir, f) for f in os.listdir(step_dir)
                  if f.endswith(".bin"))


def session_shard_files(root: str, step: int,
                        sid: Optional[str] = None) -> List[str]:
    """Shard files holding a *session snapshot*'s payload bytes.

    Session checkpoints name their leaves ``sessions/<sid>/…``; this
    resolves which committed *data* shard files carry a given session's
    segments (all sessions when ``sid`` is None) so tests can aim
    ``tear_file`` / ``corrupt_crc`` at exactly one session's durable
    bytes.  Coordinated segments name their per-host file directly;
    plain single-host layouts record a numbered shard index instead
    (``shard_<k>.bin``).  Parity files are never returned — damaging
    those would test nothing.
    """
    from repro_torch.checkpoint.coordinator import GlobalManifest
    gm = GlobalManifest.load(root, step)
    prefix = "sessions/" + (f"{sid}/" if sid else "")
    step_dir = os.path.join(root, f"step_{step}")
    files = set()
    for name, e in gm.leaves().items():
        if not name.startswith(prefix):
            continue
        for s in GlobalManifest.segments_of(e):
            if s.get("file"):
                files.add(os.path.join(step_dir, s["file"]))
            elif s.get("shard") is not None:
                files.add(os.path.join(step_dir,
                                       f"shard_{int(s['shard'])}.bin"))
    return sorted(files)


def tear_session_shard(root: str, step: int, sid: str,
                       frac: float = 0.5) -> str:
    """Tear (truncate) the first shard file carrying ``sid``'s snapshot —
    the torn-write-under-a-session fault.  Returns the damaged path."""
    files = session_shard_files(root, step, sid)
    if not files:
        raise FileNotFoundError(
            f"no shard files for session {sid!r} at step {step} in {root}")
    tear_file(files[0], frac=frac)
    return files[0]


# --------------------------------------------------------------------------
# I/O-path patches: stalled writers and dying partners
# --------------------------------------------------------------------------

@contextlib.contextmanager
def stalled_writer(delay_s: float, times: int = 1):
    """Delay the first ``times`` low-level shard writes by ``delay_s`` —
    a writer that is alive but slower than its peers expect."""
    from repro_torch.checkpoint import store
    real = store._pwrite_all
    left = [int(times)]

    def slow(fd, buf, off):
        if left[0] > 0:
            left[0] -= 1
            time.sleep(delay_s)
        return real(fd, buf, off)

    store._pwrite_all = slow
    try:
        yield
    finally:
        store._pwrite_all = real


@contextlib.contextmanager
def partner_fetch_failure(times: int = 1, delete: bool = False):
    """Fail the next ``times`` L2 replica reads — the partner died (or
    its replica vanished) *during* the fetch.  ``delete`` also removes
    the replica payload, so retries cannot quietly succeed."""
    from repro_torch.checkpoint import levels
    real = levels.PartnerStore.read_range
    left = [int(times)]

    def dying(self, step, src, entry, start, length):
        if left[0] > 0:
            left[0] -= 1
            if delete:
                d = self._src_dir(step, src)
                for n in (levels.REPLICA_PAYLOAD, levels.REPLICA_MANIFEST):
                    try:
                        os.unlink(os.path.join(d, n))
                    except OSError:
                        pass
            raise IOError(f"partner host {self.host} died during L2 fetch")
        return real(self, step, src, entry, start, length)

    levels.PartnerStore.read_range = dying
    try:
        yield
    finally:
        levels.PartnerStore.read_range = real


# --------------------------------------------------------------------------
# Env-driven arming (subprocess harnesses)
# --------------------------------------------------------------------------

def injector_from_env(env: str = FAULT_ENV) -> Optional[FaultInjector]:
    """Build an armed injector from ``$REPRO_FAULT`` or None.

    Format: ``point[@match][:hard]`` — e.g. ``after_replicate:hard``
    kills the process (``os._exit``) right after it lands its partner
    replica, ``before_commit_barrier`` raises ``HostKilled`` before the
    commit rendezvous.  Subprocess hosts arm this at manager
    construction, so the parent test chooses each child's failure by
    environment alone.
    """
    spec = os.environ.get(env, "").strip()
    if not spec:
        return None
    hard = spec.endswith(":hard")
    if hard:
        spec = spec[:-len(":hard")]
    point, _, match = spec.partition("@")
    inj = FaultInjector()
    inj.kill_at(point, match=match or None, hard=hard)
    return inj
