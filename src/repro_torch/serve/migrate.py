"""Session migration and degraded-mode adoption over coordinated manifests
(port of ``repro.serve.migrate``).

The migration protocol needs no side channel: a committed coordinated
manifest already *is* the session directory.  Every session leaf is named
``sessions/<sid>/<subpath>`` with its global shape and dtype recorded,
and, because session state is ``HostPinned``, every segment of a session's
leaves carries the owning host index.  So host B can enumerate host A's
sessions, build a ``state_like`` tree of their shapes (on the ``meta``
device: nothing is allocated for it), and run the coordinator's elastic
restore against it, with each byte range served from the nearest live
resilience level (L1 resident, L2 partner replica, shared store).

Three consumers:

- **same-host resume** (``SessionManager.restore``): rebuild this host's
  sessions after a restart;
- **live migration**: host A snapshots and publishes a coordinated
  manifest; host B calls ``restore_sessions`` / ``SessionManager.restore``
  and continues decoding mid-stream: greedy continuations are
  bit-identical to the uninterrupted decode because restore reconstructs
  every logit-affecting cache byte exactly (the scrutinized-away suffix is
  zero in a live cache too);
- **degraded serving** (``adopt_sessions``): a host died mid-decode; a
  survivor adopts the dead host's sessions up to its own capacity,
  shedding the overflow deterministically.  When the adopter is the dead
  host's ring partner, every byte is served from its node-local L2
  replica (``bytes_read_store == 0``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._tensors import torch_dtype
from repro_torch.checkpoint.coordinator import GlobalManifest

SESSIONS_PREFIX = "sessions/"


def manifest_sessions(gm: GlobalManifest
                      ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """``{sid: {subpath: manifest leaf entry}}`` for every session leaf."""
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for name, e in gm.leaves().items():
        if not name.startswith(SESSIONS_PREFIX):
            continue
        _, sid, sub = name.split("/", 2)
        out.setdefault(sid, {})[sub] = e
    return out


def session_owners(gm: GlobalManifest) -> Dict[str, int]:
    """``{sid: owning host}`` from the segments' recorded host indices.

    Session leaves are ``HostPinned`` at save time, so every segment of a
    session's leaves names the same owner; plain (uncoordinated) manifests
    carry no host field and map to host 0.
    """
    owners: Dict[str, int] = {}
    for sid, subs in manifest_sessions(gm).items():
        for e in subs.values():
            for s in GlobalManifest.segments_of(e):
                if "host" in s:
                    owners[sid] = int(s["host"])
                    break
            if sid in owners:
                break
        owners.setdefault(sid, 0)
    return owners


def _nested_like(entries: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """One session's nested ``{cache, pos, tokens}`` tree (the engine
    state is nested dicts, so '/'-joined manifest names rebuild its
    structure) with ``meta`` leaves of the recorded shapes and dtypes."""
    tree: Dict[str, Any] = {}
    for sub, e in entries.items():
        node = tree
        parts = sub.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.empty(tuple(e["shape"]),
                                      dtype=torch_dtype(e["dtype"]),
                                      device="meta")
    return tree


def restore_sessions(ckpt, sids: Optional[List[str]] = None,
                     ) -> Optional[Tuple[int, Dict[str, Any], List[str]]]:
    """Restore session states from the newest committed snapshot.

    ``sids=None`` restores every session the manifest has; an explicit
    list restores the intersection and reports the rest.  Returns
    ``(step, {sid: state}, missing_sids)``, or ``None`` when no committed
    checkpoint exists.  Torn or unreadable steps are skipped in favour of
    the next-newest committed one, as ``restore``'s candidate walk does.
    """
    skipped: List[Dict[str, Any]] = []
    for step, root in ckpt._candidates():
        try:
            gm = GlobalManifest.load(root, step)
            msess = manifest_sessions(gm)
            want = sorted(msess) if sids is None else [
                s for s in sids if s in msess]
            missing = [] if sids is None else [
                s for s in sids if s not in msess]
            if not want:
                return step, {}, missing
            like = {"sessions": {s: _nested_like(msess[s]) for s in want}}
            got = ckpt._restore_step(root, step, like, None, 0,
                                     ckpt.restore_mode, skipped)
        except (OSError, ValueError, KeyError) as e:
            skipped.append({"step": step, "root": root, "error": str(e)})
            continue
        _, state = got
        return step, dict(state["sessions"]), missing
    if sids is not None:
        ckpt.last_restore_stats = ckpt.obs.registry.publish(
            "restore", {"skipped": skipped, "step": None})
    return None


@dataclasses.dataclass
class AdoptionReport:
    """Outcome of a degraded-mode adoption sweep."""
    step: Optional[int]
    dead_host: int
    adopted: List[str]          # sessions now live on the adopting host
    shed: List[str]             # dropped for capacity (load shedding)
    missing: List[str]          # named but unrecoverable from the manifest
    read_stats: Optional[Dict[str, Any]] = None

    @property
    def partner_served(self) -> bool:
        """True when every restored byte came from L1/L2 (no shared-store
        reads): the ring-partner recovery guarantee."""
        return bool(self.read_stats) and \
            self.read_stats.get("bytes_read_store", 1) == 0


def adopt_sessions(manager, dead_host: int,
                   sids: Optional[List[str]] = None) -> AdoptionReport:
    """Degraded serving: adopt a dead host's sessions onto ``manager``.

    Enumerates the newest committed manifest for sessions owned by
    ``dead_host`` (skipping ones already live here), takes as many as the
    manager's ``max_sessions`` capacity allows (in sorted sid order, so
    concurrent survivors shed the same overflow) and restores them through
    the level cascade.  The adopting host keeps serving its own sessions
    throughout; restore I/O is attributed in ``read_stats`` (a partner
    adoption shows ``bytes_read_store == 0``).
    """
    ckpt = manager.ckpt
    obs = ckpt.obs
    t0 = time.perf_counter()
    latest = ckpt.latest()
    if latest is None:
        return AdoptionReport(step=None, dead_host=dead_host, adopted=[],
                              shed=[], missing=sorted(sids or []))
    step, root = latest
    with obs.tracer.span("serve.adopt", dead_host=dead_host):
        owners = session_owners(GlobalManifest.load(root, step))
        dead = sorted(s for s, h in owners.items()
                      if h == dead_host and s not in manager.sessions)
        if sids is not None:
            dead = [s for s in dead if s in sids]
        cap = (None if manager.max_sessions is None
               else max(manager.max_sessions - len(manager.sessions), 0))
        take = dead if cap is None else dead[:cap]
        shed = dead[len(take):]
        res = restore_sessions(ckpt, sids=take) if take else (step, {}, [])
        if res is None:
            return AdoptionReport(step=None, dead_host=dead_host,
                                  adopted=[], shed=shed, missing=take)
        got_step, restored, missing = res
        for sid, state in restored.items():
            manager.sessions[sid] = state
    report = AdoptionReport(step=got_step, dead_host=dead_host,
                            adopted=sorted(restored), shed=shed,
                            missing=missing,
                            read_stats=ckpt.last_restore_stats)
    if obs.enabled:
        reg = obs.registry
        # downtime proxy: manifest walk + level-cascade restore, how long
        # the adopted sessions were unservable on this host
        reg.gauge("serve.migration_downtime_s").set(
            time.perf_counter() - t0)
        reg.counter("serve.adopted").inc(len(report.adopted))
        reg.counter("serve.shed").inc(len(report.shed))
        if report.partner_served:
            reg.counter("serve.partner_served").inc()
    return report
