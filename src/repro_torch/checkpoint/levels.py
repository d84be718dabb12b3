"""Multi-level resilience hierarchy: the level stack, the ring partner
map, and the L1/L2 stores backing it (port of ``repro.checkpoint.levels``;
host-side bytes only, so the code is the reference's).

FTI/SCR-style multi-level checkpointing observes that most failures are
single-host and recoverable from a *neighbor* far faster than from shared
storage.  The coordinated save therefore lands the same scrutinized
payload at four levels of decreasing locality (and increasing failure
coverage), and restore walks them nearest-first:

::

    L1  resident    this process's packed payloads, kept in memory
                    (the delta-chain sources, formalized with a
                    retention policy) — zero I/O restore
    L2  partner     each host streams its packed shards to a
                    deterministic ring partner; a single-host loss
                    restores from the partner copy with zero
                    shared-store reads
    L3  parity      XOR parity shards inside a checkpoint directory
                    (single-process levels) — one lost/torn shard file
                    rebuilds from its partner shard + parity
    L4  store       the shared checkpoint directory tree — the only
                    level that survives whole-job loss

Which failures each level covers (the README's failure matrix mirrors
``FAILURE_MATRIX``):

========  =============================  ===========================
level     survives                       restore path
========  =============================  ===========================
L1        process restart *not* needed   slice resident payloads
L2        single-host loss               fetch partner's CRC'd copy
L3        one shard file lost/torn       XOR rebuild from parity
L4        any subset of hosts            shared-store range reads
========  =============================  ===========================

The **ring partner map** follows the same deterministic process ordering
as ``distributed.collective.process_segments``: host ``p`` pushes its
packed segments to ``(p + 1) % count`` (and keeps a node-local copy), so
every host holds replicas for exactly one neighbor and the map needs no
negotiation — any survivor can compute who holds a dead host's bytes.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import _NULL_SPAN

L1_RESIDENT = "l1_resident"
L2_PARTNER = "l2_partner"
L3_PARITY = "l3_parity"
L4_STORE = "l4_store"

#: nearest (cheapest restore) first — the order ``restore()`` walks
LEVEL_ORDER = (L1_RESIDENT, L2_PARTNER, L3_PARITY, L4_STORE)

#: level → (what it survives, how restore is served)
FAILURE_MATRIX = {
    L1_RESIDENT: ("no process loss (same process restores)",
                  "slice resident packed payloads; zero I/O"),
    L2_PARTNER: ("single-host loss (partner survives)",
                 "fetch the partner's CRC-checked replica; zero "
                 "shared-store reads"),
    L3_PARITY: ("one lost/torn shard file per checkpoint",
                "XOR rebuild from partner shard + parity shard"),
    L4_STORE: ("any subset of hosts (store survives)",
               "shared-store byte-range reads"),
}

REPLICA_MANIFEST = "replica.json"
REPLICA_PAYLOAD = "payload.bin"
L2_DIRNAME = ".l2"


def partner_of(index: int, count: int) -> int:
    """Ring partner that *holds a replica of* host ``index``'s segments."""
    if count < 1:
        raise ValueError("process count must be >= 1")
    return (index + 1) % count


def replica_src(index: int, count: int) -> int:
    """The host whose segments host ``index`` holds a replica of."""
    return (index - 1) % count


def partner_map(count: int) -> Dict[int, int]:
    """host → replica-holding partner, for the whole ring."""
    return {p: partner_of(p, count) for p in range(count)}


def default_l2_root(level_directory: str) -> str:
    """Node-local replica stores live beside (not inside) the step dirs:
    the dot-prefixed name is invisible to step/pending/tmp sweeps."""
    return os.path.join(level_directory, L2_DIRNAME)


# --------------------------------------------------------------------------
# L1: resident packed payloads with a retention policy
# --------------------------------------------------------------------------

class ResidentCache:
    """L1: this process's packed segment payloads, kept in memory.

    The delta-chain machinery already keeps the previous save's payloads
    resident; this formalizes them as a restore level: per checkpoint
    root, the last ``keep_n`` steps' ``{(name, start, stop): (meta,
    payload_u8)}`` maps.  Payloads are the same uint8 views the save
    produced — keeping ``keep_n=1`` is free.  Serving a restore range is
    a pure in-memory slice (the caller applies the same mask prefix-sum
    logic it uses for on-disk segments).
    """

    def __init__(self, keep_n: int = 1):
        self.keep_n = max(0, int(keep_n))
        # root → OrderedDict[step → {(name, lo, hi): (meta, payload_u8)}]
        self._steps: Dict[str, "OrderedDict[int, Dict]"] = {}

    def put(self, root: str, step: int,
            items: Iterable[Tuple[str, int, int, Dict[str, Any], Any]]
            ) -> None:
        if self.keep_n == 0:
            return
        entries = {}
        for name, flo, fhi, meta, payload in items:
            u8 = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
            entries[(name, int(flo), int(fhi))] = (meta, u8)
        steps = self._steps.setdefault(root, OrderedDict())
        steps.pop(int(step), None)
        steps[int(step)] = entries
        while len(steps) > self.keep_n:
            steps.popitem(last=False)

    def steps(self, root: str) -> List[int]:
        return list(self._steps.get(root, ()))

    def get(self, root: str, step: int,
            key: Tuple[str, int, int]
            ) -> Optional[Tuple[Dict[str, Any], np.ndarray]]:
        return self._steps.get(root, {}).get(int(step), {}).get(key)

    def read_range(self, root: str, step: int, key: Tuple[str, int, int],
                   start: int, length: int) -> Optional[bytes]:
        hit = self.get(root, step, key)
        if hit is None:
            return None
        _, u8 = hit
        if not 0 <= start <= start + length <= u8.nbytes:
            return None
        return u8[start:start + length].tobytes()

    def drop(self, root: str) -> None:
        self._steps.pop(root, None)


# --------------------------------------------------------------------------
# L2: node-local partner replica store
# --------------------------------------------------------------------------

class PartnerStore:
    """One host's node-local L2 replica store.

    Layout (``directory`` is that host's node-local storage; in the
    shared-filesystem simulation it is a per-host subdir of a shared
    ``.l2`` root, and a cross-host read *is* the simulated fabric fetch)::

        <directory>/step_<N>/src<p>/payload.bin    concatenated payloads
        <directory>/step_<N>/src<p>/replica.json   entries + CRCs (last,
                                                   via rename == durable)

    ``src<p>`` identifies whose segments the copy holds: a host stores
    its *own* packed segments (``src == host``, the node-local copy) plus
    its ring predecessor's (``src == replica_src(host)``, the partner
    copy).  Every entry records the segment meta (mask aux + flat range),
    byte offset/length in ``payload.bin``, and a CRC32 — a replica is
    usable only when its manifest is present and every read verifies.
    """

    def __init__(self, directory: str, host: int):
        self.directory = directory
        self.host = int(host)

    # -- paths ------------------------------------------------------------

    def _src_dir(self, step: int, src: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}",
                            f"src{int(src)}")

    # -- write ------------------------------------------------------------

    def replicate(self, step: int, src: int,
                  items: Iterable[Tuple[str, int, int, Dict[str, Any], Any]]
                  ) -> int:
        """Write one source host's packed segments for ``step``.  Returns
        bytes written.  The manifest lands last via rename, so a torn
        replicate is simply absent."""
        d = self._src_dir(step, src)
        os.makedirs(d, exist_ok=True)
        entries = []
        offset = 0
        tmp_pay = os.path.join(d, REPLICA_PAYLOAD + ".tmp")
        with open(tmp_pay, "wb") as f:
            for name, flo, fhi, meta, payload in items:
                u8 = np.ascontiguousarray(payload).view(
                    np.uint8).reshape(-1)
                raw = u8.tobytes()
                f.write(raw)
                e = dict(meta)
                e.update(name=name, start=int(flo), stop=int(fhi),
                         offset=int(offset), length=len(raw),
                         checksum=zlib.crc32(raw))
                entries.append(e)
                offset += len(raw)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp_pay, os.path.join(d, REPLICA_PAYLOAD))
        manifest = {"step": int(step), "src": int(src),
                    "holder": self.host, "payload_bytes": int(offset),
                    "leaves": entries}
        tmp = os.path.join(d, REPLICA_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(d, REPLICA_MANIFEST))
        return int(offset)

    # -- read -------------------------------------------------------------

    def manifest(self, step: int, src: int) -> Optional[Dict[str, Any]]:
        path = os.path.join(self._src_dir(step, src), REPLICA_MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def has(self, step: int, src: int) -> bool:
        return self.manifest(step, src) is not None

    def entry_for(self, step: int, src: int,
                  key: Tuple[str, int, int]) -> Optional[Dict[str, Any]]:
        m = self.manifest(step, src)
        if m is None:
            return None
        name, lo, hi = key
        for e in m["leaves"]:
            if (e["name"] == name and int(e["start"]) == lo
                    and int(e["stop"]) == hi):
                return e
        return None

    def read_range(self, step: int, src: int, entry: Dict[str, Any],
                   start: int, length: int) -> bytes:
        """Bytes ``[start, start+length)`` of one replica entry's payload;
        whole-entry reads are CRC-verified against the replica manifest."""
        total = int(entry["length"])
        if not 0 <= start <= start + length <= total:
            raise ValueError(
                f"replica range [{start}, {start + length}) outside entry "
                f"of {total} bytes for leaf {entry.get('name')}")
        path = os.path.join(self._src_dir(step, src), REPLICA_PAYLOAD)
        with open(path, "rb") as f:
            f.seek(int(entry["offset"]) + start)
            raw = f.read(length)
        if len(raw) != length:
            raise IOError(f"replica payload truncated in "
                          f"{self._src_dir(step, src)}")
        if start == 0 and length == total \
                and zlib.crc32(raw) != int(entry["checksum"]):
            raise IOError(
                f"replica checksum mismatch for leaf {entry.get('name')} "
                f"segment [{entry.get('start')}, {entry.get('stop')})")
        return raw

    def read_all(self, step: int, src: int
                 ) -> List[Tuple[Dict[str, Any], bytes]]:
        """Every entry of one replica, each CRC-verified — the degraded
        save's recovery read."""
        m = self.manifest(step, src)
        if m is None:
            raise FileNotFoundError(
                f"no replica of host {src} step {step} in {self.directory}")
        return [(e, self.read_range(step, src, e, 0, int(e["length"])))
                for e in m["leaves"]]

    # -- retention --------------------------------------------------------

    def gc(self, keep_steps: Iterable[int]) -> None:
        keep = {int(s) for s in keep_steps}
        newest = max(keep) if keep else None
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for n in names:
            if not n.startswith("step_"):
                continue
            try:
                step = int(n[len("step_"):])
            except ValueError:
                continue
            # Hosts are not synchronized between saves: a predecessor may
            # already be replicating step N+1 into this store while we gc
            # after committing step N.  Never touch steps newer than the
            # newest committed one.
            if step in keep or (newest is not None and step > newest):
                continue
            shutil.rmtree(os.path.join(self.directory, n),
                          ignore_errors=True)


class L2Stack:
    """The coordinated manager's view of the L2 ring: its own store plus
    addressed access to every peer's (the shared-filesystem simulation of
    a fabric push/fetch).

    ``replicate(step, items)`` lands this host's packed segments in two
    places: its own store (the node-local copy a restarted process reads
    without any fabric hop) and its ring partner's store (the copy that
    survives this host's death).  ``locate(step, key, owner)`` resolves a
    restore read nearest-first: own store (either src), then the owner's
    partner store — a fabric fetch, but never a shared-store read.
    """

    def __init__(self, root: str, index: int, count: int):
        self.root = root
        self.index = int(index)
        self.count = int(count)
        #: optional per-host telemetry bundle (set by the coordinator)
        self.obs: Optional[Any] = None

    def store_of(self, host: int) -> PartnerStore:
        return PartnerStore(os.path.join(self.root, f"h{int(host)}"),
                            host=int(host))

    @property
    def own(self) -> PartnerStore:
        return self.store_of(self.index)

    def _span(self, name: str, **args):
        obs = self.obs
        if obs is None:
            return _NULL_SPAN
        return obs.tracer.span(name, **args)

    def replicate(self, step: int, items: List[Tuple]) -> Dict[str, int]:
        with self._span("l2.replicate.local", step=int(step)):
            own_bytes = self.own.replicate(step, self.index, items)
        partner = partner_of(self.index, self.count)
        rep_bytes = 0
        if partner != self.index:
            with self._span("l2.replicate.partner", step=int(step),
                            partner=partner):
                rep_bytes = self.store_of(partner).replicate(
                    step, self.index, items)
        if self.obs is not None and self.obs.enabled:
            reg = self.obs.registry
            reg.counter("l2.local_bytes").inc(int(own_bytes))
            reg.counter("l2.partner_bytes").inc(int(rep_bytes))
        return {"l2_local_bytes": int(own_bytes),
                "l2_partner_bytes": int(rep_bytes),
                "l2_partner": int(partner)}

    def locate(self, step: int, key: Tuple[str, int, int], owner: int,
               ring_count: Optional[int] = None
               ) -> Optional[Tuple[PartnerStore, int, Dict[str, Any], bool]]:
        """(store, src, entry, is_fabric_fetch) for the nearest replica of
        ``key`` saved by ``owner`` at ``step``; None when no level-2 copy
        exists.  ``ring_count`` is the *saving* job's process count (the
        ring the replicas were laid out on) — an elastic restore on a
        different count still resolves the right holder.  A dead owner's
        node-local copy is deliberately never read across hosts: only the
        partner replica survives a host loss, so only it is fetched.
        """
        rc = self.count if ring_count is None else int(ring_count)
        if self.index < rc and self.index == owner:
            e = self.own.entry_for(step, owner, key)
            if e is not None:
                return self.own, owner, e, False
        holder = partner_of(owner, rc)
        st = self.store_of(holder)
        e = st.entry_for(step, owner, key)
        if e is not None:
            fetch = holder != self.index
            if fetch and self.obs is not None and self.obs.enabled:
                self.obs.registry.counter("l2.fabric_fetches").inc()
            return st, owner, e, fetch
        return None

    def gc(self, keep_steps: Iterable[int]) -> None:
        """Each host prunes only its *own* store (the only one it owns)."""
        self.own.gc(keep_steps)
