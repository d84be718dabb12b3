"""Multi-host coordinated checkpointing: collective two-phase commit over
per-host owned shards, one global manifest, and elastic resharded restore
(port of ``repro.checkpoint.coordinator``).

The single-process ``CheckpointManager`` owns a directory end to end.  A
job of several processes, each holding (or owning) a slice of the global
state, saves through the ``CoordinatedCheckpointManager`` instead:

**Ownership.**  Every leaf's flat element range is partitioned across
processes *deterministically* (``distributed.collective.process_segments``:
the leading-axis pieces of a ``LeadingAxisSharding`` held by several
processes, a near-equal contiguous split otherwise; scalar leaves belong
to the leader).  Each host packs and writes **only the bytes it owns**.

**Two-phase commit.**

::

    host 0..P-1   write shard_h<p>_<k>.bin + manifest.host<p>.json
                  into <level>/.pending_step_<N>          (phase 1)
    all           ── barrier("land") ──
    leader        fuse per-host manifests → manifest.json (global,
                  per-leaf ordered segments), validate exact coverage,
                  rename .pending_step_<N> → step_<N>,
                  write commit.json marker                (phase 2)
    all           ── barrier("commit") ──

A step is *visible* only when committed: ``latest()`` (here and in the
single-process manager) treats a coordinated ``step_<N>`` without its
``commit.json`` as partial and falls back to the newest committed step.
A host death *before* commit trips the barrier timeout on the survivors:
the save raises, the pending dir stays hidden, and the previous step
remains the latest — unless the dead host's L2 partner replica can stand
in for it (degraded commit, below).

**Stage 1 on the card.**  ``save()`` packs each host's owned segments of
every scrutinized leaf with K2 (``pack_group``, one payload per (device,
dtype) group) on the caller's current stream, from the report's resident
words cut to the segment (``mask_ops.segment_words``: a segment that does
not start on a byte gets its words shifted, never the leaf's words read
at an offset), and clones the owned segments of leaves saved whole.  The
state's leaves are mutable (the optimizer updates them in place), so all
of the snapshot is taken before ``save(block=False)`` returns; an event
recorded after it is what the writer thread's chunked D2H waits on.

**Differential chains** ride along (``Level.max_chain``): each host keeps
its previous owned-segment payloads (host bytes) and writes per-segment
byte-chunk deltas with the host encoder (``delta_encode_host``, as the
reference: K3 does not run on this path, so the bytes stay the same); the
leader validates that every host made the same base/delta decision.

**Elastic resharded restore.**  The global manifest records every leaf's
global shape, so ``restore`` on a *different* process count reads only the
byte ranges of each saved segment that intersect its targets: per-segment
masks give prefix-sum payload offsets, the level cascade fetches exactly
those bytes, and the device path expands each range with K4
(``mask_scatter``) from the range's mask words.  Plain single-process
checkpoints restore through the same range reads (one whole-leaf
segment), so every save↔restore topology pair composes, and each package
restores the other's checkpoints.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import obs as obs_mod
from repro_torch._tensors import (check_on, fill_host, from_host, host_dtype,
                                  itemsize, leaf_dtype_name, resolve_device,
                                  torch_dtype)
from repro_torch.checkpoint.levels import (L1_RESIDENT, L2_PARTNER,
                                           L3_PARITY, L4_STORE, L2Stack,
                                           LEVEL_ORDER, ResidentCache,
                                           default_l2_root, partner_map,
                                           partner_of)
from repro_torch.checkpoint.manager import (CheckpointManager, Level,
                                            _host_snapshot, update_report)
from repro_torch.checkpoint.packing import (DeltaLeaf, delta_encode_host,
                                            leaf_mask, packed_leaf_stub,
                                            unpack_leaf)
from repro_torch.checkpoint.pipeline import (BytesSource, ViewSource, as_u8,
                                             fetch_to_host)
from repro_torch.checkpoint.store import (ALIVE_FILE, ShardReader,
                                          _delta_entry, _packed_entry,
                                          chain_steps, committed_steps,
                                          fuse_global_manifest,
                                          is_step_committed,
                                          load_checkpoint_raw,
                                          pending_step_of_entry,
                                          read_manifest, segment_mask,
                                          sweep_retention, tmp_writer_alive,
                                          write_commit_marker,
                                          write_host_entries)
from repro_torch.distributed.collective import (BarrierTimeout, Collective,
                                                get_collective, owned_ranges,
                                                process_segments)
from repro_torch.distributed.sharding import (leading_axis_device_segments,
                                              scatter_sharded_payload)
from repro_torch.kernels.mask_pack import ops as mask_ops
from repro_torch.obs.trace import _NULL_HANDLE


class StateShapeError(RuntimeError):
    """The restoring state's leaf shape contradicts the checkpoint's.

    Deliberately *not* one of the skip-and-try-next-step errors: a shape
    mismatch is a configuration bug that would fail identically on every
    candidate step, and returning ``None`` (→ fresh start) from
    ``restore`` would be data loss."""


@dataclasses.dataclass
class GlobalManifest:
    """Parsed view of a checkpoint manifest with a uniform *segment*
    interface: coordinated leaves expose their per-host segments, plain
    leaves one whole-range pseudo-segment."""
    step: int
    manifest: Dict[str, Any]

    @classmethod
    def load(cls, root: str, step: int) -> "GlobalManifest":
        return cls(step=step, manifest=read_manifest(root, step))

    @property
    def coordinated(self) -> bool:
        return "coordinated" in self.manifest

    @property
    def process_count(self) -> int:
        return int(self.manifest.get("coordinated", {})
                   .get("process_count", 1))

    @property
    def chain(self) -> List[int]:
        return chain_steps(self.manifest)

    def leaves(self) -> Dict[str, Dict[str, Any]]:
        return {e["name"]: e for e in self.manifest["leaves"]}

    @staticmethod
    def segments_of(entry: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Ordered segment entries tiling the leaf's flat range."""
        if entry.get("encoding") == "segmented":
            return sorted(entry["segments"], key=lambda s: int(s["start"]))
        n = int(np.prod(entry["shape"] or [1]))
        return [dict(entry, start=0, stop=n)]


class _LevelFetcher:
    """Per-restore-step resilience cascade: serve one segment byte range
    from the nearest live level — L1 resident payload slice, L2 partner
    replica (CRC'd; any failure falls through), then the shared store
    (whose reader rebuilds torn numbered shards from parity = L3).  Every
    read is attributed in ``stats`` (``level_served`` and per-level byte
    counts; a partner restore shows ``bytes_read_store == 0``)."""

    def __init__(self, mgr, root: str, step: int, rd: ShardReader,
                 l2: Optional[L2Stack], ring_count: int,
                 stats: Dict[str, Any]):
        self.mgr = mgr
        self.root = root
        self.step = step
        self.rd = rd
        self.l2 = l2
        self.ring_count = int(ring_count)
        self.stats = stats

    def read(self, name: str, s: Dict[str, Any], start_b: int,
             nbytes: int) -> bytes:
        stats = self.stats
        key = (name, int(s["start"]), int(s["stop"]))
        length = int(s["length"])
        hit = self.mgr._l1.get(self.root, self.step, key)
        if hit is not None and hit[1].nbytes == length:
            stats["level_served"][L1_RESIDENT] += 1
            stats["bytes_l1"] += nbytes
            return hit[1][start_b:start_b + nbytes].tobytes()
        if self.l2 is not None and "host" in s:
            loc = self.l2.locate(self.step, key, int(s["host"]),
                                 ring_count=self.ring_count)
            if loc is not None:
                store, src, entry, _fabric = loc
                if int(entry["length"]) == length:
                    try:
                        raw = store.read_range(self.step, src, entry,
                                               start_b, nbytes)
                    except (OSError, ValueError):
                        stats["l2_fallbacks"] = \
                            stats.get("l2_fallbacks", 0) + 1
                    else:
                        stats["level_served"][L2_PARTNER] += 1
                        stats["bytes_read_l2"] += nbytes
                        stats["bytes_read"] += nbytes
                        return raw
        before = self.rd.stats["parity_bytes"]
        raw = self.rd.read_range(s, start_b, nbytes)
        parity = self.rd.stats["parity_bytes"] - before
        stats["level_served"][L3_PARITY if parity else L4_STORE] += 1
        stats["bytes_read_store"] += nbytes
        stats["bytes_read"] += nbytes
        return raw


@dataclasses.dataclass
class _CoordChain:
    """Per-level differential-chain bookkeeping of *this host's* owned
    segments.  ``sources`` is ``None`` while the step's write is still in
    flight on the writer thread."""
    base_step: int
    chain: List[int]
    report: Any
    layout: Tuple                       # ((name, start, stop, dtype), ...)
    sources: Optional[Dict[Tuple[str, int, int], np.ndarray]] = None


class _AliveToken:
    """Rate-limited refresher for a pending dir's shared ``.alive``
    liveness file, called from every long phase of the writer thread so a
    peer leader's ``_gc`` never sweeps an in-flight save as a carcass."""

    REFRESH_S = 2.0

    def __init__(self, pending: str):
        self.path = os.path.join(pending, ALIVE_FILE)
        with open(self.path, "w"):
            pass
        self._last = time.monotonic()

    def __call__(self) -> None:
        now = time.monotonic()
        if now - self._last < self.REFRESH_S:
            return
        self._last = now
        try:
            os.utime(self.path)
        except OSError:
            try:                        # swept under us: recreate
                with open(self.path, "w"):
                    pass
            except OSError:
                pass


class _CoordSnapshot:
    """One coordinated save's frozen view of this host's owned segments.

    Construction runs synchronously inside ``save()`` — it is *all* the
    caller blocks for: ownership/segment classification and the snapshot.
    On the device engine the masked owned segments are packed by one
    ``pack_group`` call per (device, dtype) group (K2, payload sizes from
    the report's mask), segments saved whole are cloned, and a CUDA event
    marks the end of that work on the caller's stream; on the host engine
    every owned leaf is copied to host memory.  ``materialize()`` runs on
    the writer thread: the chunked D2H of the group payloads and clones
    (waiting on the event) and the host gathers, producing the exact
    per-segment payload bytes of the reference's coordinated writer."""

    def __init__(self, mgr: "CoordinatedCheckpointManager", state, report):
        self.engine = mgr._engine
        device_pack = mgr.save_mode != "host" and report is not None
        self.segs: List[Dict[str, Any]] = []
        self._views: Dict[str, np.ndarray] = {}       # host leaf -> flat copy
        self._pinned: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self._groups: Dict[Any, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._result = None
        self.ready = None
        self.d2h_bytes = 0
        # save-stats tree + the lock every writer-thread mutation holds
        self.stats: Dict[str, Any] = {}
        self.stats_lock = threading.Lock()
        self.obs_handle: Any = _NULL_HANDLE
        self.obs_mark = 0
        self.jobs_left = 0
        self.fused_levels: List[Any] = []   # levels this host leads
        layout = []
        on_card = False
        for name, leaf, sh in mgr._flat_state(state)[0]:
            check_on(leaf, mgr.device, f"save leaf {name!r}")
            shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
            dtype = leaf_dtype_name(leaf)
            rep = report.leaves.get(name) if report is not None else None
            for flo, fhi in owned_ranges(shape, mgr.ctx, sh):
                seg_n = fhi - flo
                mask_seg = None
                total = seg_n
                regions = None
                if rep is not None and not rep.all_critical:
                    mask_seg = np.asarray(rep.mask[flo:fhi], bool)
                    regions = _segment_regions(rep.table.regions, flo, fhi)
                    total = int((regions[:, 1] - regions[:, 0]).sum())
                seg = {"name": name, "flo": int(flo), "fhi": int(fhi),
                       "shape": shape, "dtype": dtype, "mask": mask_seg,
                       "regions": regions, "nbytes": total * itemsize(dtype)}
                is_dev = (self.engine == "device"
                          and isinstance(leaf, torch.Tensor) and seg_n > 0)
                if is_dev:
                    on_card = on_card or leaf.device.type == "cuda"
                    flat = leaf.detach().reshape(-1)[flo:fhi]
                if mask_seg is not None and total == 0:
                    # no critical element: no words, no pack, no bytes
                    seg["kind"] = "empty"
                elif is_dev and device_pack and mask_seg is not None:
                    # stage 1: group member, packed below on this stream
                    key = (dtype, str(leaf.device))
                    g = self._groups.setdefault(
                        key, {"flats": [], "words": [], "totals": [],
                              "keys": []})
                    g["flats"].append(flat)
                    g["words"].append(mask_ops.segment_words(
                        rep.device_words(leaf.device), flo, fhi))
                    g["totals"].append(total)
                    g["keys"].append((name, int(flo), int(fhi)))
                    seg["kind"] = "group"
                    seg["key"] = key
                elif is_dev:
                    # saved whole (or gathered on the host): a clone, so
                    # an in-place update after save() cannot reach it
                    self._pinned[(name, int(flo), int(fhi))] = flat.clone()
                    seg["kind"] = "dev"
                else:
                    if name not in self._views and seg_n > 0:
                        self._views[name] = _host_snapshot(leaf).reshape(-1)
                    seg["kind"] = "host"
                self.segs.append(seg)
                layout.append((name, int(flo), int(fhi), dtype))
        self.layout = tuple(layout)
        for g in self._groups.values():
            payload, _counts = mask_ops.pack_group(g["flats"], g["words"],
                                                   g["totals"])
            ranges, lo = {}, 0
            for k, t in zip(g["keys"], g["totals"]):
                ranges[k] = (lo, lo + t)
                lo += t
            g["payload"], g["ranges"] = payload, ranges
            del g["flats"], g["words"]       # the payload is the snapshot
        if on_card:
            self.ready = torch.cuda.Event()
            self.ready.record()

    def materialize(self, heartbeat=None):
        """Writer-thread half: D2H the group payloads and clones (chunked,
        double-buffered, after the stage-1 event), run the host gathers.
        Memoized — every level's write job shares one materialization, and
        the device buffers are released after it.  Returns ``(items,
        sources)``: items are ``(name, flo, fhi, meta, payload_u8)`` in
        flat-state order, sources map segment keys to the same uint8
        payloads (the delta sources and the L1/L2 payloads)."""
        with self._lock:
            if self._result is not None:
                return self._result
            group_host = {
                key: fetch_to_host([g["payload"]], heartbeat=heartbeat,
                                   ready=self.ready)
                for key, g in self._groups.items()}
            self.d2h_bytes += sum(b.nbytes for b in group_host.values())
            items, sources = [], {}
            for seg in self.segs:
                name, flo, fhi = seg["name"], seg["flo"], seg["fhi"]
                isz = itemsize(seg["dtype"])
                mask_seg = seg["mask"]
                if seg["kind"] == "empty":
                    u8 = np.zeros(0, np.uint8)
                elif seg["kind"] == "group":
                    g = self._groups[seg["key"]]
                    lo, hi = g["ranges"][(name, flo, fhi)]
                    u8 = group_host[seg["key"]][lo * isz:hi * isz]
                elif seg["kind"] == "dev":
                    raw = fetch_to_host([self._pinned[(name, flo, fhi)]],
                                        heartbeat=heartbeat,
                                        ready=self.ready)
                    self.d2h_bytes += raw.nbytes
                    if mask_seg is None:
                        u8 = raw
                    else:
                        arr = raw.view(host_dtype(seg["dtype"]))
                        u8 = as_u8(np.ascontiguousarray(arr[mask_seg]))
                else:
                    flat = self._views.get(name)
                    seg_arr = (flat[flo:fhi] if flat is not None
                               else np.zeros(0, host_dtype(seg["dtype"])))
                    payload = (seg_arr[mask_seg] if mask_seg is not None
                               else np.ascontiguousarray(seg_arr))
                    u8 = as_u8(payload)
                    self.d2h_bytes += u8.nbytes
                if heartbeat is not None:
                    heartbeat()
                stub = packed_leaf_stub(name, (fhi - flo,), seg["dtype"],
                                        mask_seg, int(u8.nbytes),
                                        regions=seg["regions"])
                meta = _packed_entry(stub)
                meta.update(shape=list(seg["shape"]), start=flo, stop=fhi)
                items.append((name, flo, fhi, meta, u8))
                sources[(name, flo, fhi)] = u8
            # the host bytes are the snapshot now: free the device copies
            for g in self._groups.values():
                g["payload"] = None
            self._pinned.clear()
            self._result = (items, sources)
            return self._result


def _segment_regions(regions: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """A leaf's critical runs (``(R, 2)`` half-open, maximal) cut to the
    segment ``[lo, hi)`` and shifted to its start: ``mask_to_regions`` of
    the segment's mask, without scanning it."""
    regions = np.asarray(regions, np.int64).reshape(-1, 2)
    i = int(np.searchsorted(regions[:, 1], lo, side="right"))
    j = int(np.searchsorted(regions[:, 0], hi, side="left"))
    seg = regions[i:j].copy()
    if len(seg):
        np.clip(seg, lo, hi, out=seg)
        seg = seg[seg[:, 1] > seg[:, 0]]
    return seg - lo


def _flatten_shardings(tree) -> List[Any]:
    """Leaves of a shardings pytree in the state's leaf order: dicts
    (sorted keys), lists and tuples are containers; a layout, a
    ``HostPinned`` and ``None`` are leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_shardings(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten_shardings(v)]
    return [tree]


class CoordinatedCheckpointManager:
    """Drop-in coordinated variant of ``CheckpointManager``.

    ``collective`` supplies process identity + barriers
    (``distributed.collective.get_collective()`` default: the
    ``torch.distributed`` group's rendezvous when one is initialized,
    filesystem rendezvous under the ``REPRO_PROCESS_*`` simulation, no-op
    when single-process).  On a single-process job saves delegate to an
    inner ``CheckpointManager`` — the pipelined async save path — so wiring
    the coordinator in unconditionally costs nothing
    (``force_coordinated=True`` runs the coordinated format/protocol even
    on one process).  Restores always take the range-read path, which
    reads plain and coordinated checkpoints alike.

    ``shardings``: optional pytree of ``LeadingAxisSharding``s /
    ``HostPinned`` / ``None`` matching the state; a leaf whose layout
    spreads its leading axis over several processes is owned by piece.

    ``device``: where the state lives and the kernels run — the card
    unless ``"cpu"`` is asked for.  ``pipeline_engine``: "auto" picks
    "device" on the card (stage-1 K2 pack + chunked pinned D2H on the
    writer thread) and "host" for CPU tensors; forcing "device" on CPU
    runs the device engine's code with the kernels' plain versions.  On
    the card every "host" value of ``save_mode``, ``restore_mode`` and
    ``pipeline_engine`` raises, as in ``CheckpointManager``.

    Coordinated saves run the same three-stage async pipeline as the
    single-process manager: ``save(block=False)`` blocks the caller only
    for the snapshot (stage 1), then the D2H, L2 replication, shard
    writes, land/commit barriers and leader manifest fusion run on a
    writer thread (per level at most one save in flight; ``wait()`` /
    ``close()`` drain and surface writer errors exactly once).

    **Resilience hierarchy** (``checkpoint.levels``): every save lands at
    four levels — L1 this process's resident packed payloads
    (``l1_keep_n`` steps), L2 a CRC'd replica pushed to the ring partner
    (``partner_replication``; stores under ``l2_root``, default
    ``<level>/.l2``), L3/L4 the shared store.  ``restore`` serves each
    segment from the nearest live level.  With ``degraded_saves``, a host
    death mid-save degrades instead of aborting: the survivors recover the
    dead hosts' current-step segments from their partners' L2 replicas,
    and the checkpoint lands complete, marked ``degraded``.

    ``fault_injector``: optional ``repro_torch.testing.faults.
    FaultInjector``; the save path calls its named seams (``pack_done``,
    ``after_replicate``, ``after_land_write``, ``before_commit_barrier``,
    ``after_commit``).
    """

    def __init__(self, levels: Sequence[Level],
                 collective: Optional[Collective] = None,
                 scrutiny_fn=None,
                 rescrutinize_every: int = 0,
                 save_mode: str = "auto",
                 restore_mode: str = "auto",
                 shardings: Any = None,
                 delta_chunk_bytes: int = mask_ops.DELTA_CHUNK_BYTES,
                 barrier_timeout_s: Optional[float] = None,
                 pending_ttl_s: float = 600.0,
                 pipeline_engine: str = "auto",
                 force_coordinated: bool = False,
                 partner_replication: bool = True,
                 degraded_saves: bool = True,
                 l2_root: Optional[str] = None,
                 l1_keep_n: int = 1,
                 fault_injector: Any = None,
                 soundness_check: Any = None,
                 device=None,
                 **manager_kwargs):
        self.device = resolve_device(device)
        for opt, val in (("save_mode", save_mode),
                         ("restore_mode", restore_mode),
                         ("pipeline_engine", pipeline_engine)):
            self._check_mode(opt, val)
        self.coll = collective if collective is not None else get_collective()
        self.ctx = self.coll.ctx
        # per-host telemetry bundle: own registry + drift tracker, shared
        # enabled switch and trace buffer; the collective reports its
        # barrier waits through the same registry
        self.obs = obs_mod.scoped(process=self.ctx.index,
                                  process_name=f"host{self.ctx.index}")
        self.coll.obs = self.obs
        self.levels = list(levels)
        self.scrutiny_fn = scrutiny_fn
        self.rescrutinize_every = rescrutinize_every
        self.soundness_check = soundness_check
        self.save_mode = save_mode
        self.restore_mode = restore_mode
        self.shardings = shardings
        self.delta_chunk_bytes = int(delta_chunk_bytes)
        self.barrier_timeout_s = barrier_timeout_s
        self.pending_ttl_s = float(pending_ttl_s)
        self._inner: Optional[CheckpointManager] = None
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._io_pool: Optional[cf.ThreadPoolExecutor] = None
        if self.ctx.count == 1 and not force_coordinated:
            self._inner = CheckpointManager(
                levels, scrutiny_fn=scrutiny_fn,
                rescrutinize_every=rescrutinize_every, save_mode=save_mode,
                restore_mode=restore_mode,
                delta_chunk_bytes=delta_chunk_bytes,
                pipeline_engine=pipeline_engine,
                soundness_check=soundness_check, device=self.device,
                **manager_kwargs)
        else:
            if manager_kwargs:
                raise TypeError(
                    "CoordinatedCheckpointManager (multi-process): "
                    f"unsupported keyword(s) {sorted(manager_kwargs)} — "
                    "these tune the single-process pipelined manager only")
            for lv in self.levels:
                os.makedirs(lv.directory, exist_ok=True)
            max_shards = max((lv.shards for lv in self.levels), default=1)
            self._pool = cf.ThreadPoolExecutor(
                max_workers=max(1, len(self.levels)))
            self._io_pool = cf.ThreadPoolExecutor(
                max_workers=max(2, max_shards))
        if pipeline_engine == "auto":
            pipeline_engine = ("device" if self.device.type == "cuda"
                               else "host")
        self._engine = pipeline_engine
        self._inflight: Dict[str, cf.Future] = {}
        self._lock = threading.Lock()
        self._seq_done: Dict[str, int] = {}
        self._seq = 0
        self._saves = 0
        self._closed = False
        self._report = None
        self._chains: Dict[str, _CoordChain] = {}
        self.partner_replication = bool(partner_replication)
        self.degraded_saves = bool(degraded_saves)
        self.l2_root = l2_root
        self._l1 = ResidentCache(keep_n=l1_keep_n)
        self._l2_stacks: Dict[str, L2Stack] = {}
        self._faults = fault_injector
        self._live_save_stats: Optional[Dict[str, Any]] = None
        self.last_save_stats: Optional[Dict[str, Any]] = None
        self.last_restore_stats: Optional[Dict[str, Any]] = None
        self.last_scrutiny_stats: Optional[Dict[str, Any]] = None

    def _check_mode(self, opt: str, val: str) -> None:
        """Refuse a "host" mode on the card: it would move K2's pack or
        K4's expand to the CPU while the state is on the card."""
        if val not in ("auto", "host", "device"):
            raise ValueError(f"unknown {opt} {val!r}")
        if val == "host" and self.device.type == "cuda":
            raise ValueError(
                f'{opt}="host" would pack or expand on the CPU while the '
                f'state is on the card; keep it on the card, or pass '
                f'device="cpu" with tensors on the CPU')

    # --- lifecycle -------------------------------------------------------

    def __enter__(self) -> "CoordinatedCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain in-flight coordinated saves (surfacing writer errors
        exactly once), shut the writer pools down, close the collective.
        Idempotent."""
        if self._closed:
            return
        try:
            if self._inner is not None:
                self._inner.close()
            else:
                try:
                    self.wait()
                finally:
                    if self._pool is not None:
                        self._pool.shutdown(wait=True)
                        self._pool = None
                    if self._io_pool is not None:
                        self._io_pool.shutdown(wait=True)
                        self._io_pool = None
        finally:
            self._closed = True
            self.coll.close()

    def wait(self):
        """Block until every in-flight save has landed; raise the first
        writer error (each exactly once).  Returns the *finalized*
        ``last_save_stats`` snapshot."""
        if self._inner is not None:
            return self._inner.wait()
        futs = list(self._inflight.values())
        self._inflight.clear()
        first: Optional[BaseException] = None
        for fut in futs:
            try:
                fut.result()
            except BaseException as e:   # noqa: BLE001 - re-raised below
                if first is None:
                    first = e
        if first is not None:
            raise first
        return self.last_save_stats

    # --- scrutiny --------------------------------------------------------

    def _maybe_report(self, state):
        """Same schedule as the single-process manager (shared
        ``manager.update_report``; every host runs it locally, and
        determinism of ``scrutiny_fn`` keeps decisions aligned)."""
        with self.obs.tracer.span("scrutiny", saves=self._saves):
            new, ran = update_report(self.scrutiny_fn, self._report,
                                     self._saves, self.rescrutinize_every,
                                     state, check=self.soundness_check)
        if ran:
            self.last_scrutiny_stats = getattr(new, "stats", None)
            if new is not None and self.obs.enabled:
                with self.obs.tracer.span("scrutiny.drift"):
                    self.obs.drift.observe(new, step=self._saves)
        self._report = new
        return self._report

    # --- save ------------------------------------------------------------

    def save(self, step: int, state, block: bool = False):
        """Coordinated save, pipelined and async: the caller blocks only
        for scrutiny (when due), the snapshot and the chain plan — the
        D2H, L2 replication, shard writes and the two-phase commit run on
        a writer thread.  Per level at most one save is in flight.  Writer
        errors (a peer death's ``BarrierTimeout`` too) surface exactly
        once, from the next ``save``/``wait``/``close`` (or from this call
        with ``block=True``)."""
        if self._inner is not None:
            return self._inner.save(step, state, block=block)
        if self._closed:
            raise RuntimeError("CoordinatedCheckpointManager is closed")
        t0 = time.perf_counter()
        obs_mark = self.obs.buffer.mark()
        report = self._maybe_report(state)
        self._saves += 1
        stats = {"mode": "coordinated", "process": self.ctx.index,
                 "process_count": self.ctx.count, "levels": {},
                 "host_bytes_written": 0, "d2h_bytes": 0, "blocked_s": 0.0,
                 "engine": self._engine}
        with self.obs.tracer.span("save.snapshot", step=step):
            snap = _CoordSnapshot(self, state, report)
        snap.stats = stats
        snap.obs_mark = obs_mark
        snap.obs_handle = self.obs.tracer.begin(
            f"save/step_{step}", step=step, mode="coordinated")
        fired: List[Level] = []
        futs: List[cf.Future] = []
        due = [lv for lv in self.levels if step % lv.interval == 0]
        snap.jobs_left = len(due)
        for lv in due:
            # double buffer: drain the previous in-flight save for this
            # level on the caller thread (its error propagates here, once)
            prev = self._inflight.pop(lv.directory, None)
            if prev is not None:
                prev.result()
            self._seq += 1
            seq = self._seq
            tag = f"q{seq}.L{self.levels.index(lv)}"
            plan = self._plan_level(lv, step, report, snap)
            fut = self._pool.submit(self._run_level_job, lv, step, seq,
                                    tag, snap, plan, stats)
            self._inflight[lv.directory] = fut
            fired.append(lv)
            futs.append(fut)
        with snap.stats_lock:
            stats["blocked_s"] = time.perf_counter() - t0
        with self._lock:
            self._live_save_stats = stats
        with snap.stats_lock:
            self.last_save_stats = self.obs.registry.publish("save", stats)
        self.obs.registry.counter("save.dispatches").inc()
        if not due:
            snap.obs_handle.finish()
        if block:
            first: Optional[BaseException] = None
            for lv, fut in zip(fired, futs):
                if self._inflight.get(lv.directory) is fut:
                    del self._inflight[lv.directory]
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001 - re-raised
                    if first is None:
                        first = e
            if first is not None:
                raise first
        return futs

    @staticmethod
    def _shard_leaves(shardings, flat, what: str):
        """Flatten a shardings pytree alongside ``flat`` state leaves,
        refusing truncating mismatches (a dropped leaf would be a leaf
        missing from the checkpoint)."""
        if shardings is None:
            return [None] * len(flat)
        out = _flatten_shardings(shardings)
        if len(out) != len(flat):
            raise ValueError(
                f"{what}: shardings pytree has {len(out)} leaves but the "
                f"state has {len(flat)} — they must match one-to-one "
                f"(use None entries for unsharded leaves)")
        return out

    def _flat_state(self, state):
        named, treedef = _tree.flatten_with_names(state)
        shard_flat = self._shard_leaves(self.shardings, named, "save")
        out = []
        for (name, leaf), sh in zip(named, shard_flat):
            out.append((name, leaf, sh if hasattr(sh, "spec") else None))
        return out, treedef

    def _delta_ok(self, lv: Level, cs: Optional[_CoordChain], report,
                  layout) -> bool:
        return (cs is not None and cs.sources is not None
                and len(cs.chain) < lv.max_chain
                and report is cs.report and layout == cs.layout)

    def _plan_level(self, lv: Level, step: int, report,
                    snap: _CoordSnapshot) -> Dict[str, Any]:
        """Synchronous chain plan for one level (caller thread, after the
        previous in-flight save for this level drained, so the base/delta
        decision is identical on every host)."""
        cs = self._chains.get(lv.directory)
        if lv.max_chain > 0 and self._delta_ok(lv, cs, report, snap.layout):
            chain = [cs.base_step] + list(cs.chain) + [step]
            prev_sources = cs.sources
            cs.chain.append(step)
            cs.sources = None       # set again when this write lands
            self.obs.registry.gauge("save.delta_chain_len").set(
                len(cs.chain))
            return {"kind": "delta", "chain": chain,
                    "prev_sources": prev_sources, "cs": cs}
        target = None
        if lv.max_chain > 0:
            target = _CoordChain(base_step=step, chain=[], report=report,
                                 layout=snap.layout, sources=None)
            self._chains[lv.directory] = target
        return {"kind": "base", "chain": [], "prev_sources": None,
                "cs": target}

    def _drop_chain(self, lv: Level, cs: Optional[_CoordChain]) -> None:
        """A chained write failed: the chain must never reference a step
        that did not commit (identity-guarded)."""
        with self._lock:
            if cs is not None and self._chains.get(lv.directory) is cs:
                del self._chains[lv.directory]

    def _submit_io(self):
        return self._io_pool.submit if self._io_pool is not None else None

    # --- resilience levels ----------------------------------------------

    def _fire(self, point: str, **ctx) -> None:
        """Fault-injection seam (no-op without an injector)."""
        if self._faults is not None:
            self._faults.fire(point, **ctx)

    def _l2_stack(self, lv: Level) -> Optional[L2Stack]:
        """This level's L2 ring view; None when replication is off or the
        job is single-process (a ring of one has no partner)."""
        if not self.partner_replication or self.ctx.count < 2:
            return None
        st = self._l2_stacks.get(lv.directory)
        if st is None:
            root = (os.path.join(self.l2_root,
                                 f"L{self.levels.index(lv)}")
                    if self.l2_root else default_l2_root(lv.directory))
            st = L2Stack(root, self.ctx.index, self.ctx.count)
            st.obs = self.obs
            self._l2_stacks[lv.directory] = st
        return st

    def _l2_for_root(self, root: str) -> Optional[L2Stack]:
        for lv in self.levels:
            if lv.directory == root:
                return self._l2_stack(lv)
        return None

    def _run_level_job(self, lv: Level, step: int, seq: int, tag: str,
                       snap: _CoordSnapshot, plan: Dict[str, Any], stats):
        try:
            return self._run_level(lv, step, seq, tag, snap, plan, stats)
        finally:
            self._level_done(snap, step)

    def _level_done(self, snap: _CoordSnapshot, step: int) -> None:
        with snap.stats_lock:
            snap.jobs_left -= 1
            done = snap.jobs_left <= 0
        if not done:
            return
        if snap.obs_handle is not None:
            snap.obs_handle.finish()
        with self._lock:
            live = self._live_save_stats is snap.stats
        if live:
            with snap.stats_lock:
                self.last_save_stats = self.obs.registry.publish(
                    "save", snap.stats)
        for lv in snap.fused_levels:
            self._fuse_telemetry(lv, step, snap)

    def _run_level(self, lv: Level, step: int, seq: int, tag: str,
                   snap: _CoordSnapshot, plan: Dict[str, Any], stats):
        """One level's pipelined save, on the writer thread: stage-2
        materialization, L2 replication off the same host buffers, stage-3
        shard writes into the pending dir, then the land/commit
        protocol."""
        t0 = time.perf_counter()
        kind, chain = plan["kind"], plan["chain"]
        pending = os.path.join(lv.directory, f".pending_step_{step}")
        os.makedirs(pending, exist_ok=True)
        alive = _AliveToken(pending)
        l2 = self._l2_stack(lv)
        survivors = list(range(self.ctx.count))
        lv_stats: Dict[str, Any] = {"kind": kind}
        with snap.stats_lock:
            stats["levels"][lv.directory] = lv_stats
        h = snap.obs_handle
        try:
            tp = time.perf_counter()
            with h.stage("pack", level=lv.directory):
                items, sources = snap.materialize(heartbeat=alive)
            with snap.stats_lock:
                lv_stats["pack_s"] = time.perf_counter() - tp
                d2h_delta = snap.d2h_bytes - stats["d2h_bytes"]
                stats["d2h_bytes"] = snap.d2h_bytes
            if d2h_delta > 0:       # memoized materialization: count once
                self.obs.registry.counter("save.d2h_bytes").inc(
                    int(d2h_delta))
            self._fire("pack_done", name=tag, step=step)
            if l2 is not None:
                tr = time.perf_counter()
                with h.stage("replicate", level=lv.directory):
                    rep = l2.replicate(step, items)
                rep_bytes = rep["l2_local_bytes"] + rep["l2_partner_bytes"]
                with snap.stats_lock:
                    stats.setdefault("l2_bytes_replicated", 0)
                    stats["l2_bytes_replicated"] += rep_bytes
                rep["replicate_s"] = time.perf_counter() - tr
                self.obs.registry.counter(
                    "save.l2_bytes_replicated").inc(int(rep_bytes))
            else:
                rep = {}
            alive()
            self._fire("after_replicate", name=tag, step=step)
            if kind == "delta":
                prev_sources = plan["prev_sources"]
                entries = []
                with h.stage("delta", level=lv.directory):
                    for name, flo, fhi, meta, payload in items:
                        curr = sources[(name, flo, fhi)]
                        prev = prev_sources[(name, flo, fhi)]
                        idx, pay = delta_encode_host(curr, prev,
                                                     self.delta_chunk_bytes)
                        pay_b = pay.tobytes()
                        d = DeltaLeaf(name=name, shape=tuple(meta["shape"]),
                                      dtype=meta["dtype"],
                                      chunk_bytes=self.delta_chunk_bytes,
                                      total_bytes=int(curr.nbytes), idx=idx,
                                      payload=pay_b,
                                      checksum=zlib.crc32(pay_b))
                        dm = _delta_entry(d)
                        dm.update(shape=meta["shape"], start=meta["start"],
                                  stop=meta["stop"])
                        entries.append((dm, len(d.payload),
                                        BytesSource(bytes(d.payload))))
            else:
                # chunked streams over the packed host payloads
                entries = [(meta, int(payload.nbytes), ViewSource([payload]))
                           for _, _, _, meta, payload in items]

            extra = {"step": int(step), "process_count": self.ctx.count,
                     "kind": kind}
            if chain:
                extra["chain"] = [int(s) for s in chain[:-1]]
            tw = time.perf_counter()
            with h.stage("write", level=lv.directory):
                write_host_entries(pending, self.ctx.index, entries,
                                   shards=lv.shards, extra=extra,
                                   submit=self._submit_io())
            written = sum(int(n) for _, n, _ in entries)
            with snap.stats_lock:
                stats["host_bytes_written"] += written
                lv_stats["host_bytes_written"] = written
                lv_stats["write_s"] = time.perf_counter() - tw
                lv_stats.update(rep)
            self.obs.registry.counter("save.host_bytes_written").inc(written)
            self._fire("after_land_write", name=tag, step=step)
            # phase-1 telemetry fragment: lands with the shards so the
            # leader can fuse it post-commit
            if self.obs.enabled:
                self._write_host_telemetry(pending, snap)

            t1 = time.perf_counter()
            with h.stage("land", level=lv.directory):
                survivors, degraded, recovered = self._land(
                    tag, lv, step, pending, kind, l2, lv_stats,
                    snap.stats_lock, heartbeat=alive)
            with snap.stats_lock:
                lv_stats["land_barrier_s"] = time.perf_counter() - t1
            if degraded is not None:
                self.obs.registry.counter("save.degraded").inc()
            if self.ctx.index == survivors[0]:
                t2 = time.perf_counter()
                with h.stage("commit", level=lv.directory):
                    self._fuse_and_commit(lv, step, pending, kind, chain,
                                          host_manifests_override=recovered,
                                          degraded=degraded)
                with snap.stats_lock:
                    lv_stats["commit_s"] = time.perf_counter() - t2
            self._fire("before_commit_barrier", name=tag, step=step)
            tc = time.perf_counter()
            with h.stage("commit_barrier", level=lv.directory):
                self._commit_barrier(tag, lv, step, survivors, lv_stats,
                                     snap.stats_lock, heartbeat=alive)
            with snap.stats_lock:
                lv_stats["commit_barrier_s"] = time.perf_counter() - tc
            self._fire("after_commit", name=tag, step=step)
            if self.obs.enabled and self.ctx.index != survivors[0]:
                # non-leaders refresh their committed fragment with the
                # land/commit-barrier timings
                final = os.path.join(lv.directory, f"step_{step}")
                if os.path.isdir(final):
                    self._write_host_telemetry(final, snap)
        except BaseException:
            self._drop_chain(lv, plan["cs"])
            raise
        with self._lock:
            if plan["cs"] is not None \
                    and self._chains.get(lv.directory) is plan["cs"]:
                plan["cs"].sources = sources
        if self.obs.enabled and self.ctx.index == survivors[0]:
            with snap.stats_lock:
                snap.fused_levels.append(lv)
        self._l1.put(lv.directory, step, items)
        self._cleanup_barriers(lv, seq)
        if self.ctx.index == survivors[0]:
            self._gc(lv)
        if l2 is not None:
            # every host prunes its own replica store to the newest keep_n
            # committed steps (from the policy, so it cannot race _gc)
            steps = committed_steps(lv.directory)
            l2.gc(steps[-lv.keep_n:] if lv.keep_n else steps)
        with snap.stats_lock:
            lv_stats["total_s"] = time.perf_counter() - t0

    # --- telemetry -------------------------------------------------------

    def _write_host_telemetry(self, dirpath: str,
                              snap: _CoordSnapshot) -> None:
        """This host's telemetry fragment into ``dirpath`` (atomic: the
        leader's fusion may read it while a refresh lands)."""
        with snap.stats_lock:
            self.obs.registry.publish("save", snap.stats)
        frag = self.obs.telemetry_fragment(since_mark=snap.obs_mark)
        path = os.path.join(dirpath,
                            f"telemetry.host{self.ctx.index}.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(frag, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def _fuse_telemetry(self, lv: Level, step: int,
                        snap: _CoordSnapshot) -> None:
        """Leader, post-commit: fuse every host's fragment into the
        committed step's ``telemetry.json``."""
        final = os.path.join(lv.directory, f"step_{step}")
        if not os.path.isdir(final):
            return
        hosts: Dict[str, Any] = {}
        for p in range(self.ctx.count):
            path = os.path.join(final, f"telemetry.host{p}.json")
            try:
                with open(path) as f:
                    hosts[str(p)] = json.load(f)
            except (OSError, ValueError):
                continue
        with snap.stats_lock:
            self.obs.registry.publish("save", snap.stats)
        hosts[str(self.ctx.index)] = self.obs.telemetry_fragment(
            since_mark=snap.obs_mark)
        doc = {"step": int(step), "kind": "save", "hosts": hosts}
        try:
            with open(os.path.join(final, "telemetry.json"), "w") as f:
                json.dump(doc, f)
        except OSError:
            pass

    def _cleanup_barriers(self, lv: Level, seq: int) -> None:
        """Drop this process's rendezvous residue only below the *minimum*
        completed sequence across levels (every participant passed it)."""
        with self._lock:
            done = self._seq_done
            done[lv.directory] = max(done.get(lv.directory, 0), int(seq))
            threshold = min(done.values())
        self.coll.cleanup(threshold)

    # --- failure detection & degraded commit -----------------------------

    def _land(self, tag: str, lv: Level, step: int, pending: str,
              kind: str, l2: Optional[L2Stack], lv_stats, stats_lock,
              heartbeat: Optional[Any] = None):
        """The land barrier, with degradation: on a ``BarrierTimeout`` the
        surviving quorum recovers the dead hosts' current-step segments
        from their partners' L2 replicas and re-runs the rendezvous over
        the survivors only.  Returns ``(survivors, degraded_info,
        recovered_manifests)``."""
        name = f"{tag}.land"
        try:
            self.coll.barrier(name, timeout=self.barrier_timeout_s,
                              heartbeat=heartbeat)
            return list(range(self.ctx.count)), None, None
        except BarrierTimeout as e:
            if not (self.degraded_saves and l2 is not None and e.missing):
                raise
            missing = list(e.missing)
            survivors = [p for p in range(self.ctx.count)
                         if p not in missing]
            if not survivors or self.ctx.index not in survivors:
                raise
            deg_path = os.path.join(pending, f".degraded_{tag}.json")
            recovered = None
            if self.ctx.index == survivors[0]:
                recovered = {}
                try:
                    for d in missing:
                        holder = partner_of(d, self.ctx.count)
                        if holder not in survivors:
                            raise FileNotFoundError(
                                f"host {d}'s partner {holder} is also "
                                f"dead — no L2 replica reachable")
                        recovered[d] = self._recover_host(
                            lv, step, pending, kind, d, holder, lv_stats,
                            stats_lock)
                except (OSError, ValueError) as rec_err:
                    # recovery impossible: the save fails as it would have
                    # without degradation
                    raise e from rec_err
                degraded = {
                    "survivors": survivors, "missing": missing,
                    "recovered_from": {str(d): partner_of(d, self.ctx.count)
                                       for d in missing}}
                tmp = deg_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(degraded, f)
                os.rename(tmp, deg_path)
            else:
                degraded = self._await_degraded(deg_path, e,
                                                heartbeat=heartbeat)
                survivors = [int(p) for p in degraded["survivors"]]
                if self.ctx.index not in survivors:
                    raise
            with stats_lock:
                lv_stats["degraded"] = degraded
            self.coll.barrier(f"{name}2", timeout=self.barrier_timeout_s,
                              participants=survivors, heartbeat=heartbeat)
            return survivors, degraded, recovered

    def _await_degraded(self, deg_path: str, orig: BarrierTimeout,
                        heartbeat: Optional[Any] = None):
        """Non-leading survivors wait for the recovery leader's degraded
        plan (authoritative: per-host ``missing`` views can differ)."""
        timeout = (self.barrier_timeout_s
                   if self.barrier_timeout_s is not None
                   else getattr(self.coll, "timeout_s", 120.0))
        deadline = time.monotonic() + float(timeout)
        poll = 0.01
        while time.monotonic() <= deadline:
            if heartbeat is not None:
                heartbeat()
            try:
                with open(deg_path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass
            time.sleep(poll)
            poll = min(poll * 2, 0.25)
        raise orig

    def _recover_host(self, lv: Level, step: int, pending: str, kind: str,
                      dead: int, holder: int, lv_stats,
                      stats_lock) -> Dict[str, Any]:
        """Materialize a dead host's segments into the pending dir from its
        partner's CRC-verified L2 replica (full current-step payloads, so
        mid-chain they *replace* that host's segments at this step), under
        a distinct shard prefix."""
        pairs = self._l2_stack(lv).store_of(holder).read_all(step, dead)
        entries = []
        for e, raw in pairs:
            meta = {k: v for k, v in e.items()
                    if k not in ("offset", "length", "checksum", "file")}
            entries.append((meta, len(raw), BytesSource(raw)))
        extra = {"step": int(step), "process_count": self.ctx.count,
                 "kind": kind, "recovered_from": int(holder)}
        write_host_entries(pending, dead, entries, shards=lv.shards,
                           extra=extra, prefix=f"l2r_h{dead}_")
        with stats_lock:
            lv_stats.setdefault("l2_recovered_bytes", 0)
            lv_stats["l2_recovered_bytes"] += sum(len(r) for _, r in pairs)
        with open(os.path.join(pending,
                               f"manifest.host{dead}.json")) as f:
            return json.load(f)

    def _commit_barrier(self, tag: str, lv: Level, step: int,
                        survivors: List[int], lv_stats, stats_lock,
                        heartbeat: Optional[Any] = None) -> None:
        """Tolerates members dying *after* the commit marker landed: the
        step is durably visible, so survivors report the missing hosts
        instead of failing a complete checkpoint."""
        participants = (survivors if len(survivors) < self.ctx.count
                        else None)
        try:
            self.coll.barrier(f"{tag}.commit",
                              timeout=self.barrier_timeout_s,
                              participants=participants,
                              heartbeat=heartbeat)
        except BarrierTimeout as e:
            if not is_step_committed(lv.directory, step):
                raise
            with stats_lock:
                lv_stats["commit_barrier_missing"] = list(e.missing)

    def _fuse_and_commit(self, lv: Level, step: int, pending: str,
                         kind: str, chain: List[int],
                         host_manifests_override=None,
                         degraded=None) -> None:
        """Phase 2 (leader): validate host agreement, fuse, rename,
        commit-mark."""
        override = host_manifests_override or {}
        host_manifests = {}
        for p in range(self.ctx.count):
            if p in override:
                host_manifests[p] = override[p]
                continue
            path = os.path.join(pending, f"manifest.host{p}.json")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"coordinated step {step}: host {p} manifest missing")
            with open(path) as f:
                hm = json.load(f)
            if hm.get("kind", "base") != kind:
                raise ValueError(
                    f"coordinated step {step}: host {p} wrote a "
                    f"{hm.get('kind')!r} save but the leader planned "
                    f"{kind!r} — chains diverged")
            host_manifests[p] = hm
        extra = {"resilience": {
            "levels": list(LEVEL_ORDER),
            "l2_partner_map": ({str(p): q for p, q
                                in partner_map(self.ctx.count).items()}
                               if self._l2_stack(lv) is not None else None)}}
        if degraded is not None:
            extra["degraded"] = degraded
        if kind == "delta":
            extra["chain"] = {"base_step": int(chain[0]),
                              "delta_chain": [int(s) for s in chain[:-1]]}
        manifest = fuse_global_manifest(pending, step, self.ctx.count,
                                        manifest_extra=extra,
                                        host_manifests=host_manifests)
        # only files the fused manifest references may be committed (a
        # crashed prior attempt may have left foreign host files)
        referenced = {"manifest.json"}
        referenced.update(f"manifest.host{p}.json"
                          for p in range(self.ctx.count))
        referenced.add("telemetry.json")
        referenced.update(f"telemetry.host{p}.json"
                          for p in range(self.ctx.count))
        for leaf in manifest["leaves"]:
            referenced.update(s["file"] for s in leaf["segments"])
        for f in os.listdir(pending):
            if f not in referenced:
                path = os.path.join(pending, f)
                (shutil.rmtree if os.path.isdir(path)
                 else os.unlink)(path)
        final = os.path.join(lv.directory, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(pending, final)
        info = {"step": int(step), "process_count": self.ctx.count,
                "kind": kind}
        if degraded is not None:
            info["degraded"] = degraded
        write_commit_marker(final, info)

    # --- retention (leader only) ----------------------------------------

    def _gc(self, lv: Level) -> None:
        try:
            entries = os.listdir(lv.directory)
        except FileNotFoundError:
            return
        for e in entries:
            if pending_step_of_entry(e) is not None:
                if not tmp_writer_alive(lv.directory, e,
                                        self.pending_ttl_s):
                    shutil.rmtree(os.path.join(lv.directory, e),
                                  ignore_errors=True)
        sweep_retention(lv.directory, lv.keep_n)

    # --- restore ---------------------------------------------------------

    def latest(self) -> Optional[Tuple[int, str]]:
        if self._inner is not None:
            return self._inner.latest()
        best = None
        for lv in self.levels:
            for s in committed_steps(lv.directory):
                if best is None or s > best[0]:
                    best = (s, lv.directory)
        return best

    def _candidates(self) -> List[Tuple[int, str]]:
        if self._inner is not None:
            return self._inner._candidates()
        out = [(s, lv.directory) for lv in self.levels
               for s in committed_steps(lv.directory)]
        return sorted(out, key=lambda x: -x[0])

    def restore(self, state_like, shardings=None, fill=0,
                mode: Optional[str] = None, local_only: bool = False):
        """Elastic resharded restore: newest committed step → (step,
        state) with tensors on the manager's device (or each target
        piece's).

        Reads only the byte ranges of each saved segment intersecting this
        host's targets: the addressable pieces of ``shardings``
        (``LeadingAxisSharding``s) when given; with ``local_only=True``
        this process's ownership split of the restoring job (positions
        outside the owned ranges hold ``fill``); otherwise every leaf
        whole.  Leaves absent from the checkpoint keep their
        ``state_like`` value.  Delta-chain steps reconstruct segment
        payloads first (chain walk), then slice each masked leaf's payload
        at the target ranges' prefix counts (a device restore expands it
        with K4 as it does a range read's).

        Each range is served from the nearest live level (L1, L2, then
        the store with L3 parity rebuild); ``last_restore_stats`` records
        ``bytes_read`` (L2 + store), ``bytes_read_l2`` /
        ``bytes_read_store`` / ``bytes_l1``, ``level_served`` and
        ``h2d_bytes``."""
        mode = self.restore_mode if mode is None else mode
        self._check_mode("restore mode", mode)
        skipped: List[Dict[str, Any]] = []
        for step, root in self._candidates():
            try:
                return self._restore_step(root, step, state_like, shardings,
                                          fill, mode, skipped, local_only)
            except (OSError, ValueError, KeyError) as e:
                skipped.append({"step": step, "root": root, "error": str(e)})
                continue
        self.last_restore_stats = self.obs.registry.publish(
            "restore", {"skipped": skipped, "step": None})
        return None

    def _restore_step(self, root, step, state_like, shardings, fill, mode,
                      skipped, local_only=False):
        gm = GlobalManifest.load(root, step)
        stats = {"step": step, "mode": mode, "bytes_read": 0,
                 "bytes_read_l2": 0, "bytes_read_store": 0, "bytes_l1": 0,
                 "level_served": {lvl: 0 for lvl in LEVEL_ORDER},
                 "h2d_bytes": 0, "missing_leaves": [], "skipped": skipped,
                 "chain": bool(gm.chain)}
        # Delta chains (and precision-tiered leaves, whose payloads are
        # variable-width) cannot be range-addressed: reconstruct the full
        # payloads once, then slice locally.
        tiered = any(s.get("region_tiers")
                     for e in gm.manifest["leaves"]
                     for s in GlobalManifest.segments_of(e))
        chain_packed = None
        if gm.chain or tiered:
            io: Dict[str, int] = {}
            _, chain_packed, _ = load_checkpoint_raw(root, step,
                                                     io_stats=io)
            read = int(io.get("bytes_read", 0)) or int(
                gm.manifest.get("payload_bytes", 0))
            parity = int(io.get("parity_bytes", 0))
            stats["bytes_read"] = read
            stats["bytes_read_store"] = read
            stats["level_served"][L3_PARITY if parity else L4_STORE] += 1

        named, treedef = _tree.flatten_with_names(state_like)
        try:
            shard_flat = self._shard_leaves(shardings, named, "restore")
        except ValueError as e:         # config bug, not a skippable step
            raise StateShapeError(str(e)) from e
        entries = gm.leaves()
        d = os.path.join(root, f"step_{step}")
        out = []
        with self.obs.tracer.span("restore.read", step=step), \
                ShardReader(d, int(gm.manifest.get("shards", 0) or 1)) as rd:
            fetcher = _LevelFetcher(self, root, step, rd,
                                    self._l2_for_root(root),
                                    gm.process_count, stats)
            for (name, leaf), sh in zip(named, shard_flat):
                e = entries.get(name)
                if e is None:
                    stats["missing_leaves"].append(name)
                    out.append(leaf)
                    continue
                out.append(self._restore_leaf(fetcher, e, leaf, sh, fill,
                                              mode, stats, chain_packed,
                                              local_only))
        self.last_restore_stats = self.obs.registry.publish(
            "restore", stats)
        reg = self.obs.registry
        reg.counter("restore.h2d_bytes").inc(int(stats["h2d_bytes"]))
        reg.counter("restore.bytes_read").inc(int(stats["bytes_read"]))
        if stats["bytes_read_store"] == 0 and (stats["bytes_read_l2"]
                                               or stats["bytes_l1"]):
            # the zero-shared-store-read guarantee of a partner restore
            reg.counter("restore.partner_served").inc()
        return step, _tree.unflatten(treedef, out)

    def _target_ranges(self, shape, sh, local_only=False):
        """This host's target leading-axis row ranges: per piece from the
        layout when given, else (``local_only``) this process's ownership
        split, else the whole leaf."""
        if sh is not None:
            segs = leading_axis_device_segments(sh, shape)
            if segs is not None:
                return [(a, b, dev) for a, b, dev in segs]
        if local_only and self.ctx.count > 1 and shape:
            return [(a, b, None) for a, b, owner
                    in process_segments(shape, self.ctx.count)
                    if owner == self.ctx.index]
        rows = shape[0] if shape else 1
        return [(0, rows, None)]

    def _restore_leaf(self, fetcher, e, leaf, sh, fill, mode, stats,
                      chain_packed, local_only=False):
        shape = tuple(e["shape"])
        dtype = e["dtype"]
        want = tuple(getattr(leaf, "shape", ()))
        if want and want != shape:
            raise StateShapeError(
                f"leaf {e['name']}: checkpoint shape {shape} "
                f"vs state {want}")
        row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        targets = self._target_ranges(shape, sh, local_only)
        if chain_packed is not None:
            return self._assemble(shape, dtype, leaf, fill, mode, stats,
                                  _chain_pieces(chain_packed[e["name"]],
                                                targets, row, fill))

        segs = GlobalManifest.segments_of(e)
        isz = itemsize(dtype)
        # per-segment mask decode, computed once however many target
        # ranges intersect the segment
        seg_cache: Dict[int, Any] = {}

        def seg_mask(i, s):
            if i not in seg_cache:
                seg_cache[i] = segment_mask(s, int(s["stop"]) -
                                            int(s["start"]))
            return seg_cache[i]

        def read_checked(s, start_b, nbytes):
            """Level-cascade range read; a read spanning the whole entry is
            CRC-checked against the manifest (partial ranges are
            counted)."""
            raw = fetcher.read(e["name"], s, start_b, nbytes)
            if start_b == 0 and nbytes == int(s["length"]):
                if zlib.crc32(raw) != s["checksum"]:
                    raise IOError(
                        f"checksum mismatch for leaf {e['name']} segment "
                        f"[{s['start']}, {s['stop']})")
            else:
                stats["unverified_ranges"] = \
                    stats.get("unverified_ranges", 0) + 1
            return raw

        pieces = []
        for a, b, dev in targets:
            flo, fhi = a * row, b * row
            pay_parts = []
            marks = []          # (lo, hi, mask slice) of masked segments
            dense = True        # every intersecting segment stored whole
            for i, s in enumerate(segs):
                s0, s1 = int(s["start"]), int(s["stop"])
                lo, hi = max(flo, s0), min(fhi, s1)
                if lo >= hi:
                    continue
                if s["encoding"] == "full":     # raw element range
                    pay_parts.append(read_checked(
                        s, (lo - s0) * isz, (hi - lo) * isz))
                    marks.append((lo - flo, hi - flo, None))
                    continue
                dense = False
                if int(s["length"]) == 0:       # no critical element
                    continue
                sm = seg_mask(i, s)
                p0 = int(np.count_nonzero(sm[:lo - s0]))
                p1 = p0 + int(np.count_nonzero(sm[lo - s0:hi - s0]))
                if p1 > p0:
                    pay_parts.append(read_checked(
                        s, p0 * isz, (p1 - p0) * isz))
                marks.append((lo - flo, hi - flo, sm[lo - s0:hi - s0]))
            buf = np.empty(sum(len(x) for x in pay_parts), np.uint8)
            off = 0
            for x in pay_parts:
                buf[off:off + len(x)] = np.frombuffer(x, np.uint8)
                off += len(x)
            payload = buf.view(host_dtype(dtype))
            mask = None
            if not dense:
                mask = np.zeros(fhi - flo, bool)
                for lo, hi, sm in marks:
                    mask[lo:hi] = True if sm is None else sm
            pieces.append((a, b, dev, payload, mask))
        return self._assemble(shape, dtype, leaf, fill, mode, stats, pieces)

    def _assemble(self, shape, dtype, leaf, fill, mode, stats, pieces):
        """Expand per-target-range pieces ``(a, b, device, payload, mask)``
        and assemble the leaf.  ``mask`` None: the payload is the range's
        every element.

        Device mode moves a dense range as it is and expands a masked one
        with K4 (payload + the range's mask words H2D only; a range with
        no critical element moves no words and launches no K4) into a
        fill-initialized tensor of the leaf's shape; rows outside every
        target range hold ``fill``.  Host mode expands on the host and
        moves the leaf."""
        want = (leaf_dtype_name(leaf) if isinstance(leaf, torch.Tensor)
                else dtype)
        row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        full_n = int(np.prod(shape)) if shape else 1
        use_dev = mode in ("auto", "device")
        home = next((dev for _, _, dev, _, _ in pieces if dev is not None),
                    self.device)

        def cast(t):
            return t if want == dtype else t.to(torch_dtype(want))

        if use_dev:
            def expand_dev(payload, mask, local_n, device):
                if mask is None or payload.size == local_n:
                    stats["h2d_bytes"] += payload.nbytes
                    return from_host(payload, dtype, device)
                arr, moved = scatter_sharded_payload(
                    payload, mask, (local_n,), dtype, device, fill=fill)
                stats["h2d_bytes"] += moved
                return arr

            if len(pieces) == 1 and pieces[0][0] == 0 \
                    and (pieces[0][1] * row == full_n or not shape):
                _, _, dev, payload, mask = pieces[0]
                return cast(expand_dev(payload, mask, full_n, dev or home)
                            .reshape(shape))
            out = torch.full((full_n,), fill, dtype=torch_dtype(dtype),
                             device=home)
            for a, b, dev, payload, mask in pieces:
                out[a * row:b * row] = expand_dev(
                    payload, mask, (b - a) * row, dev or home).to(home)
            return cast(out.reshape(shape))

        # host expand: target ranges expanded, the rest is fill
        outp = np.full(full_n, fill_host(fill, dtype), host_dtype(dtype))
        for a, b, _dev, payload, mask in pieces:
            if mask is None:
                outp[a * row:b * row] = payload
            else:
                seg = np.full((b - a) * row, fill_host(fill, dtype),
                              host_dtype(dtype))
                seg[mask] = payload
                outp[a * row:b * row] = seg
        stats["h2d_bytes"] += outp.nbytes
        return cast(from_host(outp.reshape(shape), dtype, home))


def _chain_pieces(p, targets, row, fill):
    """Target-range pieces ``(a, b, device, payload, mask)`` of a leaf
    reconstructed from a delta chain (or a tiered step): a masked leaf's
    payload sliced at each range's prefix counts beside the range's mask, so
    a device restore expands it with K4 as a range read's piece; a full or
    precision-tiered leaf (variable-width payload) is expanded on the
    host."""
    if p.encoding == "full" or p.region_tiers:
        full = unpack_leaf(p, fill=fill).reshape(-1)
        return [(a, b, dev, full[a * row:b * row], None)
                for a, b, dev in targets]
    if zlib.crc32(p.payload) != p.checksum:
        raise IOError(f"checksum mismatch for leaf {p.name}")
    mask = leaf_mask(p)
    payload = np.frombuffer(p.payload, host_dtype(p.dtype))
    pieces = []
    for a, b, dev in targets:
        flo, fhi = a * row, b * row
        sm = mask[flo:fhi]
        p0 = int(np.count_nonzero(mask[:flo]))
        p1 = p0 + int(np.count_nonzero(sm))
        pieces.append((a, b, dev, payload[p0:p1], sm))
    return pieces
