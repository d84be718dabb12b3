"""Async, multi-level, differential checkpoint manager with scrutinized
reduction, device-resident save *and* restore paths, and a **pipelined
asynchronous save engine** (port of ``repro.checkpoint.manager``).

- **Pipelined async save**: ``save()`` only blocks the caller for the
  snapshot (stage 1); everything else runs off the critical path:

    stage 1 (device)   batched pack — one ``pack_group`` call per
                       (device, dtype) group compacts every scrutinized
                       leaf with the K2 kernel on the caller's current
                       stream (payload sizes come from the criticality
                       report, so **no counts D2H** is needed);
    stage 2 (transfer) chunked D2H — the payload streams host-ward in
                       fixed-size chunks into pinned buffers with
                       non-blocking copies on a side stream that waits on
                       an event recorded after stage 1;
    stage 3 (I/O)      streamed shard writes — ``store._write_stream``
                       places chunks at their final shard offsets with
                       incremental CRC, with per-shard writes overlapped on
                       the io pool (``max(2, shards)`` threads).

  The "host" engine (CPU tensors) specializes the same pipeline: stage 1
  copies each leaf to host memory and the pack is a vectorized numpy
  gather on the writer side.  On-disk bytes are identical across engines
  and to the reference package's.  A save with precision tiers takes the
  host engine on the card too, as in the reference: the tiers are encoded
  from host magnitudes (``last_save_stats["host_reason"] == "tiered"``).

- **Snapshot isolation**: torch tensors are mutable, so the snapshot is
  taken explicitly before ``save(block=False)`` returns.  Scrutinized
  leaves are packed by stage 1 into a fresh payload buffer on the caller's
  current stream — stream order guarantees the pack reads the bytes as
  they were at ``save()``.  Leaves saved whole on the device path
  (``dev_raw``: all-critical, or every leaf of a save with no report) are
  ``clone()``d at ``save()``, which costs device memory for those leaves
  only (a second copy of the whole state for an unscrutinized save); their
  D2H runs on the writer's side.  The host engine copies every leaf
  synchronously.  A caller that mutates the state
  on *another* stream must synchronize that stream with the current one
  before calling ``save()``.

- **Async**: per level at most one write is in flight (double buffering);
  ``io_threads`` (default: scales with the level shard counts) bounds the
  transfer/writer parallelism; ``close()``/``wait()`` drain and surface
  writer errors exactly once.
- **Multi-level**: a list of (directory, interval) levels; restore picks
  the newest complete level.
- **Scrutinized**: a CriticalityReport reduces what is written;
  re-scrutinize every ``rescrutinize_every`` saves (0: once, at the first
  save).  A ``DeviceReport``'s masks stay resident on device for the save
  path, and re-scrutiny is incremental (``DeviceReport.reuse_unchanged``):
  an unchanged re-scrutiny keeps the same report object, so differential
  chains stay alive.  ``soundness_check(state, report)`` runs on every
  fresh report before it is adopted (a raising check writes nothing).
  A leaf with no critical element costs no mask work: its report gives an
  empty mask and region table without a D2H, its pack launches no K2, and
  its restore sends no mask bits and launches no K4.
- **Differential chains** (``Level.max_chain``): a level keeps its previous
  save's payload sources resident (on device on the device engine) and
  writes only byte-chunks that changed since the previous step (K3).
  After ``max_chain`` deltas, or whenever the report / state structure
  changes, the chain is squashed with a fresh base.  ``_gc`` is
  chain-aware.
- **Device-resident restore** (``restore_mode``): ``restore`` streams each
  leaf's payload from disk (delta chains reconstructed), moves only the
  critical payload and the stored mask H2D, and re-expands on device with
  the K4 kernel.  The mask crosses as it is stored: a region table, whose
  words the K8 kernel writes on the device, or a bitmap, which already is
  the words; no host mask is made.  The walk reads each stored byte
  once, into the buffer that moves H2D (no host copy: ``host_copy_bytes``
  0).  ``last_restore_stats`` records the H2D bytes, under
  ``mask_words`` how many leaves took each way, and the walk's
  ``read_into_bytes``, ``delta_chunks`` and ``delta_runs``.
- **Retention**: keep_n restorable steps per level + their chain
  dependencies; stale ``.tmp_step_*`` dirs from crashed writers are swept.

``last_save_stats`` (``blocked_s``, ``stages``, ``engine``, ``d2h_bytes``)
and ``last_restore_stats`` are immutable snapshots published through the
``repro_torch.obs`` metrics registry.
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import obs as obs_mod
from repro_torch._tensors import (check_on, from_host, host_copy_nbytes,
                                  host_dtype, itemsize, leaf_dtype_name,
                                  resolve_device, to_host, torch_dtype)
from repro_torch.checkpoint.packing import (DeltaLeaf, delta_encode_host,
                                            pack_leaf, packed_leaf_stub,
                                            unpack_leaf)
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.checkpoint.pipeline import (D2H_CHUNK_BYTES, QueueSource,
                                             TransferStream, ViewSource,
                                             fetch_to_host, run_transfers)
from repro_torch.checkpoint.store import (StreamLeaf, committed_steps,
                                          load_checkpoint_raw,
                                          pending_step_of_entry,
                                          save_checkpoint,
                                          save_delta_checkpoint,
                                          sweep_retention,
                                          tmp_owner_of_entry,
                                          tmp_step_of_entry,
                                          tmp_writer_alive)
from repro_torch.core.criticality import CriticalityReport, DeviceReport
from repro_torch.distributed.sharding import scatter_sharded_payload
from repro_torch.kernels.mask_pack import ops as mask_ops


@dataclasses.dataclass
class Level:
    directory: str
    interval: int = 1
    keep_n: int = 2
    shards: int = 1
    parity: bool = False
    # >0 enables differential chains: up to max_chain delta saves ride on
    # each base before the chain is squashed with a fresh base.
    max_chain: int = 0


@dataclasses.dataclass
class _ChainState:
    """Per-level differential-chain bookkeeping.  ``kinds``/``meta`` are
    filled synchronously at plan time; ``sources`` (the previous save's
    payloads — numpy arrays on the host engine, tensors on the device
    engine) is filled by that save's pipeline job.  The double buffer
    drains the job before the next save for the level plans, so a planned
    delta always sees resolved sources."""
    base_step: int
    chain: List[int]                   # delta steps since base, in order
    report: Optional[CriticalityReport]
    kinds: Dict[str, str]              # name -> dev_payload | dev_raw | host
    meta: Dict[str, Tuple]             # name -> (shape, dtype)
    sources: Optional[Dict[str, Any]] = None


def _host_snapshot(leaf) -> np.ndarray:
    """Isolation-safe host snapshot of one leaf: a copy that shares no
    memory with it.  The reference's zero-copy ``np.asarray`` relies on
    jax arrays being immutable; a torch leaf (on the CPU too) is updated
    in place by the optimizer, so a view would let a later step reach a
    save still in flight."""
    return to_host(leaf, copy=True)


def update_report(scrutiny_fn, prev, saves: int, every: int, state,
                  check=None):
    """The scrutiny schedule (shared by this manager and the multi-host
    coordinator): run ``scrutiny_fn`` when there is no report
    yet or the re-scrutinize interval fires.  A device report
    re-scrutinizes incrementally (``DeviceReport.reuse_unchanged``): an
    unchanged re-scrutiny returns the *identical* report object, which is
    what keeps differential chains keyed on report identity alive.
    Returns ``(report, ran)``; ``ran`` tells the caller fresh scrutiny
    stats are on the report.

    ``check``: optional ``check(state, report)`` hook run on every *fresh*
    report before it is adopted, e.g.
    ``repro_torch.analysis.soundness_checker(fn)``, which verifies the AD
    masks against the static analysis and raises on a violation, so an
    unsound report never reduces a checkpoint."""
    if scrutiny_fn is None:
        return None, False
    need = prev is None or (every and saves % every == 0)
    if not need:
        return prev, False
    new = scrutiny_fn(state)
    if check is not None:
        check(state, new)
    if (new is not prev and isinstance(new, DeviceReport)
            and isinstance(prev, DeviceReport)):
        new = new.reuse_unchanged(prev)
    return new, True


def _region_count(p) -> int:
    """Runs a packed leaf's mask is stored as (0 for a bitmap)."""
    return len(p.aux) // 16 if p.encoding == "regions" else 0


# ``last_restore_stats["mask_words"]``: device-restored leaves whose words
# were written on the device from their region table (K8 on the card), or
# sent as their stored bitmap, by the stored encoding.
_WORDS_FROM = {"regions": "regions_on_card", "bitmap": "bitmap_aux"}


def _leaf_words(p, n: int, device) -> Tuple[torch.Tensor, int]:
    """A masked leaf's ``np.packbits`` words on ``device``, straight from
    its stored aux, and the bytes that crossed H2D for them.  A region
    table crosses as it is stored, 16 B a run, and K8
    (``mask_ops.regions_words``) writes the words where it lands; a
    bitmap's aux already is the words.  No host mask is made."""
    if p.encoding == "bitmap":
        bits = np.frombuffer(p.aux, np.uint8)
        return from_host(bits, "uint8", device), bits.nbytes
    regions = np.frombuffer(p.aux, np.int64).reshape(-1, 2)
    starts, stops = regions[:, 0], regions[:, 1]
    if len(regions) and not ((starts < stops).all()
                             and (starts[1:] >= stops[:-1]).all()
                             and starts[0] >= 0 and stops[-1] <= n):
        raise ValueError(f"leaf {p.name}: its region table is not sorted, "
                         f"disjoint runs within its {n} elements")
    table = from_host(regions, "int64", device)
    return mask_ops.regions_words(table, n=n), regions.nbytes


def _nbytes(x) -> int:
    return int(x.nbytes)


def _entry_nbytes(e) -> int:
    """Disk-accounting bytes of a delta-save entry (payload + aux)."""
    if isinstance(e, StreamLeaf):
        return int(e.length) + len(e.leaf.aux) + len(e.leaf.region_tiers)
    return int(e.nbytes)


class _SaveSnapshot:
    """One save's frozen view of the state.

    Construction runs synchronously inside ``save()`` (this is *all* the
    caller blocks for): leaf classification, snapshot isolation (host
    copies / device clones), and the stage-1 batched pack.  Everything else
    — payload materialization, manifest metas, delta diffs, transfers —
    happens lazily on the pipeline job threads, memoized so several levels
    share one snapshot's work.
    """

    def __init__(self, mgr: "CheckpointManager", state, report):
        self.mgr = mgr
        self.report = report
        self.tiered = mgr._tiered()
        self.device = mgr._device_eligible()
        self.engine = mgr._engine if self.device else "host"
        # on the card the host engine is reached only through precision
        mgr._check_mode("save engine", self.engine, tiered=self.tiered)
        named, self.treedef = _tree.flatten_with_names(state)
        self.items: List[Tuple[str, Any, Any, str]] = []
        self.full_bytes = 0
        for name, leaf in named:
            check_on(leaf, mgr.device, f"save leaf {name!r}")
            rep = report.leaves.get(name) if report is not None else None
            is_dev = isinstance(leaf, torch.Tensor) and leaf.numel() > 0
            if (self.device and rep is not None and not rep.all_critical
                    and is_dev):
                kind = "dev_payload"
            elif self.device and is_dev:
                kind = "dev_raw"
            else:
                kind = "host"
            self.items.append((name, leaf, rep, kind))
            self.full_bytes += (_nbytes(leaf) if is_dev
                                else to_host(leaf).nbytes)
        self._by_name = {it[0]: it for it in self.items}
        self._kinds_meta = None
        # stage 1 (synchronous): host copies / device clones and packs
        self._views: Dict[str, np.ndarray] = {}
        self._flats: Dict[str, Any] = {}          # device: cloned raw leaves
        self._groups: Dict[Any, Dict[str, Any]] = {}
        self.ready = None      # CUDA event after stage 1 (card only)
        self._pin_and_dispatch()
        # lazy job-side state
        self._lock = threading.Lock()
        self._entries: Dict[str, Any] = {}
        self._payloads: Dict[str, np.ndarray] = {}   # host payload arrays
        self._group_host: Dict[Any, np.ndarray] = {}
        self._sources: Dict[str, Any] = {}
        self._queues: Dict[str, QueueSource] = {}
        self._group_sinks: Dict[Any, List] = {}
        self._stream_specs: List[Tuple[str, Any]] = []
        self._abort = threading.Event()
        self.use_stream = False       # set by the manager before jobs run
        self.stats: Optional[Dict[str, Any]] = None
        self._stats_lock = threading.Lock()
        self.obs_handle = None        # cross-thread save span (obs)
        self.obs_mark = 0             # trace-buffer mark at dispatch
        self.jobs_left = 0            # level jobs still to drain
        self.fired_levels: List[Level] = []

    # stats are shared by every level job of this save: guard the
    # read-modify-write updates so concurrent jobs don't drop each other's
    def stat_add(self, key: str, v) -> None:
        with self._stats_lock:
            self.stats[key] += v

    def stage_max(self, name: str, v: float) -> None:
        with self._stats_lock:
            stages = self.stats["stages"]
            stages[name] = max(stages.get(name, 0.0), v)

    def stat_level(self, level: str, key: str, v) -> None:
        with self._stats_lock:
            self.stats["levels"][level][key] = v

    # ---------------- stage 1: snapshot + batched pack --------------------

    def _pin_and_dispatch(self):
        on_card = False
        for name, leaf, rep, kind in self.items:
            if kind == "host" or self.engine == "host":
                self._views[name] = _host_snapshot(leaf)
                continue
            on_card = on_card or leaf.device.type == "cuda"
            # device engine: clone / pack now, on the caller's stream, so
            # later in-place updates of the state cannot reach the save
            if kind == "dev_raw":
                self._flats[name] = leaf.detach().reshape(-1).clone()
                continue
            key = (leaf_dtype_name(leaf), str(leaf.device))
            g = self._groups.setdefault(
                key, {"names": [], "flats": [], "words": [], "totals": []})
            g["names"].append(name)
            g["flats"].append(leaf.detach().reshape(-1))
            g["words"].append(rep.device_words(leaf.device))
            g["totals"].append(int(rep.critical))
        for g in self._groups.values():
            payload, counts = mask_ops.pack_group(
                g["flats"], g["words"], g["totals"])
            ranges, lo = {}, 0
            for n_, t in zip(g["names"], g["totals"]):
                ranges[n_] = (lo, lo + t)
                lo += t
            g["payload"], g["counts"], g["ranges"] = payload, counts, ranges
            del g["flats"], g["words"]       # the payload is the snapshot
        if on_card:
            self.ready = torch.cuda.Event()
            self.ready.record()

    # ---------------- accounting ------------------------------------------

    def d2h_estimate(self, delta_only: bool = False) -> int:
        """Bytes that cross (or on the host engine: would cross) the
        device→host boundary for a base save — the critical payload for
        packed leaves, full bytes otherwise.  Per-tile counts never move:
        payload sizes come from the criticality report.  For delta-only
        saves the payload stays resident too and the jobs add the measured
        flag/changed-chunk traffic on top of this floor."""
        est = 0
        for name, leaf, rep, kind in self.items:
            if kind == "dev_payload":
                if not delta_only:
                    est += int(rep.critical) * itemsize(leaf_dtype_name(leaf))
            elif kind == "dev_raw":
                est += _nbytes(leaf) if not delta_only else 0
            else:
                est += int(self._views[name].nbytes)
        return est

    def kinds_meta(self):
        if self._kinds_meta is None:
            kinds = {name: kind for name, _, _, kind in self.items}
            meta = {name: (tuple(getattr(leaf, "shape", ())),
                           leaf_dtype_name(leaf))
                    for name, leaf, _, _ in self.items}
            self._kinds_meta = (kinds, meta)
        return self._kinds_meta

    def abort(self):
        self._abort.set()

    # ---------------- entries (manifest metas + payload sources) ----------

    def entry(self, name: str):
        with self._lock:
            if name not in self._entries:
                self._entries[name] = self._build_entry(*self._by_name[name])
            return self._entries[name]

    def entries_all(self) -> List[Any]:
        return [self.entry(name) for name, *_ in self.items]

    def _build_entry(self, name, leaf, rep, kind):
        if kind == "host":
            arr = self._views[name]
            mask = rep.mask if rep is not None else None
            mag = rep.magnitude if (rep is not None and self.tiered) else None
            return pack_leaf(name, arr, mask, mag, self.mgr.precision,
                             dtype=leaf_dtype_name(leaf))
        shape = tuple(leaf.shape)
        dtype = leaf_dtype_name(leaf)
        chunk = self.mgr._chunk_bytes
        if kind == "dev_raw":
            stub = packed_leaf_stub(name, shape, dtype, None, _nbytes(leaf))
            return StreamLeaf(stub, _nbytes(leaf),
                              self._raw_source(name, leaf, chunk))
        # dev_payload: aux from the (cached) host mask/regions; the payload
        # itself streams — byte-identical to pack_leaf on the host array.
        mask = rep.mask
        regions = rep.table.regions
        plen = int(rep.critical) * itemsize(dtype)
        stub = packed_leaf_stub(name, shape, dtype, mask, plen,
                                regions=regions)
        return StreamLeaf(stub, plen,
                          self._payload_source(name, leaf, rep, plen, chunk))

    def _raw_source(self, name, leaf, chunk):
        if self.engine == "host":
            return ViewSource([self._views[name]], chunk)
        flat = self._flats[name]
        if not self.use_stream:
            return ViewSource([fetch_to_host([flat], chunk,
                                             ready=self.ready)], chunk)
        q = QueueSource(_nbytes(leaf), abort=self._abort)
        self._queues[name] = q
        self._stream_specs.append(("flat", name))
        return q

    def _payload_source(self, name, leaf, rep, plen, chunk):
        if self.engine == "host":
            return ViewSource([self._host_payload(name, leaf, rep)], chunk)
        key, (lo, hi) = self._group_of(name)
        if not self.use_stream:
            g = self._groups[key]
            if key not in self._group_host:
                self._group_host[key] = fetch_to_host([g["payload"]], chunk,
                                                      ready=self.ready)
            isz = itemsize(leaf_dtype_name(leaf))
            return ViewSource(
                [self._group_host[key][lo * isz:hi * isz]], chunk)
        q = QueueSource(plen, abort=self._abort)
        self._queues[name] = q
        self._group_sinks.setdefault(key, [])
        if not self._group_sinks[key]:
            self._stream_specs.append(("group", key))
        self._group_sinks[key].append((q, lo, hi))
        return q

    def _group_of(self, name):
        for key, g in self._groups.items():
            if name in g["ranges"]:
                return key, g["ranges"][name]
        raise KeyError(name)

    def _host_payload(self, name, leaf, rep) -> np.ndarray:
        """Host-engine pack: one vectorized gather off the pinned view —
        identical bytes to the device compaction path."""
        if name not in self._payloads:
            flat = self._views[name].reshape(-1)
            self._payloads[name] = flat[rep.mask]
        return self._payloads[name]

    # ---------------- stage 2: transfer streams ---------------------------

    def build_streams(self):
        """(streams, write_order) for the single-consumer streaming mode:
        one producer feeds every entry queue in exactly this order, and the
        writer consumes entries in the same order — deadlock-free under
        bounded queues regardless of pool size."""
        idx_of = {it[0]: i for i, it in enumerate(self.items)}
        chunk = self.mgr._chunk_bytes
        streams, order = [], []
        for what, key in self._stream_specs:
            if what == "flat":
                arr = self._flats[key]
                sinks = [(self._queues[key], 0, int(arr.shape[0]))]
                order.append(idx_of[key])
            else:
                g = self._groups[key]
                arr = g["payload"]
                sinks = self._group_sinks[key]
                order.extend(idx_of[n]
                             for n in g["names"] if n in self._queues)
            streams.append(TransferStream(arr, sinks, chunk, self.ready))
        seen = set(order)
        order += [i for i in range(len(self.items)) if i not in seen]
        return streams, order

    # ---------------- delta sources / diffs -------------------------------

    def delta_source(self, name: str):
        with self._lock:
            if name not in self._sources:
                self._sources[name] = self._build_source(*self._by_name[name])
            return self._sources[name]

    def _build_source(self, name, leaf, rep, kind):
        if kind == "host":
            p = self._entries.get(name)
            if p is None:
                p = self._build_entry(name, leaf, rep, kind)
                self._entries[name] = p
            return np.frombuffer(p.payload, np.uint8)
        if kind == "dev_raw":
            return (self._views[name] if self.engine == "host"
                    else self._flats[name])
        if self.engine == "host":
            return self._host_payload(name, leaf, rep)
        key, (lo, hi) = self._group_of(name)
        return self._groups[key]["payload"][lo:hi]

    def chain_sources(self) -> Dict[str, Any]:
        return {name: self.delta_source(name) for name, *_ in self.items}

    def build_deltas(self, prev_sources: Dict[str, Any], chunk_bytes: int):
        """Diff every leaf against the chain's resident previous sources.
        numpy-vs-numpy pairs diff on host (byte-identical to the device
        encoder); device pairs diff on device so only changed chunks cross
        D2H.  A leaf whose payload size/kind changed falls back to a full
        entry.  Returns (entries dict, measured/equivalent moved bytes)."""
        if self.ready is not None:
            # this writer thread's stream must not read the stage-1
            # payloads before the caller's stream has produced them
            self.ready.wait()
        out: Dict[str, Any] = {}
        moved_total = 0
        for name, leaf, rep, kind in self.items:
            prev = prev_sources[name]
            curr = self.delta_source(name)
            try:
                host_pair = isinstance(curr, np.ndarray)
                if host_pair != isinstance(prev, np.ndarray):
                    raise ValueError("delta source kind changed")
                if host_pair:
                    idx, pay = delta_encode_host(curr, prev, chunk_bytes)
                    moved = pay.nbytes + (-(-int(curr.nbytes) // chunk_bytes))
                else:
                    idx, pay, moved = mask_ops.delta_encode(
                        curr, prev, chunk_bytes=chunk_bytes)
            except (ValueError, TypeError):
                out[name] = self.entry(name)
                continue
            pay_b = pay.tobytes()
            out[name] = DeltaLeaf(
                name=name, shape=tuple(getattr(leaf, "shape", ())),
                dtype=leaf_dtype_name(leaf),
                chunk_bytes=chunk_bytes, total_bytes=_nbytes(curr),
                idx=idx, payload=pay_b, checksum=zlib.crc32(pay_b))
            moved_total += int(moved)
        return out, moved_total


class CheckpointManager:
    """``save_mode``: "auto"/"device" save on the state's device: packed
    scrutinized leaves (K2), device clones of the rest, and of every leaf
    of a save with no report; "host" snapshots the full state to host
    memory and packs there.

    ``precision``: beyond-paper precision tiers of the critical elements.
    A tiered save encodes on the host from the report's magnitudes (the
    reference's design; no kernel tiers), and a tiered leaf restores
    through the host expand.

    ``rescrutinize_every``: re-run ``scrutiny_fn`` every that many saves
    (0: only at the first save); see :func:`update_report`.
    ``soundness_check``: ``check(state, report)`` run on every fresh
    report before it is adopted; an exception raises out of ``save()``.

    ``delta_chunk_bytes``: chunk size of the differential saves (K3).
    ``io_threads``: transfer/writer parallelism (default: the largest
    level shard count, at least 2).  ``io_chunk_bytes``: the D2H and write
    chunk size.  ``writer_ttl_s``: seconds after which a foreign writer's
    tmp dir counts as abandoned and is swept.

    ``device``: where the state lives and the kernels run — the card
    unless ``"cpu"`` is asked for; a leaf on another device raises.

    ``pipeline_engine``: "auto" picks "device" on the card (stage-1 K2
    pack on the caller's stream + chunked pinned D2H streaming) and
    "host" for CPU tensors (host copies + vectorized host gather).
    Forcing "device" on CPU runs the device engine's code path with the
    kernels' plain versions (tests).

    ``restore_mode``: "auto"/"device" expand masked leaves on device
    (payload-only H2D, K4); "host" expands on the host and moves full
    arrays.

    On the card, every "host" value raises: it would move the pack (K2)
    or the expand (K4) to the CPU while the tensors are on the card.

    Supports ``with CheckpointManager(...) as mgr:`` — exit drains in-flight
    writes and shuts the writer pools down (``close()``).
    """

    def __init__(self, levels: Sequence[Level],
                 scrutiny_fn: Optional[Callable[[Any], CriticalityReport]] = None,
                 precision: Optional[PrecisionPolicy] = None,
                 rescrutinize_every: int = 0,
                 save_mode: str = "auto",
                 restore_mode: str = "auto",
                 delta_chunk_bytes: int = mask_ops.DELTA_CHUNK_BYTES,
                 io_threads: Optional[int] = None,
                 pipeline_engine: str = "auto",
                 io_chunk_bytes: Optional[int] = None,
                 writer_ttl_s: float = 600.0,
                 soundness_check: Optional[Callable[[Any, Any], Any]] = None,
                 device=None):
        self.device = resolve_device(device)
        for opt, val in (("save_mode", save_mode),
                         ("restore_mode", restore_mode),
                         ("pipeline_engine", pipeline_engine)):
            self._check_mode(opt, val)
        self.levels = list(levels)
        for lv in self.levels:
            os.makedirs(lv.directory, exist_ok=True)
        self.scrutiny_fn = scrutiny_fn
        self.precision = precision
        self.rescrutinize_every = rescrutinize_every
        self.soundness_check = soundness_check
        self.save_mode = save_mode
        self.restore_mode = restore_mode
        self.delta_chunk_bytes = int(delta_chunk_bytes)
        if pipeline_engine == "auto":
            pipeline_engine = ("device" if self.device.type == "cuda"
                               else "host")
        self._engine = pipeline_engine
        max_shards = max((lv.shards for lv in self.levels), default=1)
        self.io_threads = (int(io_threads) if io_threads is not None
                           else max(2, max_shards))
        if self.io_threads < 1:
            raise ValueError("io_threads must be >= 1")
        self._chunk_bytes = (int(io_chunk_bytes) if io_chunk_bytes
                             else D2H_CHUNK_BYTES)
        # Per-writer owner token: tmp dirs are written as
        # ``.tmp_step_<N>.<token>`` with a liveness file inside, so two
        # managers sharing one directory never sweep each other's
        # in-flight step (the sweep skips live foreign tokens).
        self._owner = os.urandom(4).hex()
        self._writer_ttl_s = float(writer_ttl_s)
        self._report: Optional[CriticalityReport] = None
        self._saves = 0
        # job pool: one pipeline job per level write (double-buffered, so
        # at most len(levels) jobs are ever live)
        self._pool: Optional[cf.ThreadPoolExecutor] = \
            cf.ThreadPoolExecutor(max_workers=max(1, len(self.levels)))
        # io pool: transfer producers + overlapped per-shard writes
        self._io_pool: Optional[cf.ThreadPoolExecutor] = \
            cf.ThreadPoolExecutor(max_workers=self.io_threads)
        self._inflight: Dict[str, cf.Future] = {}
        self._tel_pool: Optional[cf.ThreadPoolExecutor] = None
        self._tel_futs: List[cf.Future] = []
        self._chains: Dict[str, _ChainState] = {}
        self._lock = threading.Lock()
        # telemetry bundle (tracer + metrics registry + drift tracker)
        self.obs = obs_mod.get_obs()
        self.last_save_stats: Optional[Dict[str, Any]] = None
        self.last_restore_stats: Optional[Dict[str, Any]] = None
        self.last_scrutiny_stats: Optional[Dict[str, Any]] = None
        self._live_save_stats: Optional[Dict[str, Any]] = None

    def _check_mode(self, opt: str, val: str, tiered: bool = False) -> None:
        """Refuse a "host" mode on the card: it would move K2's pack or
        K4's expand to the CPU.  Precision tiers (``tiered``) are the one
        way the card's saves take the host engine."""
        if val not in ("auto", "host", "device"):
            raise ValueError(f"unknown {opt} {val!r}")
        if val == "host" and self.device.type == "cuda" and not tiered:
            raise ValueError(
                f'{opt}="host" would pack or expand on the CPU while the '
                f'state is on the card; keep it on the card, or pass '
                f'device="cpu" with tensors on the CPU')

    # --- lifecycle -------------------------------------------------------

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self):
        """Drain in-flight writes (propagating any writer exception) and
        shut the pools down.  Idempotent; ``save`` raises afterwards."""
        if self._pool is None:
            return
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
            if self._io_pool is not None:
                self._io_pool.shutdown(wait=True)
            if self._tel_pool is not None:
                self._tel_pool.shutdown(wait=True)
            self._pool = None
            self._io_pool = None
            self._tel_pool = None

    def wait(self):
        """Block until every in-flight write lands.  Clears the in-flight
        table first, so each writer exception propagates exactly once.
        Returns the finalized ``last_save_stats`` snapshot (the level jobs
        republish it as they drain), or None if nothing was saved."""
        futs = list(self._inflight.values())
        self._inflight.clear()
        errs = []
        for f in futs:
            try:
                f.result()
            except Exception as e:      # noqa: BLE001 - re-raised below
                errs.append(e)
        with self._lock:
            tel, self._tel_futs = self._tel_futs, []
        for f in tel:
            f.result()          # best-effort writes never raise
        if errs:
            raise errs[0]
        return self.last_save_stats

    # --- save ------------------------------------------------------------

    def maybe_report(self, state) -> Optional[CriticalityReport]:
        """Run (or re-run) scrutiny on :func:`update_report`'s schedule.
        Device reports re-scrutinize incrementally, and an unchanged
        re-scrutiny returns the identical report object, which keeps
        differential chains (``_delta_ok`` keys on report identity) alive
        across ``rescrutinize_every=1``."""
        with self.obs.tracer.span("scrutiny", saves=self._saves):
            new, ran = update_report(self.scrutiny_fn, self._report,
                                     self._saves, self.rescrutinize_every,
                                     state, check=self.soundness_check)
        if ran:
            # live view, not frozen: device reports account their lazy
            # mask D2H into this dict when materialized
            self.last_scrutiny_stats = getattr(new, "stats", None)
            if new is not None and self.obs.enabled:
                with self.obs.tracer.span("scrutiny.drift"):
                    self.obs.drift.observe(new, step=self._saves)
        self._report = new
        return self._report

    def _tiered(self) -> bool:
        return self.precision is not None and self.precision.enabled

    def _device_eligible(self) -> bool:
        """Device engine unless ``save_mode="host"`` or the tiers need the
        host's magnitudes; a save with no report takes it too (``dev_raw``
        for every leaf)."""
        return self.save_mode != "host" and not self._tiered()

    def _host_reason(self, snap) -> Optional[str]:
        if snap.engine != "host":
            return None
        if snap.tiered:
            return "tiered"
        return "save_mode" if self.save_mode == "host" else "engine"

    def _delta_ok(self, lv: Level, cs: Optional[_ChainState],
                  snap: _SaveSnapshot) -> bool:
        """A delta save is legal only while the chain's world is frozen:
        same report (masks), same leaves, chain not past max_chain, and the
        previous save's sources resolved (its job has landed)."""
        if cs is None or cs.sources is None or len(cs.chain) >= lv.max_chain:
            return False
        if snap.report is not cs.report:
            return False
        kinds, meta = snap.kinds_meta()
        return kinds == cs.kinds and meta == cs.meta

    def save(self, step: int, state, block: bool = False) -> List[cf.Future]:
        """Snapshot (pin views / dispatch the batched device pack), plan a
        base or delta write per firing level, and hand the rest to the
        pipeline — the caller is only blocked for the snapshot."""
        t0 = time.perf_counter()
        if self._pool is None:
            raise RuntimeError("CheckpointManager is closed")
        obs_mark = self.obs.buffer.mark()
        report = self.maybe_report(state)
        self._saves += 1
        t1 = time.perf_counter()
        with self.obs.tracer.span("save.snapshot", step=step):
            snap = _SaveSnapshot(self, state, report)
        level_stats: Dict[str, Any] = {}
        stats = {
            "mode": "device" if snap.device else "host",
            "engine": snap.engine,
            "host_reason": self._host_reason(snap),
            "d2h_bytes": 0,
            "full_bytes": int(snap.full_bytes),
            "packed_leaves": sum(1 for *_, k in snap.items
                                 if k == "dev_payload"),
            "levels": level_stats,
            "stages": {"snapshot_s": time.perf_counter() - t1},
            "blocked_s": 0.0,
        }
        snap.stats = stats
        snap.obs_mark = obs_mark
        snap.obs_handle = self.obs.tracer.begin(
            f"save/step_{step}", step=step, mode=stats["mode"],
            engine=stats["engine"])
        plans: List[Tuple[Level, Callable[[], str]]] = []
        any_base = False
        for lv in self.levels:
            if step % lv.interval:
                continue
            prev = self._inflight.pop(lv.directory, None)
            if prev is not None:
                prev.result()  # double buffer: at most one in flight/level

            cs = self._chains.get(lv.directory)
            if lv.max_chain > 0 and self._delta_ok(lv, cs, snap):
                prev_sources = cs.sources
                kinds, meta = snap.kinds_meta()
                cs.kinds, cs.meta = dict(kinds), dict(meta)
                cs.sources = None          # resolved by this save's job
                chain = [cs.base_step] + list(cs.chain)
                cs.chain.append(step)
                level_stats[lv.directory] = {
                    "kind": "delta", "base_step": cs.base_step,
                    "chain_len": len(cs.chain)}
                self.obs.registry.gauge("save.delta_chain_len").set(
                    len(cs.chain))

                def write(lv=lv, step=step, snap=snap, cs=cs, chain=chain,
                          prev_sources=prev_sources):
                    return self._run_delta(lv, step, snap, cs, chain,
                                           prev_sources)
            elif lv.max_chain > 0:
                kinds, meta = snap.kinds_meta()
                cs = _ChainState(base_step=step, chain=[], report=report,
                                 kinds=dict(kinds), meta=dict(meta))
                self._chains[lv.directory] = cs
                level_stats[lv.directory] = {"kind": "base"}
                any_base = True

                def write(lv=lv, step=step, snap=snap, cs=cs):
                    return self._run_base(lv, step, snap, capture=cs)
            else:
                level_stats[lv.directory] = {"kind": "base"}
                any_base = True

                def write(lv=lv, step=step, snap=snap):
                    return self._run_base(lv, step, snap, capture=None)

            plans.append((lv, write))

        # chunked D2H streaming needs a single consumer: enabled for a
        # lone base write on the device engine (several levels writing the
        # same step share materialized payloads instead)
        snap.use_stream = (snap.engine == "device"
                           and self._io_pool is not None
                           and any_base and len(plans) == 1)
        stats["d2h_bytes"] = (snap.d2h_estimate(delta_only=not any_base)
                              if plans else 0)

        snap.jobs_left = len(plans)
        snap.fired_levels = [lv for lv, _ in plans]
        futs = []
        for lv, write in plans:
            fut = self._pool.submit(self._run_job, write, snap, step)
            self._inflight[lv.directory] = fut
            futs.append(fut)
        stats["blocked_s"] = time.perf_counter() - t0
        # dispatch-time snapshot: immutable, safe to read before wait();
        # the level jobs republish a finalized snapshot as they drain.
        # Writers mutate only under snap._stats_lock, so the deep-freeze
        # below never iterates a dict another thread is resizing.
        with self._lock:
            self._live_save_stats = stats
        with snap._stats_lock:
            self.last_save_stats = self.obs.registry.publish("save", stats)
        self.obs.registry.counter("save.dispatches").inc()
        self.obs.registry.counter("save.d2h_bytes").inc(stats["d2h_bytes"])
        if not plans:
            snap.obs_handle.finish()
        if block:
            errs = []
            for f in futs:
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)
                finally:
                    # drained here: drop so a failure propagates exactly
                    # once instead of again at the next double-buffer drain
                    for k, v in list(self._inflight.items()):
                        if v is f:
                            del self._inflight[k]
            if errs:
                raise errs[0]
        return futs

    # --- pipeline jobs (writer threads) -----------------------------------

    def _submit_io(self):
        return self._io_pool.submit if self._io_pool is not None else None

    def _run_job(self, write, snap: _SaveSnapshot, step: int):
        """One level job + drain bookkeeping: when the last job of a save
        finishes (even on failure) its cross-thread span is closed and the
        finalized stats snapshot is republished."""
        try:
            return write()
        finally:
            self._job_done(snap, step)

    def _job_done(self, snap: _SaveSnapshot, step: int) -> None:
        with snap._stats_lock:
            snap.jobs_left -= 1
            done = snap.jobs_left <= 0
        if not done:
            return
        if snap.obs_handle is not None:
            snap.obs_handle.finish()
        with self._lock:
            live = self._live_save_stats is snap.stats
        if live:
            with snap._stats_lock:
                self.last_save_stats = self.obs.registry.publish(
                    "save", snap.stats)
        if self.obs.enabled:
            # spans snapshot now (so the next save's events don't smear
            # in); serialization + write go to a dedicated single-thread
            # executor — telemetry is best-effort and must ride neither
            # the blocked save path nor the data-path io pool (where it
            # would steal a thread from the next save's D2H/shard writes)
            events = self.obs.span_snapshot(snap.obs_mark)
            with self._lock:
                if self._tel_pool is None:
                    self._tel_pool = cf.ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix="ckpt-telemetry")
                pool = self._tel_pool
                self._tel_futs.append(
                    pool.submit(self._write_telemetry, snap, step, events))

    def _write_telemetry(self, snap: _SaveSnapshot, step: int,
                         events: Optional[List[Dict[str, Any]]] = None
                         ) -> None:
        """Single-host telemetry.json next to each committed manifest.
        Only written with observability enabled, so default-off runs keep
        byte-identical checkpoint directories."""
        doc = {"step": int(step), "kind": "save",
               "hosts": {str(self.obs.process): self.obs.telemetry_fragment(
                   since_mark=snap.obs_mark, events=events)}}
        for lv in snap.fired_levels:
            final = os.path.join(lv.directory, f"step_{step}")
            if not os.path.isdir(final):
                continue
            try:
                with open(os.path.join(final, "telemetry.json"), "w") as f:
                    json.dump(doc, f)
            except OSError:
                pass                   # telemetry is best-effort

    def _run_base(self, lv: Level, step: int, snap: _SaveSnapshot,
                  capture: Optional[_ChainState]) -> str:
        try:
            t0 = time.perf_counter()
            with snap.obs_handle.stage("pack", level=lv.directory):
                entries = snap.entries_all()
                if capture is not None:
                    capture.sources = snap.chain_sources()
            snap.stage_max("pack_s", time.perf_counter() - t0)
            producer = None
            order = None
            if snap.use_stream:
                streams, order = snap.build_streams()
                if streams:
                    producer = self._io_pool.submit(run_transfers, streams)
            err: Optional[BaseException] = None
            t1 = time.perf_counter()
            path = None
            with snap.obs_handle.stage("write", level=lv.directory):
                try:
                    path = save_checkpoint(lv.directory, step, None,
                                           shards=lv.shards,
                                           parity=lv.parity,
                                           stream=entries,
                                           submit=self._submit_io(),
                                           order=order, owner=self._owner)
                except BaseException as e:   # noqa: BLE001 - re-raised below
                    err = e
                    snap.abort()         # unblock a producer on full queues
                if producer is not None:
                    try:
                        producer.result()
                    except BaseException as pe:  # noqa: BLE001
                        if err is None:
                            err = pe
                if err is not None:
                    raise err
            snap.stage_max("write_s", time.perf_counter() - t1)
        except BaseException:
            if capture is not None:
                self._drop_chain(lv, capture)
            raise
        self._retain(lv, snap)
        return path

    def _run_delta(self, lv: Level, step: int, snap: _SaveSnapshot,
                   cs: _ChainState, chain: List[int],
                   prev_sources: Dict[str, Any]) -> str:
        try:
            t0 = time.perf_counter()
            with snap.obs_handle.stage("delta", level=lv.directory):
                deltas, moved = snap.build_deltas(prev_sources,
                                                  self.delta_chunk_bytes)
                cs.sources = snap.chain_sources()
            snap.stat_add("d2h_bytes", int(moved))
            self.obs.registry.counter("save.d2h_bytes").inc(int(moved))
            snap.stage_max("delta_s", time.perf_counter() - t0)
            snap.stat_level(lv.directory, "delta_bytes", int(
                sum(_entry_nbytes(d) for d in deltas.values())))
            t1 = time.perf_counter()
            with snap.obs_handle.stage("write", level=lv.directory):
                path = save_delta_checkpoint(lv.directory, step, deltas,
                                             chain, shards=lv.shards,
                                             parity=lv.parity,
                                             submit=self._submit_io(),
                                             owner=self._owner)
            snap.stage_max("write_s", time.perf_counter() - t1)
        except BaseException:
            self._drop_chain(lv, cs)
            raise
        self._retain(lv, snap)
        return path

    def _retain(self, lv: Level, snap: _SaveSnapshot) -> None:
        t0 = time.perf_counter()
        self._gc(lv)
        snap.stage_max("retention_s", time.perf_counter() - t0)

    def _drop_chain(self, lv: Level, cs: _ChainState):
        """A chained write failed on the writer thread: later saves must
        not reference this (possibly unwritten) step, so the chain is
        invalidated and the next save squashes with a fresh base.  Only
        drops the exact state the failed write belonged to — a newer chain
        installed meanwhile is left alone."""
        with self._lock:
            if self._chains.get(lv.directory) is cs:
                del self._chains[lv.directory]

    def _gc(self, lv: Level):
        """Chain-aware retention: keep the newest ``keep_n`` restorable
        steps *plus* every chain predecessor they need; sweep stale
        ``.tmp_step_*`` dirs from crashed writers.  A tmp dir tagged with
        *another* writer's token is swept only when its liveness file went
        stale — a sibling manager's in-flight write survives.  (Writes per
        level are double-buffered, so none of *this* manager's writers are
        active in the directory during its own ``_gc``.)"""
        with self._lock, self.obs.tracer.span("save.retention") as sp:
            try:
                entries = os.listdir(lv.directory)
            except FileNotFoundError:
                return
            for e in entries:
                if tmp_step_of_entry(e) is None:
                    # orphaned coordinated pending dirs (a multi-host run
                    # that died before commit, now resumed single-process)
                    # are reclaimed here too once their liveness goes stale
                    if pending_step_of_entry(e) is not None and \
                            not tmp_writer_alive(lv.directory, e,
                                                 self._writer_ttl_s):
                        shutil.rmtree(os.path.join(lv.directory, e),
                                      ignore_errors=True)
                    continue
                owner = tmp_owner_of_entry(e)
                if (owner is not None and owner != self._owner
                        and tmp_writer_alive(lv.directory, e,
                                             self._writer_ttl_s)):
                    continue           # live foreign writer: not ours to GC
                shutil.rmtree(os.path.join(lv.directory, e),
                              ignore_errors=True)
            sp.set(**sweep_retention(lv.directory, lv.keep_n))

    # --- restore -----------------------------------------------------------

    def latest(self) -> Optional[Tuple[int, str]]:
        """Newest *committed* (step, level dir): a coordinated step whose
        leader died between the directory rename and the commit marker is
        partial and falls through to the newest fully-committed step."""
        best = None
        for lv in self.levels:
            for s in committed_steps(lv.directory):
                if best is None or s > best[0]:
                    best = (s, lv.directory)
        return best

    def _candidates(self) -> List[Tuple[int, str]]:
        """Every committed (step, level dir), newest first — same
        partial-commit tolerance as ``latest``."""
        out = [(s, lv.directory) for lv in self.levels
               for s in committed_steps(lv.directory)]
        return sorted(out, key=lambda x: -x[0])

    def restore(self, state_like, fill=0,
                mode: Optional[str] = None) -> Optional[Tuple[int, Any]]:
        """Newest complete checkpoint across levels → (step, state) with
        fresh tensors on the manager's device; None if nothing to restore.
        Leaves absent from the checkpoint keep their ``state_like`` value
        (listed in ``last_restore_stats["missing_leaves"]``).

        A step that disappears mid-load (``_gc`` racing on a writer thread,
        or a delta chain whose base is gone) is skipped and the next-newest
        complete step is tried.
        """
        mode = self.restore_mode if mode is None else mode
        self._check_mode("restore mode", mode)
        skipped: List[Dict[str, Any]] = []
        tracer = self.obs.tracer
        for step, root in self._candidates():
            io_stats: Dict[str, int] = {}
            with tracer.span("restore.step", step=step):
                try:
                    with tracer.span("restore.read", step=step):
                        step, packed, _ = load_checkpoint_raw(
                            root, step, io_stats=io_stats)
                except (OSError, ValueError, KeyError) as e:
                    skipped.append({"step": step, "root": root,
                                    "error": str(e)})
                    continue
                return self._materialize(state_like, packed, fill, mode,
                                         step, skipped, io_stats)
        if skipped:
            self.last_restore_stats = self.obs.registry.publish(
                "restore", {"skipped": skipped, "step": None})
        return None

    def _materialize(self, state_like, packed, fill, mode, step, skipped,
                     io_stats=None) -> Tuple[int, Any]:
        named, treedef = _tree.flatten_with_names(state_like)
        dev = self.device
        tracer = self.obs.tracer
        h2d = 0
        host_copy = 0
        full = 0
        device_leaves = 0
        mask_words = dict.fromkeys(_WORDS_FROM.values(), 0)
        missing: List[str] = []
        out = []
        for name, leaf in named:
            like_dtype = leaf_dtype_name(leaf)
            shape = tuple(getattr(leaf, "shape", ()))
            n = int(np.prod(shape)) if shape else 1
            full += n * itemsize(like_dtype)
            p = packed.get(name)
            if p is None:               # elastic: grown model, older ckpt
                missing.append(name)
                out.append(from_host(to_host(leaf, copy=True), like_dtype,
                                     dev))
                continue
            stored_n = int(np.prod(p.shape)) if p.shape else 1
            if (mode in ("auto", "device") and not p.region_tiers
                    and p.encoding in ("regions", "bitmap")
                    and stored_n == n):
                payload = np.frombuffer(p.payload, host_dtype(p.dtype))
                host_copy += host_copy_nbytes(payload)
                words = None
                if payload.size:    # no critical element: no mask to send
                    with tracer.span("restore.mask", elements=n,
                                     regions=_region_count(p)):
                        words, sent = _leaf_words(p, n, dev)
                    h2d += sent
                    mask_words[_WORDS_FROM[p.encoding]] += 1
                arr, moved = scatter_sharded_payload(
                    payload, words, shape, p.dtype, dev, fill=fill,
                    tracer=tracer)
                h2d += moved
                device_leaves += 1
            else:                       # host expand (full/tiered leaves)
                with tracer.span("restore.expand", elements=n):
                    a = unpack_leaf(p, fill=fill)
                    host_copy += host_copy_nbytes(a)
                    arr = from_host(a.reshape(shape), p.dtype, dev)
                h2d += a.nbytes
            if p.dtype != like_dtype:
                arr = arr.to(torch_dtype(like_dtype))   # cast on device
            out.append(arr)
        io_stats = io_stats or {}
        parity = int(io_stats.get("parity_bytes", 0))
        read = int(io_stats.get("bytes_read", 0))
        superseded = int(io_stats.get("superseded_bytes", 0))
        walked = {k: int(io_stats.get(k, 0))
                  for k in ("read_into_bytes", "delta_chunks", "delta_runs")}
        self.last_restore_stats = self.obs.registry.publish("restore", {
            "step": step, "mode": mode, "h2d_bytes": int(h2d),
            "full_bytes": int(full), "device_leaves": device_leaves,
            "missing_leaves": missing, "skipped": skipped,
            "bytes_read": read, "superseded_bytes": superseded,
            # the chain walk's reads straight into leaf buffers and its
            # delta runs; the payload bytes ``from_host`` copied on the host
            **walked, "host_copy_bytes": int(host_copy),
            "mask_words": mask_words,
            # bytes served by the XOR parity rebuild vs plain reads
            "level_bytes": {"l3_parity": parity, "l4_store": read - parity},
            "resilience_level": "l3_parity" if parity else "l4_store"})
        reg = self.obs.registry
        reg.counter("restore.h2d_bytes").inc(int(h2d))
        reg.counter("restore.bytes_read").inc(read)
        reg.counter("restore.superseded_bytes").inc(superseded)
        for k, v in walked.items():
            reg.counter(f"restore.{k}").inc(v)
        reg.counter("restore.host_copy_bytes").inc(int(host_copy))
        reg.counter("restore.words_from_regions").inc(
            mask_words["regions_on_card"])
        reg.counter("restore.words_from_bitmap").inc(
            mask_words["bitmap_aux"])
        return step, _tree.unflatten(treedef, out)
