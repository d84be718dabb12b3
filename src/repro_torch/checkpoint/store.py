"""On-disk checkpoint format: sharded, atomic, self-describing, differential.

Layout (one checkpoint):
    <root>/step_<N>/
        manifest.json           # global metadata + per-leaf index
        shard_<k>.bin           # concatenated leaf payloads (round-robin)
        parity_<k>.bin          # XOR(shard_k, shard_{k+1 mod S}) [optional]

Leaves are assigned to shards round-robin by size; the manifest stores
(shard, offset, length) per leaf so any mesh can restore any leaf —
**elastic restore**: arrays are logical/global in the manifest, the loader
re-places them on whatever device the caller names.

Writes go to ``<root>/.tmp_step_<N>`` then ``os.rename`` (atomic on POSIX):
a crash mid-write never corrupts the latest complete checkpoint.  A stale
``.tmp_step_<N>`` left by a crashed writer is cleared before the next write
of the same step — its partial shard/parity files must never leak into a
finished checkpoint.

**Directory sharing**: a managed writer tags its tmp dirs with a per-writer
owner token (``.tmp_step_<N>.<token>``) and keeps a liveness file
(``.alive``, mtime-refreshed as entries land) inside.  Retention sweeps in
*other* writers skip a tokened tmp dir whose liveness file is fresh — two
managers pointed at one directory cannot delete each other's in-flight
step — while legacy untokened dirs and dirs whose owner stopped refreshing
are swept as before.

**Coordinated (multi-host) checkpoints** (``checkpoint/coordinator.py``):
every process writes only the shards it owns (``shard_h<p>_<k>.bin`` + a
per-host manifest, ``write_host_entries``) into a shared pending dir, then
a leader fuses them into one *global* manifest (``fuse_global_manifest``)
whose leaves are ``segmented`` — per leaf, an ordered list of flat element
ranges, each backed by one host's file — renames the dir into place, and
lands a ``commit.json`` marker (``write_commit_marker``).  A coordinated
step without its marker is *not* committed and is invisible to
``latest()``; single-process checkpoints never carry a marker and their
atomic rename remains the commit.  ``load_checkpoint_raw`` reassembles
segmented leaves (and per-segment delta chains) into ordinary
``PackedLeaf``s, so every restore path works unchanged on coordinated
checkpoints; the elastic resharded restore path instead reads only the
byte ranges intersecting its local shards (``ShardReader.read_range``).

Partner XOR parity: any single missing/corrupt shard is reconstructed from
its two neighbours' parity files without touching the global store — the
multi-level manager uses this to survive single-node loss.

**Differential chains**: a checkpoint may be a *delta* against its
predecessor — per leaf, only byte-chunks of the payload that changed since
the previous step are stored (``DeltaLeaf``).  The manifest then carries a
``chain`` section::

    "chain": {"base_step": N, "delta_chain": [N, M1, M2]}

``delta_chain`` lists every predecessor step needed to reconstruct this
one, in apply order (the base first).  Restore walks the chain: the base's
payload bytes are patched with each delta in order, then unpacked exactly
like a base checkpoint.  A manifest without a ``chain`` section is a base.

Reads are **streamed per leaf**: the loader reads each leaf's
(shard, offset, length) range instead of slurping whole shard blobs, so
restoring a single leaf (or applying a sparse delta) reads only the bytes
it needs; a missing shard file falls back to whole-shard XOR
reconstruction.  The chain walk reads each stored byte once: a base entry
straight into a fresh buffer of its leaf, a delta's runs of chunks
straight onto that buffer's bytes, each entry crc-checked there.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import _tree
from repro_torch._tensors import (fill_host, from_host, host_dtype, itemsize,
                                  leaf_dtype_name, resolve_device, to_host,
                                  torch_dtype)
from repro_torch.checkpoint.packing import (DeltaLeaf, PackedLeaf,
                                            delta_runs, pack_leaf,
                                            pack_leaf_from_payload,
                                            unpack_leaf)
from repro_torch.checkpoint.pipeline import BytesSource
from repro_torch.core.criticality import CriticalityReport
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.regions import regions_to_mask


def step_of_entry(name: str) -> Optional[int]:
    """Parse a ``step_<N>`` directory name; None for anything unparsable
    (stray files, ``step_tmp``, in-flight ``.tmp_step_<N>`` dirs...)."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def tmp_step_of_entry(name: str) -> Optional[int]:
    """Parse an in-flight/stale tmp directory name — either the legacy
    ``.tmp_step_<N>`` or the owner-tagged ``.tmp_step_<N>.<token>``."""
    if not name.startswith(".tmp_step_"):
        return None
    try:
        return int(name[len(".tmp_step_"):].split(".", 1)[0])
    except ValueError:
        return None


def tmp_owner_of_entry(name: str) -> Optional[str]:
    """Owner token of a tagged ``.tmp_step_<N>.<token>`` dir; None for the
    legacy untagged form (or anything unparsable)."""
    if tmp_step_of_entry(name) is None:
        return None
    rest = name[len(".tmp_step_"):].split(".", 1)
    return rest[1] if len(rest) == 2 and rest[1] else None


# Liveness file kept inside an owner-tagged tmp dir; its mtime is refreshed
# as entries land, so a sweeping sibling writer can tell an in-flight write
# from a crashed one.
ALIVE_FILE = ".alive"


def tmp_writer_alive(root: str, entry: str, ttl_s: float) -> bool:
    """True when the tmp dir's liveness file was refreshed within
    ``ttl_s`` seconds (``ttl_s <= 0``: any liveness file counts live).
    A dir whose liveness file is missing falls back to the dir's own
    mtime — it covers the instants between ``mkdir`` and the liveness
    file's creation, so a racing sweep can never kill a write it caught
    mid-birth; a genuinely dead dir still ages out after ``ttl_s``."""
    base = os.path.join(root, entry)
    for path in (os.path.join(base, ALIVE_FILE), base):
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            continue
        return ttl_s <= 0 or age < ttl_s
    return False


def pending_step_of_entry(name: str) -> Optional[int]:
    """Parse a coordinated save's shared ``.pending_step_<N>`` dir name."""
    if not name.startswith(".pending_step_"):
        return None
    try:
        return int(name[len(".pending_step_"):])
    except ValueError:
        return None


# Commit marker of a coordinated checkpoint: written by the leader *after*
# the fused step directory is renamed into place.  A coordinated manifest
# without it is a partial commit and must stay invisible.
COMMIT_MARKER = "commit.json"


def write_commit_marker(step_dir: str, info: Dict[str, Any]) -> None:
    """The leader's last write of a coordinated commit, after the fused
    step directory is renamed into place."""
    tmp = os.path.join(step_dir, f".{COMMIT_MARKER}.tmp")
    with open(tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(step_dir, COMMIT_MARKER))


def is_step_committed(root: str, step: int) -> bool:
    """Visibility rule shared by ``latest``/``_candidates``/restore: a step
    is committed when its commit marker exists, or when its manifest is
    readable and *not* coordinated (single-process saves commit via the
    atomic rename and never write a marker).

    The common cases are decided by ``stat`` alone — this runs per step
    on every ``latest()``/``_gc`` — using the writers' file layouts:
    single-process steps always contain ``shard_0.bin``, coordinated ones
    never do but always keep ``manifest.host0.json``.  Only directories
    matching neither layout (hand-forged / foreign) pay the JSON parse.
    """
    d = os.path.join(root, f"step_{step}")
    if os.path.exists(os.path.join(d, COMMIT_MARKER)):
        return True
    if os.path.exists(os.path.join(d, "shard_0.bin")):       # single-proc
        return os.path.exists(os.path.join(d, "manifest.json"))
    if os.path.exists(os.path.join(d, host_manifest_name(0))):
        return False              # coordinated layout, marker missing
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    return "coordinated" not in manifest


def list_steps(root: str) -> List[int]:
    """Steps with an entry under ``root`` (unparsable names skipped)."""
    steps = []
    for d in os.listdir(root):
        s = step_of_entry(d)
        if s is not None:
            steps.append(s)
    return steps


def sweep_retention(root: str, keep_n: int) -> Dict[str, int]:
    """The one committed-step retention policy (single-process manager and
    coordinated leader both call this, so the rules cannot drift): reap
    dead partial commits — an uncommitted step older than the newest
    committed one, i.e. a commit nobody will ever finish — then keep the
    newest ``keep_n`` committed steps plus every chain predecessor they
    reference (``keep_n <= 0`` disables retention).  Tmp/pending-dir
    sweeping stays with the callers (their liveness rules differ).
    Returns what it did: ``steps_listed``, ``manifests_read``,
    ``removed``."""
    done = {"steps_listed": 0, "manifests_read": 0, "removed": 0}
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return done
    committed, uncommitted = [], []
    for e in entries:
        s = step_of_entry(e)
        if s is None:
            continue
        (committed if is_step_committed(root, s) else uncommitted).append(s)
    done["steps_listed"] = len(committed) + len(uncommitted)
    committed.sort()
    for s in uncommitted:
        if committed and s < committed[-1]:
            shutil.rmtree(os.path.join(root, f"step_{s}"),
                          ignore_errors=True)
            done["removed"] += 1
    if keep_n <= 0:
        return done
    keep = committed[-keep_n:]
    needed = set(keep)
    for s in keep:
        try:
            needed.update(chain_steps(read_manifest(root, s)))
        except (OSError, ValueError, KeyError):
            continue               # unreadable manifest: no deps to pin
        done["manifests_read"] += 1
    for s in committed:
        if s not in needed:
            shutil.rmtree(os.path.join(root, f"step_{s}"),
                          ignore_errors=True)
            done["removed"] += 1
    return done


def committed_steps(root: str) -> List[int]:
    """Sorted committed steps under ``root`` — the one visibility scan
    behind every ``latest()``/``_candidates()`` (manager and coordinator),
    so the partial-commit rule cannot drift between them.  A missing root
    is just empty."""
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return []
    return sorted(s for s in (step_of_entry(d) for d in entries)
                  if s is not None and is_step_committed(root, s))


def read_manifest(root: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(root, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def chain_steps(manifest: Dict[str, Any]) -> List[int]:
    """Predecessor steps this checkpoint needs, in apply order (base
    first); empty for a base checkpoint."""
    chain = manifest.get("chain")
    if not chain:
        return []
    return [int(s) for s in chain.get("delta_chain", [])]


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def _packed_entry(p: PackedLeaf) -> Dict[str, Any]:
    return {
        "name": p.name, "shape": list(p.shape), "dtype": p.dtype,
        "encoding": p.encoding,
        "aux": base64.b64encode(p.aux).decode(),
        "num_regions": p.num_regions,
        "checksum": (zlib.crc32(p.payload) if p.checksum is None
                     else p.checksum),
        "tier_dtypes": list(p.tier_dtypes),
        "region_tiers": base64.b64encode(p.region_tiers).decode(),
    }


def _delta_entry(d: DeltaLeaf) -> Dict[str, Any]:
    return {
        "name": d.name, "shape": list(d.shape), "dtype": d.dtype,
        "encoding": "delta",
        "chunk_bytes": d.chunk_bytes,
        "total_bytes": d.total_bytes,
        "aux": base64.b64encode(
            np.asarray(d.idx, np.int32).tobytes()).decode(),
        "num_chunks": int(np.asarray(d.idx).size),
        "checksum": d.checksum,
    }


@dataclasses.dataclass
class StreamLeaf:
    """A manifest entry whose payload bytes are *streamed* to the writer.

    ``leaf`` carries the manifest metadata (``packing.packed_leaf_stub`` —
    payload empty, checksum 0); ``source`` yields the payload's byte chunks
    in order (``pipeline.ByteSource``), ``length`` is known upfront so the
    shard layout is computed before a single byte arrives.  The writer
    CRCs chunks incrementally and finalizes the manifest entry — on-disk
    bytes are identical to a buffered ``PackedLeaf`` write.
    """
    leaf: PackedLeaf
    length: int
    source: Any


def _assign_shards(lengths: List[int], shards: int):
    """Greedy round-robin layout (identical to the original buffered
    writer): entries by descending size onto the currently-smallest shard;
    offsets follow entry-index order within each shard."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    shard_of = {}
    shard_sizes = [0] * shards
    for i in order:
        k = int(np.argmin(shard_sizes))
        shard_of[i] = k
        shard_sizes[k] += lengths[i]
    offsets = [0] * len(lengths)
    cursor = [0] * shards
    for i, n in enumerate(lengths):
        k = shard_of[i]
        offsets[i] = cursor[k]
        cursor[k] += n
    return shard_of, offsets, shard_sizes


def _pwrite_all(fd: int, buf, off: int) -> None:
    mv = memoryview(buf)
    if mv.format != "B":
        mv = mv.cast("B")
    while mv.nbytes:
        n = os.pwrite(fd, mv, off)
        off += n
        mv = mv[n:]


_PARITY_CHUNK = 4 << 20


def _write_parity(tmp: str, shards: int, sizes: List[int]) -> None:
    """Partner-XOR parity, streamed from the written shard files in fixed
    chunks (byte-identical to XOR-ing whole buffers with zero padding)."""
    for k in range(shards):
        a_path = os.path.join(tmp, f"shard_{k}.bin")
        b_path = os.path.join(tmp, f"shard_{(k + 1) % shards}.bin")
        n = max(sizes[k], sizes[(k + 1) % shards])
        with open(a_path, "rb") as fa, open(b_path, "rb") as fb, \
                open(os.path.join(tmp, f"parity_{k}.bin"), "wb") as out:
            done = 0
            while done < n:
                m = min(_PARITY_CHUNK, n - done)
                pa = np.frombuffer(fa.read(m).ljust(m, b"\0"), np.uint8)
                pb = np.frombuffer(fb.read(m).ljust(m, b"\0"), np.uint8)
                out.write((pa ^ pb).tobytes())
                done += m


def _stream_to_files(dirpath: str,
                     items: List[Tuple[Dict[str, Any], int, Any]],
                     shards: int, prefix: str = "shard_",
                     submit=None, order: Optional[List[int]] = None,
                     touch: Optional[str] = None):
    """Core shard-file streamer shared by the single-process writer and the
    coordinated per-host writer: stream (meta, length, source) entries into
    ``<prefix><k>.bin`` files with incremental CRC, every chunk
    ``pwrite``-placed at its final offset.  Returns the finalized index
    entries (meta + shard/offset/length/checksum, ``file`` recorded for
    non-default prefixes) and the per-shard sizes.

    ``submit``: optional executor submit for overlapped per-shard writes —
    used only when every source is re-consumable (``ready``); single-pass
    queue-fed sources are drained serially in ``order`` (the transfer
    producer's feed order) to stay deadlock-free under bounded queues.
    ``touch``: optional liveness file path whose mtime is refreshed as
    entries land (sibling-writer sweeps use it to spot in-flight writes).
    """
    lengths = [int(n) for _, n, _ in items]
    shard_of, offsets, shard_sizes = _assign_shards(lengths, shards)
    crcs = [0] * len(items)

    fds = [os.open(os.path.join(dirpath, f"{prefix}{k}.bin"),
                   os.O_CREAT | os.O_WRONLY, 0o666) for k in range(shards)]
    try:
        for k, fd in enumerate(fds):
            os.ftruncate(fd, shard_sizes[k])

        # liveness refresh is rate-limited per *chunk*, not per entry: a
        # single huge leaf streaming for longer than the sweep TTL must
        # keep looking alive to sibling managers
        last_touch = [time.time()]

        def refresh_alive() -> None:
            if touch is None:
                return
            now = time.time()
            if now - last_touch[0] < 5.0:
                return
            last_touch[0] = now
            try:
                os.utime(touch)
            except OSError:
                pass

        def write_entry(i: int) -> None:
            fd = fds[shard_of[i]]
            off = offsets[i]
            crc = 0
            for chunk in items[i][2].chunks():
                _pwrite_all(fd, chunk, off)
                nb = memoryview(chunk).nbytes
                crc = zlib.crc32(chunk, crc)
                off += nb
                refresh_alive()
            if off - offsets[i] != lengths[i]:
                raise IOError(
                    f"stream for leaf {items[i][0].get('name')} produced "
                    f"{off - offsets[i]} bytes; manifest says {lengths[i]}")
            crcs[i] = crc
            refresh_alive()

        all_ready = all(getattr(s, "ready", True) for _, _, s in items)
        if submit is not None and all_ready and shards > 1:
            by_shard: Dict[int, List[int]] = {}
            for i in range(len(items)):
                by_shard.setdefault(shard_of[i], []).append(i)

            def run(idxs):
                for i in idxs:
                    write_entry(i)

            futs = [submit(run, idxs) for idxs in by_shard.values()]
            errs = []
            for f in futs:
                try:
                    f.result()
                except Exception as e:      # noqa: BLE001 - re-raised below
                    errs.append(e)
            if errs:
                raise errs[0]
        else:
            for i in (order if order is not None else range(len(items))):
                write_entry(i)
    finally:
        for fd in fds:
            os.close(fd)

    index = []
    for i, (meta, _, _) in enumerate(items):
        meta = dict(meta)
        meta["checksum"] = crcs[i]
        meta.update(shard=shard_of[i], offset=offsets[i], length=lengths[i])
        if prefix != "shard_":
            meta["file"] = f"{prefix}{shard_of[i]}.bin"
        index.append(meta)
    return index, shard_sizes


def _write_stream(root: str, step: int,
                  items: List[Tuple[Dict[str, Any], int, Any]],
                  shards: int, parity: bool,
                  manifest_extra: Optional[Dict[str, Any]] = None,
                  submit=None, order: Optional[List[int]] = None,
                  owner: Optional[str] = None) -> str:
    """Stage-3 writer of the save pipeline: stream (meta, length, source)
    entries into per-shard files with incremental CRC, then parity,
    manifest, and the atomic rename.  Lengths are known upfront, so the
    shard layout (identical to the original buffered writer) is fixed
    before the first chunk arrives and every chunk is ``pwrite``-placed at
    its final offset — no full-payload host materialization.

    ``owner``: a managed writer's token — the tmp dir becomes
    ``.tmp_step_<N>.<owner>`` and carries a liveness file so sibling
    writers sharing the directory never sweep this in-flight write.

    A crash/exception mid-write leaves the tmp dir behind (never the final
    dir); the next write of the same step clears it and the manager's
    retention sweep collects orphans.
    """
    suffix = f".{owner}" if owner else ""
    tmp = os.path.join(root, f".tmp_step_{step}{suffix}")
    final = os.path.join(root, f"step_{step}")
    if os.path.exists(tmp):            # crashed writer leftovers: never merge
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    alive = None
    if owner:
        alive = os.path.join(tmp, ALIVE_FILE)
        with open(alive, "w"):
            pass

    index, shard_sizes = _stream_to_files(tmp, items, shards,
                                          submit=submit, order=order,
                                          touch=alive)
    if parity and shards > 1:
        _write_parity(tmp, shards, shard_sizes)

    manifest = {"step": step, "shards": shards, "parity": parity,
                "leaves": index,
                "payload_bytes": int(sum(shard_sizes))}
    if manifest_extra:
        manifest.update(manifest_extra)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if alive is not None:
        # removed only *after* the rename: a sibling sweep that catches
        # the dir between liveness removal and rename would otherwise
        # rmtree a fully-written checkpoint.  (A crash in this window
        # leaves a harmless dotfile behind.)
        try:
            os.unlink(os.path.join(final, ALIVE_FILE))
        except OSError:
            pass
    return final


def _as_stream_item(e) -> Tuple[Dict[str, Any], int, Any]:
    """Normalize a write entry — ``PackedLeaf`` / ``DeltaLeaf`` (buffered
    bytes) or ``StreamLeaf`` (chunk stream) — to (meta, length, source)."""
    if isinstance(e, StreamLeaf):
        return _packed_entry(e.leaf), int(e.length), e.source
    if isinstance(e, DeltaLeaf):
        payload = bytes(e.payload)
        return _delta_entry(e), len(payload), BytesSource(payload)
    payload = bytes(e.payload)
    return _packed_entry(e), len(payload), BytesSource(payload)


def _write_entries(root: str, step: int,
                   entries: List[Tuple[Dict[str, Any], bytes]],
                   shards: int, parity: bool,
                   manifest_extra: Optional[Dict[str, Any]] = None,
                   owner: Optional[str] = None) -> str:
    """Buffered-entry writer, now a thin wrapper over the streaming one:
    identical bytes by construction (single write path)."""
    items = [(meta, len(payload), BytesSource(bytes(payload)))
             for meta, payload in entries]
    return _write_stream(root, step, items, shards, parity,
                         manifest_extra=manifest_extra, owner=owner)


def host_manifest_name(host: int) -> str:
    """Per-host manifest of a coordinated (multi-host) checkpoint; its
    presence marks the coordinated layout for ``is_step_committed``."""
    return f"manifest.host{int(host)}.json"


def host_shard_prefix(host: int) -> str:
    return f"shard_h{int(host)}_"


def write_host_entries(pending_dir: str, host: int, entries: List[Any],
                       shards: int = 1,
                       extra: Optional[Dict[str, Any]] = None,
                       prefix: Optional[str] = None,
                       submit: Optional[Any] = None,
                       order: Optional[Sequence[int]] = None) -> str:
    """Phase 1 of the coordinated commit: write one host's owned entries
    into the shared pending dir.

    Shard files are namespaced per host (``shard_h<p>_<k>.bin``) so hosts
    never contend on a file, and the per-host manifest is written last via
    rename — its presence means this host's bytes are durably complete.
    ``entries``: ready ``(meta, length, source)`` stream items or
    ``PackedLeaf``/``DeltaLeaf``/``StreamLeaf`` values; metas carry the
    segment's flat element range (``start``/``stop``) and the leaf's
    *global* shape.  ``prefix`` overrides the shard-file prefix (the
    degraded-save recovery writes a dead host's entries under a distinct
    prefix, so a stalled-but-alive original writer can never race the
    recovered bytes).  ``submit``/``order`` thread through to the stream
    writer (overlapped per-shard writes / serial consumption order).
    """
    items = [e if isinstance(e, tuple) else _as_stream_item(e)
             for e in entries]
    # shared liveness file (any host's refresh counts): a sweeping leader
    # must see a long-streaming phase 1 as alive
    alive = os.path.join(pending_dir, ALIVE_FILE)
    with open(alive, "w"):
        pass
    index, shard_sizes = _stream_to_files(
        pending_dir, items, shards,
        prefix=prefix if prefix is not None else host_shard_prefix(host),
        submit=submit, order=order, touch=alive)
    manifest = {"host": int(host), "shards": int(shards),
                "payload_bytes": int(sum(shard_sizes)), "leaves": index}
    if extra:
        manifest.update(extra)
    final = os.path.join(pending_dir, host_manifest_name(host))
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    return final


def fuse_global_manifest(pending_dir: str, step: int, process_count: int,
                         manifest_extra: Optional[Dict[str, Any]] = None,
                         host_manifests: Optional[Dict[int, Dict[str, Any]]]
                         = None) -> Dict[str, Any]:
    """Phase 2 (leader): fuse the per-host manifests into one *global*
    manifest describing every leaf as an ordered list of segments.

    Validates that all ``process_count`` hosts landed and that each leaf's
    segments tile its flat range exactly once; raises on gaps/overlaps so
    a mis-partitioned save can never commit.  The fused manifest is
    written atomically as ``manifest.json`` inside the pending dir.
    ``host_manifests``: already-parsed per-host manifests; missing hosts
    are read from disk."""
    hosts = dict(host_manifests or {})
    for p in range(process_count):
        if p in hosts:
            continue
        path = os.path.join(pending_dir, host_manifest_name(p))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"coordinated step {step}: host {p} manifest missing")
        with open(path) as f:
            hosts[p] = json.load(f)

    by_name: Dict[str, List[Dict[str, Any]]] = {}
    info: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for p in sorted(hosts):
        for e in hosts[p]["leaves"]:
            name = e["name"]
            if name not in by_name:
                by_name[name] = []
                order.append(name)
            by_name[name].append(dict(e, host=p))
            info.setdefault(name, {"shape": e["shape"],
                                   "dtype": e["dtype"]})

    leaves = []
    payload_bytes = 0
    full_bytes = 0
    for name in order:
        segs = sorted(by_name[name], key=lambda e: int(e["start"]))
        shape = info[name]["shape"]
        n = int(np.prod(shape or [1]))
        cursor = 0
        for s in segs:
            if int(s["start"]) != cursor:
                raise ValueError(
                    f"coordinated step {step}: leaf {name} segments have a "
                    f"gap/overlap at element {cursor} (next segment starts "
                    f"at {s['start']})")
            cursor = int(s["stop"])
            payload_bytes += int(s["length"])
        if cursor != n:
            raise ValueError(
                f"coordinated step {step}: leaf {name} segments cover "
                f"[0, {cursor}) of {n} elements")
        full_bytes += n * itemsize(info[name]["dtype"])
        seg_entries = [{k: v for k, v in s.items() if k != "shape"}
                       for s in segs]
        leaves.append({"name": name, "shape": list(shape),
                       "dtype": info[name]["dtype"],
                       "encoding": "segmented", "segments": seg_entries})

    manifest = {"step": int(step), "shards": 0, "parity": False,
                "coordinated": {"process_count": int(process_count),
                                "format": "coordinated-v1"},
                "leaves": leaves,
                "payload_bytes": int(payload_bytes),
                "full_bytes": int(full_bytes)}
    if manifest_extra:
        manifest.update(manifest_extra)
    tmp = os.path.join(pending_dir, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(pending_dir, "manifest.json"))
    return manifest


def save_checkpoint(root: str, step: int, state: Any,
                    report: Optional[CriticalityReport] = None,
                    precision: Optional[PrecisionPolicy] = None,
                    shards: int = 1, parity: bool = False,
                    prepacked: Optional[Dict[str, PackedLeaf]] = None,
                    stream: Optional[List[Any]] = None,
                    submit=None, order: Optional[List[int]] = None,
                    owner: Optional[str] = None) -> str:
    """Write ``state`` (pytree) at ``step``; if ``report`` is given, only
    critical elements are stored (the paper's reduced checkpoint).

    ``prepacked`` maps leaf name → ready ``PackedLeaf`` (the device-resident
    save path builds these from device-gathered payloads); those leaves are
    written as-is and their state entries are never touched — no D2H copy
    happens here for them.

    ``stream`` (the pipelined save engine): an ordered list of
    ``PackedLeaf`` / ``StreamLeaf`` manifest entries replacing ``state``
    entirely — payloads are streamed to the shard files as their chunks
    arrive (``submit``/``order`` are forwarded to the stream writer).  The
    on-disk result is byte-identical to the buffered path.
    """
    if stream is not None:
        items = [_as_stream_item(e) for e in stream]
        full_bytes = int(sum(
            int(np.prod(m["shape"] or [1])) * itemsize(m["dtype"])
            for m, _, _ in items))
        return _write_stream(root, step, items, shards, parity,
                             manifest_extra={"full_bytes": full_bytes},
                             submit=submit, order=order, owner=owner)
    named, _ = _tree.flatten_with_names(state)
    packed: List[PackedLeaf] = []
    for name, leaf in named:
        if prepacked is not None and name in prepacked:
            packed.append(prepacked[name])
            continue
        arr = to_host(leaf)
        mask = mag = None
        if report is not None and name in report.leaves:
            rep = report[name]
            mask = rep.mask
            # magnitudes only feed precision tiers; skipping the access
            # keeps a DeviceReport's lazy magnitude D2H from triggering
            # (possibly on a writer thread) when tiering is off
            if precision is not None and getattr(precision, "enabled", True):
                mag = rep.magnitude
        packed.append(pack_leaf(name, arr, mask, mag, precision,
                                dtype=leaf_dtype_name(leaf)))

    full_bytes = int(sum(
        int(np.prod(p.shape or (1,))) * itemsize(p.dtype)
        for p in packed))
    entries = [(_packed_entry(p), bytes(p.payload)) for p in packed]
    return _write_entries(root, step, entries, shards, parity,
                          manifest_extra={"full_bytes": full_bytes},
                          owner=owner)


def save_delta_checkpoint(root: str, step: int,
                          deltas: Dict[str, Union[DeltaLeaf, PackedLeaf]],
                          chain: List[int],
                          shards: int = 1, parity: bool = False,
                          submit=None, owner: Optional[str] = None) -> str:
    """Write a differential checkpoint: per leaf either a ``DeltaLeaf``
    patch against the predecessor step's payload, a full ``PackedLeaf``
    replacement, or a ``StreamLeaf`` (a full replacement whose payload
    streams in chunks).  ``chain`` lists the predecessor steps in apply
    order (base first); every one must be retained until this step is
    collected.
    """
    if not chain:
        raise ValueError("delta checkpoint needs a non-empty chain")
    items = [_as_stream_item(d) for d in deltas.values()]
    extra = {"chain": {"base_step": int(chain[0]),
                       "delta_chain": [int(s) for s in chain]}}
    return _write_stream(root, step, items, shards, parity,
                         manifest_extra=extra, submit=submit, owner=owner)


# --------------------------------------------------------------------------
# Streaming reads
# --------------------------------------------------------------------------

# buffers a single preadv takes (Linux's IOV_MAX)
_IOV_MAX = 1024


def _pread_full(fd: int, length: int, offset: int) -> bytes:
    """``length`` bytes at ``offset``; fewer where the file ends first."""
    parts = []
    while length:
        b = os.pread(fd, length, offset)
        if not b:
            break
        parts.append(b)
        length -= len(b)
        offset += len(b)
    return b"".join(parts)


def _preadv_full(fd: int, views: Sequence[memoryview],
                 offset: int) -> bool:
    """Fill ``views`` in order from the file's bytes at ``offset``, a
    ``preadv`` per ``_IOV_MAX`` of them; False where the file ends
    first."""
    views = [v for v in views if len(v)]
    i = 0
    while i < len(views):
        got = os.preadv(fd, views[i:i + _IOV_MAX], offset)
        if got == 0:
            return False
        offset += got
        while got:                      # step past what this call filled
            n = len(views[i])
            if got < n:
                views[i] = views[i][got:]
                break
            got -= n
            i += 1
    return True


class ShardReader:
    """Per-leaf streaming reads over one checkpoint directory: positioned
    reads into shard files instead of slurping whole blobs; a missing or
    short numbered shard falls back to whole-shard partner-XOR
    reconstruction (cached).

    Entries carrying a ``file`` key (a coordinated checkpoint's per-host
    shard files) read from that file directly — no parity exists for them.
    ``read_range`` reads a byte sub-range *within* an entry's payload: the
    elastic resharded restore path uses it to fetch only the bytes
    intersecting its local shards.  ``read_into`` reads an entry straight
    into the caller's buffers: the chain walk's way of reading each stored
    byte once.
    """

    def __init__(self, d: str, shards: int):
        self.d = d
        self.shards = shards
        self._fds: Dict[str, int] = {}
        self._rebuilt: Dict[int, bytes] = {}
        # I/O accounting for the resilience-level report: bytes served
        # (total), the subset served from XOR-rebuilt shards (the L3
        # parity level), the raw disk bytes the rebuilds cost, and the
        # bytes read from a shard file straight into a caller's buffer
        self.stats: Dict[str, int] = {"bytes_read": 0, "parity_bytes": 0,
                                      "parity_rebuild_bytes": 0,
                                      "read_into_bytes": 0}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def _rebuild(self, k: int) -> bytes:
        if k not in self._rebuilt:
            par = os.path.join(self.d, f"parity_{k}.bin")
            nxt = os.path.join(self.d, f"shard_{(k + 1) % self.shards}.bin")
            if not (os.path.exists(par) and os.path.exists(nxt)):
                raise FileNotFoundError(
                    f"shard {k} missing and not reconstructable in {self.d}")
            with open(par, "rb") as f:
                p = np.frombuffer(f.read(), np.uint8)
            with open(nxt, "rb") as f:
                b = f.read()
            pb = np.frombuffer(b.ljust(len(p), b"\0"), np.uint8)
            self._rebuilt[k] = (p ^ pb).tobytes()
            self.stats["parity_rebuild_bytes"] += len(p) + len(b)
        return self._rebuilt[k]

    def _source(self, entry: Dict[str, Any]
                ) -> Tuple[Optional[int], Optional[bytes]]:
        """Where an entry's bytes come from: ``(fd, None)``, its shard
        file, or ``(None, blob)``, its numbered shard rebuilt from
        parity."""
        fname = entry.get("file")
        if fname is None:
            k = int(entry["shard"])
            if k in self._rebuilt:
                return None, self._rebuilt[k]
            fname = f"shard_{k}.bin"
        if fname not in self._fds:
            path = os.path.join(self.d, fname)
            if not os.path.exists(path):
                return None, self._torn(entry, "missing")
            self._fds[fname] = os.open(path, os.O_RDONLY)
        return self._fds[fname], None

    def _torn(self, entry: Dict[str, Any], how: str) -> bytes:
        """The rebuilt blob of a numbered entry whose shard file is
        ``how`` (missing or truncated); a coordinated entry's file has no
        parity, and raises."""
        fname = entry.get("file")
        if fname is None:
            return self._rebuild(int(entry["shard"]))
        if how == "missing":
            raise FileNotFoundError(
                f"shard file {fname} missing in {self.d}")
        raise IOError(f"shard file {fname} truncated in {self.d}")

    def _served_by_parity(self, length: int) -> None:
        self.stats["bytes_read"] += length
        self.stats["parity_bytes"] += length

    def read_range(self, entry: Dict[str, Any], start: int,
                   length: int) -> bytes:
        """Bytes ``[start, start + length)`` of one entry's payload."""
        base = int(entry["offset"])
        total = int(entry["length"])
        if not 0 <= start <= start + length <= total:
            raise ValueError(
                f"range [{start}, {start + length}) outside entry of "
                f"{total} bytes for leaf {entry.get('name')}")
        fd, blob = self._source(entry)
        if fd is not None:
            data = _pread_full(fd, length, base + start)
            if len(data) == length:
                self.stats["bytes_read"] += length
                return data
            blob = self._torn(entry, "truncated")
        self._served_by_parity(length)
        return blob[base + start:base + start + length]

    def read_into(self, entry: Dict[str, Any],
                  views: Sequence[memoryview]) -> None:
        """Fill ``views``, writable buffers whose lengths add up to the
        entry's, with its payload in order: from the shard file straight
        into them (``preadv``), or copied from a shard rebuilt from
        parity."""
        base = int(entry["offset"])
        total = int(entry["length"])
        if sum(len(v) for v in views) != total:
            raise ValueError(
                f"buffers of {sum(len(v) for v in views)} bytes for an "
                f"entry of {total} bytes for leaf {entry.get('name')}")
        fd, blob = self._source(entry)
        if fd is not None:
            if _preadv_full(fd, views, base):
                self.stats["bytes_read"] += total
                self.stats["read_into_bytes"] += total
                return
            blob = self._torn(entry, "truncated")
        src = memoryview(blob)
        off = base
        for v in views:
            v[:] = src[off:off + len(v)]
            off += len(v)
        self._served_by_parity(total)


def _read_shard(d: str, k: int, shards: int) -> bytes:
    """Whole-shard read with partner-XOR fallback (for callers that want
    the full blob; the loader itself streams per leaf)."""
    r = ShardReader(d, shards)
    try:
        path = os.path.join(d, f"shard_{k}.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
        return r._rebuild(k)
    finally:
        r.close()


# --------------------------------------------------------------------------
# Loading
# --------------------------------------------------------------------------

def _entry_to_packed(e: Dict[str, Any], payload,
                     checksum: Optional[int]) -> PackedLeaf:
    return PackedLeaf(
        name=e["name"], shape=tuple(e["shape"]), dtype=e["dtype"],
        encoding=e["encoding"], aux=base64.b64decode(e["aux"]),
        num_regions=e.get("num_regions", 1), payload=payload,
        checksum=checksum,
        tier_dtypes=tuple(e.get("tier_dtypes", ())),
        region_tiers=base64.b64decode(e.get("region_tiers", "")))


def segment_mask(entry: Dict[str, Any], seg_n: int) -> Optional[np.ndarray]:
    """Flat bool mask of one (segment or whole-leaf) entry's critical
    elements over its ``seg_n`` elements; None for ``full`` entries."""
    enc = entry["encoding"]
    if enc == "full":
        return None
    aux = base64.b64decode(entry["aux"])
    if enc == "regions":
        regions = np.frombuffer(aux, np.int64).reshape(-1, 2)
        return regions_to_mask(regions, seg_n)
    if enc == "bitmap":
        return np.unpackbits(
            np.frombuffer(aux, np.uint8))[:seg_n].astype(bool)
    raise ValueError(f"entry for leaf {entry.get('name')} has "
                     f"non-base encoding {enc!r}")


@dataclasses.dataclass
class _ChainWalk:
    """The chain walk's state: each leaf's (or coordinated segment's)
    buffer, keyed ``(name,)`` or ``(name, start, stop)``; the base entry
    it was read from; the keys a delta patched; and what the walk
    counted."""
    payloads: Dict[Tuple, bytearray] = dataclasses.field(
        default_factory=dict)
    meta: Dict[Tuple, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    patched: set = dataclasses.field(default_factory=set)
    superseded_bytes: int = 0
    delta_chunks: int = 0
    delta_runs: int = 0

    def read(self, reader: ShardReader, key: Tuple, e: Dict[str, Any],
             s: int) -> None:
        """Read one manifest entry of step ``s`` into the walk, each of
        its bytes once: a base entry straight into a fresh buffer, which
        replaces the leaf's; a delta's runs of chunks straight onto the
        bytes they patch.  The entry is crc-checked where it landed.
        Counts the bytes of the walk's earlier reads that the entry writes
        over (a delta's patch, every byte of which lands on a byte read
        before; a payload replaced whole)."""
        where = (f"leaf {e['name']} segment [{key[1]}, {key[2]})"
                 if len(key) == 3 else f"leaf {e['name']}")
        if e["encoding"] == "delta":
            buf = self.payloads.get(key)
            if buf is None:
                raise IOError(f"delta for {where} at step {s} has no base "
                              f"payload in the chain")
            if len(buf) != int(e["total_bytes"]):
                raise IOError(
                    f"delta for {where} at step {s} patches "
                    f"{e['total_bytes']} bytes; base has {len(buf)}")
            idx = np.frombuffer(base64.b64decode(e["aux"]), np.int32)
            starts, ends = delta_runs(idx, int(e["chunk_bytes"]), len(buf))
            n = int((ends - starts).sum())
            if n != int(e["length"]):
                raise IOError(f"delta patch length mismatch for {where} at "
                              f"step {s} ({n} vs {e['length']})")
            whole = memoryview(buf)
            views = [whole[a:b] for a, b in zip(starts.tolist(),
                                                ends.tolist())]
            self.patched.add(key)
            self.delta_chunks += idx.size
            self.delta_runs += len(views)
            self.superseded_bytes += n
        else:
            buf = bytearray(int(e["length"]))
            views = [memoryview(buf)]
            old = self.payloads.get(key)
            self.superseded_bytes += 0 if old is None else len(old)
            self.payloads[key] = buf
            self.meta[key] = e
            self.patched.discard(key)
        reader.read_into(e, views)
        crc = 0
        for v in views:
            crc = zlib.crc32(v, crc)
        if crc != e["checksum"]:
            raise IOError(f"checksum mismatch for {where} at step {s}")


def _merge_segments(name: str, shape, dtype: str,
                    segs: List[Tuple[Dict[str, Any], bytearray]]
                    ) -> PackedLeaf:
    """Reassemble a segmented leaf's per-host pieces into one ordinary
    ``PackedLeaf``: payloads concatenate in segment order (segments tile
    the flat range in order, so this *is* the global critical payload) and
    per-segment masks are placed at their element offsets."""
    n = int(np.prod(shape or [1]))
    segs = sorted(segs, key=lambda se: int(se[0]["start"]))
    if all(e["encoding"] == "full" for e, _ in segs):
        mask = None
    else:
        mask = np.zeros(n, bool)
        for e, _ in segs:
            lo, hi = int(e["start"]), int(e["stop"])
            sm = segment_mask(e, hi - lo)
            mask[lo:hi] = True if sm is None else sm
    payload = b"".join(buf for _, buf in segs)
    return pack_leaf_from_payload(
        name, tuple(shape), dtype, mask,
        np.frombuffer(payload, host_dtype(dtype)))


def load_checkpoint_raw(root: str, step: Optional[int] = None,
                        io_stats: Optional[Dict[str, int]] = None
                        ) -> Tuple[int, Dict[str, PackedLeaf],
                                   Dict[str, Any]]:
    """Resolve ``step`` (latest when None), walk its delta chain, and return
    ``(step, {leaf name → PackedLeaf}, manifest)`` with fully reconstructed
    payloads — no unpacking/expansion happens here, so callers can move only
    the critical payload to device (the device-resident restore path).

    Coordinated checkpoints are transparent: each ``segmented`` leaf's
    per-host pieces (and per-segment delta chains) are reassembled into an
    ordinary ``PackedLeaf``, so single-process restore of a multi-host save
    needs no special casing.

    Each stored byte is read once, into the buffer the leaf's payload is
    (a writable ``bytearray``, fresh each call), so the caller moves it
    on without a host copy.  A payload a delta patched carries
    ``checksum`` None: no stored crc covers it.

    Integrity: every full payload and every delta patch is crc-checked as
    read, before the walk returns; the reconstructed payload is a pure
    function of verified bytes.

    ``io_stats``: optional dict accumulating the readers' I/O accounting
    (``bytes_read`` / ``parity_bytes`` / ``parity_rebuild_bytes`` /
    ``read_into_bytes``, the bytes read from a shard file straight into a
    leaf's buffer) — the resilience-level report uses it to attribute
    restore bytes to the L3 parity level vs plain L4 store reads — and
    ``superseded_bytes``: the bytes read that a later entry of the same
    walk wrote over (a delta patch, a payload replaced), read for nothing;
    ``delta_chunks`` and ``delta_runs``: the chunks the deltas patched and
    the runs of consecutive chunks they were read as.
    """
    if step is None:
        # same visibility rule as latest(): an uncommitted coordinated
        # step (leader died mid-commit) is not "the checkpoint" — the
        # next leader GC will reap it
        steps = committed_steps(root)
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
        step = max(steps)
    manifest = read_manifest(root, step)
    todo = chain_steps(manifest) + [step]

    walk = _ChainWalk()
    leafinfo: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for s in todo:
        m = manifest if s == step else read_manifest(root, s)
        d = os.path.join(root, f"step_{s}")
        reader = ShardReader(d, int(m["shards"]))
        try:
            for e in m["leaves"]:
                name = e["name"]
                if name not in leafinfo:
                    order.append(name)
                    leafinfo[name] = {"shape": e["shape"],
                                      "dtype": e["dtype"]}
                if e.get("encoding") == "segmented":
                    for seg in e["segments"]:
                        key = (name, int(seg["start"]), int(seg["stop"]))
                        walk.read(reader, key, dict(seg, name=name), s)
                    continue
                walk.read(reader, (name,), e, s)
        finally:
            if io_stats is not None:
                for k, v in reader.stats.items():
                    io_stats[k] = io_stats.get(k, 0) + v
            reader.close()

    if io_stats is not None:
        for k in ("superseded_bytes", "delta_chunks", "delta_runs"):
            io_stats[k] = io_stats.get(k, 0) + getattr(walk, k)
    by_name: Dict[str, List[Tuple[Tuple, Dict[str, Any], bytearray]]] = {}
    for key, buf in walk.payloads.items():
        by_name.setdefault(key[0], []).append((key, walk.meta[key], buf))

    out = {}
    for name in order:
        pieces = by_name.get(name)
        if pieces is None:
            continue
        if len(pieces) == 1 and len(pieces[0][0]) == 1:   # plain whole leaf
            key, e, buf = pieces[0]
            # the walk's buffer itself, writable: ``from_host`` moves it
            # without a host copy
            out[name] = _entry_to_packed(
                e, buf, None if key in walk.patched else e["checksum"])
        else:
            out[name] = _merge_segments(
                name, leafinfo[name]["shape"], leafinfo[name]["dtype"],
                [(m, b) for _, m, b in pieces])
    return step, out, manifest


def load_checkpoint(root: str, step: Optional[int] = None,
                    fill=0) -> Tuple[int, Dict[str, np.ndarray]]:
    """Returns (step, {leaf name → global np array}).  Uncritical positions
    get ``fill`` (the paper's restart protocol tolerates any value).
    Delta chains are reconstructed transparently."""
    step, packed, _ = load_checkpoint_raw(root, step)
    return step, {name: unpack_leaf(p, fill=fill)
                  for name, p in packed.items()}


def restore_state(state_like: Any, leaves: Dict[str, np.ndarray],
                  device=None, *, missing: str = "like", fill=0,
                  missing_out: Optional[List[str]] = None) -> Any:
    """Elastic restore: place loaded global arrays into a pytree shaped like
    ``state_like`` as tensors on ``device`` (the card unless ``"cpu"`` is
    asked for), each cast to its ``state_like`` leaf's dtype.

    Leaves of ``state_like`` absent from the checkpoint (grown models
    restoring from older checkpoints) are handled per ``missing``:
    ``"like"`` keeps the ``state_like`` value, ``"fill"`` fill-initializes,
    ``"error"`` raises KeyError.  Names of such leaves are appended to
    ``missing_out`` when given.

    ``leaves`` hold host arrays as :func:`load_checkpoint` returns them;
    a bf16 leaf's array holds its bits (uint16).
    """
    if missing not in ("like", "fill", "error"):
        raise ValueError(f"unknown missing policy {missing!r}")
    dev = resolve_device(device)
    named, treedef = _tree.flatten_with_names(state_like)
    out = []
    for name, leaf in named:
        like_name = leaf_dtype_name(leaf)
        shape = tuple(getattr(leaf, "shape", ()))
        if name in leaves:
            arr = np.asarray(leaves[name])
            src_name = "bfloat16" if arr.dtype == np.uint16 and \
                like_name == "bfloat16" else str(arr.dtype)
            t = from_host(arr.reshape(shape), src_name, dev)
        elif missing == "error":
            raise KeyError(name)
        else:
            if missing_out is not None:
                missing_out.append(name)
            if missing == "fill":
                t = from_host(np.full(shape, fill_host(fill, like_name),
                                      host_dtype(like_name)), like_name, dev)
            else:
                t = from_host(to_host(leaf), like_name, dev)
        out.append(t.to(torch_dtype(like_name)))
    return _tree.unflatten(treedef, out)
