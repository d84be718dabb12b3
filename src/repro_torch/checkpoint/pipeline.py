"""Streaming primitives for the pipelined asynchronous save engine.

The save path is a three-stage pipeline (manager.py orchestrates it):

    stage 1 (device)   batched pack  — one compiled call per (device, dtype)
                       group compacts every scrutinized leaf
    stage 2 (transfer) chunked D2H   — fixed-size payload slices copied into
                       pinned host buffers with ``non_blocking=True`` on a
                       side stream, one CUDA event per chunk, the next
                       chunk's copy issued before the current one is
                       consumed (double buffering), overlapping transfer
                       with device work, disk I/O, and the training step
    stage 3 (I/O)      streamed writes — store._write_stream consumes chunk
                       sources and streams them to per-shard files with
                       incremental CRC (no full-payload host materialization)

This module owns the stage-2 plumbing: byte-chunk *sources* that the store
writer consumes, and the chunked device→host fetch loop that feeds them.

Two execution engines share these primitives:

- **host engine** (CPU tensors): ``save()`` copies each leaf to a host
  numpy array (tensors are mutable, so the copy *is* the snapshot);
  "transfer" degenerates to handing views of those copies to the writer
  (``ViewSource``) and the pack is a vectorized numpy gather.
- **device engine** (CUDA tensors, or forced on CPU tensors for tests):
  stage 1 runs ``kernels/mask_pack.pack_group`` on the caller's stream and
  stage 2 streams the device payload in ``D2H_CHUNK_BYTES`` chunks through
  bounded ``QueueSource`` queues — the writer starts on the first chunk
  while the rest is still in flight.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Fixed D2H / write chunk size.  Big enough to amortize per-chunk dispatch,
# small enough that double buffering bounds host memory for the stream.
D2H_CHUNK_BYTES = 4 << 20

# Bounded depth of each QueueSource (chunks in flight between the transfer
# thread and the writer): backpressure instead of unbounded host buffering.
QUEUE_CHUNKS = 4

# How long a producer blocked on a full queue waits before re-checking the
# shared abort event: an aborted save unblocks the producer within one
# poll interval.
ABORT_POLL_S = 0.2


def as_u8(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 (bitcast) view of a host array — zero-copy for any
    contiguous dtype, so writer/CRC code only ever sees plain byte
    buffers."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr.reshape(-1).view(np.uint8)


class ByteSource:
    """A length-known, ordered stream of byte chunks for one manifest entry.

    ``ready`` sources can be consumed more than once and in any order
    (host views / bytes); streaming sources (``QueueSource``) are
    single-consumer and must be drained in global entry order — the store
    writer picks its consumption strategy accordingly.
    """

    nbytes: int = 0
    ready: bool = True

    def chunks(self) -> Iterator[Any]:  # pragma: no cover - interface
        raise NotImplementedError


class BytesSource(ByteSource):
    def __init__(self, data: bytes):
        self.data = data
        self.nbytes = len(data)

    def chunks(self):
        if self.data:
            yield self.data


class ViewSource(ByteSource):
    """Zero-copy chunks over host arrays (one or more segments, in order).
    The source holds references to the arrays, pinning zero-copy views of
    device buffers for the lifetime of the write."""

    def __init__(self, arrays: Sequence[np.ndarray],
                 chunk_bytes: int = D2H_CHUNK_BYTES):
        self.views = [as_u8(a) for a in arrays]
        self.chunk_bytes = int(chunk_bytes)
        self.nbytes = sum(v.nbytes for v in self.views)

    def chunks(self):
        for v in self.views:
            for off in range(0, v.nbytes, self.chunk_bytes):
                yield v[off:off + self.chunk_bytes]


class QueueSource(ByteSource):
    """Single-consumer bounded chunk queue fed by a transfer thread.

    The producer calls ``put`` per chunk then ``close``; on error it calls
    ``fail(exc)`` so a blocked consumer raises instead of hanging.  When the
    *consumer* dies first, the shared ``abort`` event unblocks a producer
    stuck on a full queue (the put raises and the transfer loop fails the
    remaining sinks).
    """

    _DONE = object()
    ready = False

    def __init__(self, nbytes: int, maxsize: int = QUEUE_CHUNKS,
                 abort: Optional[threading.Event] = None):
        self.nbytes = int(nbytes)
        self.abort = abort
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)

    def _put(self, item) -> None:
        while True:
            if self.abort is not None and self.abort.is_set():
                raise RuntimeError("save pipeline aborted: writer failed")
            try:
                self._q.put(item, timeout=ABORT_POLL_S)
                return
            except queue.Full:
                continue

    def put(self, chunk) -> None:
        self._put(chunk)

    def close(self) -> None:
        self._put(self._DONE)

    def fail(self, exc: BaseException) -> None:
        # must land even on a full queue whose consumer is gone: evict.
        while True:
            try:
                self._q.put_nowait(exc)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def chunks(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def _u8_flat(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def device_chunks(arr: torch.Tensor, chunk_bytes: int,
                  ready: Optional[Any] = None) -> Iterator[np.ndarray]:
    """Walk a flat tensor in fixed-size byte chunks, yielding host uint8
    arrays — the one prefetch loop both the streaming and the
    materializing transfer paths share.

    On the card each chunk is copied into its own pinned host buffer with
    ``non_blocking=True`` on a side stream and marked by a CUDA event; the
    copy of chunk i+1 is issued before chunk i is handed out (double
    buffering), so the transfer overlaps the consumer's disk writes.
    ``ready``: a CUDA event recorded after the producing kernels on the
    caller's stream; the side stream waits on it before the first copy.
    A CPU tensor's chunks are views of its memory."""
    u8 = _u8_flat(arr)
    n = int(u8.shape[0])
    offs = range(0, n, int(chunk_bytes))
    if u8.device.type != "cuda":
        for off in offs:
            yield u8[off:off + chunk_bytes].numpy()
        return
    stream = torch.cuda.Stream(device=u8.device)
    if ready is not None:
        stream.wait_event(ready)

    def issue(off):
        host = torch.empty(min(chunk_bytes, n - off), dtype=torch.uint8,
                           pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(u8[off:off + host.shape[0]], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return host, done

    pending = issue(offs[0]) if len(offs) else None
    for k in range(len(offs)):
        host, done = pending
        pending = issue(offs[k + 1]) if k + 1 < len(offs) else None
        done.synchronize()
        yield host.numpy()


class TransferStream:
    """One flat device array whose bytes feed one or more entry queues.

    ``sinks`` maps element ranges of the flat array to ``QueueSource``s (in
    order, covering [0, n)); ``run`` walks the ``device_chunks`` stream and
    splits each host chunk across the sink boundaries it covers.
    """

    def __init__(self, dev_flat, sinks: List[Tuple[QueueSource, int, int]],
                 chunk_bytes: int = D2H_CHUNK_BYTES, ready=None):
        self.dev_flat = dev_flat
        self.sinks = sinks
        self.chunk_bytes = int(chunk_bytes)
        self.ready = ready

    def run(self) -> int:
        """Stream the array into its sinks; returns bytes moved."""
        itemsize = self.dev_flat.element_size()
        moved = 0
        si = 0                                  # current sink index
        # bytes already fed to it: a chunk size that is not a multiple of
        # the itemsize splits an element across two chunks
        sink_off = 0
        for host in device_chunks(self.dev_flat, self.chunk_bytes,
                                  self.ready):
            moved += host.nbytes
            off = 0                             # bytes consumed of the chunk
            while off < host.nbytes and si < len(self.sinks):
                sink, lo, hi = self.sinks[si]
                take = min((hi - lo) * itemsize - sink_off,
                           host.nbytes - off)
                if take > 0:
                    sink.put(host[off:off + take])
                    off += take
                    sink_off += take
                if sink_off >= (hi - lo) * itemsize:
                    sink.close()
                    si += 1
                    sink_off = 0
        while si < len(self.sinks):             # zero-length trailing sinks
            self.sinks[si][0].close()
            si += 1
        return moved


def fetch_to_host(dev_flats: Sequence[Any],
                  chunk_bytes: int = D2H_CHUNK_BYTES,
                  heartbeat: Optional[Any] = None,
                  ready: Optional[Any] = None) -> np.ndarray:
    """Materialize flat device segments into one contiguous host uint8
    buffer via the same double-buffered chunked fetch (used when a stream
    cannot be consumed exactly once, e.g. several levels writing the same
    step).  ``heartbeat`` (a zero-arg callable) is invoked once per chunk
    so a long transfer on a writer thread can keep liveness tokens fresh
    without owning the loop."""
    from repro_torch import obs as obs_mod
    total = sum(int(a.numel()) * a.element_size() for a in dev_flats)
    out = np.empty(total, np.uint8)
    off = 0
    with obs_mod.get_obs().tracer.span("d2h.fetch", bytes=total):
        for arr in dev_flats:
            for h in device_chunks(arr, chunk_bytes, ready):
                out[off:off + h.nbytes] = h
                off += h.nbytes
                if heartbeat is not None:
                    heartbeat()
    return out


def run_transfers(streams: Sequence[TransferStream]) -> int:
    """Producer loop: feed every stream's sinks in entry order (matching the
    writer's consumption order — one producer for the whole save keeps the
    bounded queues deadlock-free regardless of pool size).  On error every
    unclosed sink is failed so the consumer raises instead of hanging."""
    from repro_torch import obs as obs_mod
    moved = 0
    try:
        with obs_mod.get_obs().tracer.span("d2h.stream") as sp:
            for st in streams:
                moved += st.run()
            sp.set(bytes=moved)
    except BaseException as e:
        for st in streams:
            for sink, _, _ in st.sinks:
                try:
                    sink.fail(e)
                except Exception:   # noqa: BLE001 - best-effort unblock
                    pass
        raise
    return moved
