"""Plain reader of a checkpoint step directory, for judging what a save made
durable.

Reads ``step_<N>/manifest.json`` and the shard files it points at, walks
the delta chain the manifest names (base first, each delta patching
``chunk_bytes``-sized chunks of the previous payload), and decodes each
leaf's stored mask (``regions``: int64 [start, stop) pairs; ``bitmap``:
``np.packbits`` bits; ``full``: every element).  Written from the format's
description alone: it imports nothing of the program.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _manifest(root: str, step: int) -> dict:
    with open(os.path.join(root, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _read(root: str, step: int, entry: dict) -> bytes:
    path = os.path.join(root, f"step_{step}", f"shard_{entry['shard']}.bin")
    with open(path, "rb") as f:
        f.seek(int(entry["offset"]))
        data = f.read(int(entry["length"]))
    if len(data) != int(entry["length"]):
        raise IOError(f"{path}: short read for leaf {entry['name']}")
    return data


def chain_of(root: str, step: int) -> List[int]:
    """The steps a step needs, base first, the step itself last."""
    chain = _manifest(root, step).get("chain") or {}
    return [int(s) for s in chain.get("delta_chain", [])] + [step]


def step_bytes(root: str, steps: List[int]) -> int:
    """Bytes of every file in the given step directories."""
    total = 0
    for s in steps:
        d = os.path.join(root, f"step_{s}")
        total += sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
    return total


def _mask(entry: dict, n: int) -> Optional[np.ndarray]:
    enc = entry["encoding"]
    if enc == "full":
        return None
    aux = base64.b64decode(entry["aux"])
    if enc == "bitmap":
        return np.unpackbits(np.frombuffer(aux, np.uint8))[:n].astype(bool)
    if enc == "regions":
        mask = np.zeros(n, bool)
        for lo, hi in np.frombuffer(aux, np.int64).reshape(-1, 2):
            mask[lo:hi] = True
        return mask
    raise ValueError(f"leaf {entry['name']}: unknown encoding {enc!r}")


def read_step(root: str, step: int
              ) -> Dict[str, Tuple[tuple, str, Optional[np.ndarray], bytes]]:
    """{leaf name: (shape, dtype, stored mask or None for a full leaf,
    payload bytes of the critical elements in order)} of one step, its
    delta chain applied."""
    payload: Dict[str, np.ndarray] = {}
    meta: Dict[str, dict] = {}
    for s in chain_of(root, step):
        for e in _manifest(root, s)["leaves"]:
            raw = np.frombuffer(_read(root, s, e), np.uint8)
            name = e["name"]
            if e["encoding"] != "delta":
                payload[name], meta[name] = raw.copy(), e
                continue
            buf, chunk = payload[name], int(e["chunk_bytes"])
            idx = np.frombuffer(base64.b64decode(e["aux"]), np.int32)
            off = 0
            for c in idx.tolist():
                lo, hi = c * chunk, min((c + 1) * chunk, buf.size)
                buf[lo:hi] = raw[off:off + hi - lo]
                off += hi - lo
            if off != raw.size:
                raise IOError(f"leaf {name} at step {s}: delta of "
                              f"{raw.size} bytes patches {off}")
    out = {}
    for name, e in meta.items():
        shape = tuple(e["shape"])
        n = int(np.prod(shape)) if shape else 1
        out[name] = (shape, e["dtype"], _mask(e, n), payload[name].tobytes())
    return out
