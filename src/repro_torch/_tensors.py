"""Dtype names, host copies and the device rule shared by the package.

**Dtype names.** Manifests and reports name dtypes the way the reference
writes them (``"float32"``, ``"bfloat16"``, ``"bool"``, …), never
``"torch.float32"``, so step directories stay byte-identical.

**Host arrays.** The format layer works on numpy arrays.  numpy has no
bfloat16, so a bf16 leaf lives on the host as a ``uint16`` array of the
same bits (``Tensor.numpy()`` rejects bf16; the tensor goes through an
``int16`` view instead).  Every host array travels with its dtype *name*.

**The device rule.** Entry points run on the card unless the caller asks
for the CPU: ``resolve_device(None)`` is ``cuda`` and raises when no card
is present, naming ``device="cpu"`` as the way to ask for the host.  A
tensor on another device than the entry point's raises; it is never moved
or run on the host quietly.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

_NAME_OF = {
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
    torch.complex64: "complex64", torch.complex128: "complex128",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_TORCH_OF = {v: k for k, v in _NAME_OF.items()}


def dtype_name(dtype) -> str:
    """Reference-style name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _NAME_OF[dtype]
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_OF[str(name)]


def host_dtype(name: str) -> np.dtype:
    """numpy dtype that holds a leaf of dtype ``name`` on the host (bf16:
    its bits as uint16)."""
    name = str(name)
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def itemsize(name: str) -> int:
    return host_dtype(name).itemsize


def leaf_dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NAME_OF[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def to_host(leaf, copy: bool = False) -> np.ndarray:
    """Host numpy array of a tensor (bf16 as uint16 bits) or array-like.
    ``copy`` guarantees the result shares no memory with ``leaf``."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True) if copy else np.asarray(leaf)
    t = leaf.detach()
    fresh = t.device.type != "cpu"
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).numpy().view(np.uint16)
    else:
        arr = t.numpy()
    return arr.copy() if (copy and not fresh) else arr


def host_copy_nbytes(arr: np.ndarray) -> int:
    """Bytes :func:`from_host` copies on the host before it moves ``arr``:
    all of a read-only or strided array, none of a writable contiguous
    one."""
    arr = np.asarray(arr)
    return 0 if arr.flags.c_contiguous and arr.flags.writeable \
        else arr.nbytes


def from_host(arr: np.ndarray, name: str,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Tensor of dtype ``name`` on ``device`` from a host array holding its
    values (bf16: uint16 bits).  On the CPU the tensor may share a
    writable contiguous ``arr``'s memory."""
    arr = np.asarray(arr)
    if host_copy_nbytes(arr):
        arr = arr.copy()
    if str(name) == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def fill_host(fill, name: str):
    """``fill`` as a value of the host dtype of ``name`` (bf16: its bits)."""
    if str(name) == "bfloat16":
        bits = torch.tensor(fill, dtype=torch.bfloat16).view(torch.int16)
        return np.int16(bits.item()).view(np.uint16)
    return np.asarray(fill).astype(host_dtype(name))


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device=\"cpu\" to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def alloc_device(device: Optional[Union[str, torch.device]]
                 ) -> torch.device:
    """Where an entry point that only allocates (a cache, a state from host
    arrays) puts its tensors: :func:`resolve_device`'s rule, and
    ``"meta"`` for shapes only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def check_on(leaf: Any, device: torch.device, what: str) -> None:
    """Raise when a tensor lies on another device type than ``device``."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != device.type:
        raise RuntimeError(
            f"{what}: tensor on {leaf.device} handed to an entry point "
            f"running on {device}; move it explicitly or pass "
            f"device=\"{leaf.device.type}\"")
