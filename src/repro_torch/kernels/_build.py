"""Build and load the port's hand-written CUDA kernels (one helper for all).

Each kernel module names one source under ``csrc/`` and the C functions it
exports.  At first use the source is compiled with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/<stem>-<hash>.so`` at the root of the
checkout (the hash covers the source and the flags, so an edited source
rebuilds), then loaded with ``ctypes`` and every exported function gets its
``argtypes`` and an ``int`` return (``cudaGetLastError()``).  Nothing is
built or imported at module import, so the CPU tests import the kernel
modules on a machine without ``nvcc`` or a card; a missing compiler or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]                 # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
# -Xptxas -v: each kernel's registers, shared memory and spills go into
# the build log (``CudaLibrary.info["log"]``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with nvcc on a machine with the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<stem>.cu`` source, built once per source hash and loaded.

    ``signatures`` maps each exported C function to its ctypes argtypes.
    ``info`` records what the last :meth:`load` did: ``{"so": path,
    "seconds": float, "built": bool, "log": compiler output}``.
    """

    def __init__(self, stem: str, signatures: Dict[str, Sequence]):
        self.stem = stem
        self.source = CSRC / f"{stem}.cu"
        self.signatures = dict(signatures)
        self.info: Dict[str, object] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = self.source.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:16]
            so = BUILD_DIR / f"{self.stem}-{tag}.so"
            t0 = time.perf_counter()
            log = ""
            built = not so.exists()
            if built:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.source}:\n{log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.info.update(so=str(so), seconds=time.perf_counter() - t0,
                             built=built, log=log)
            self._lib = lib
            return lib


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device.

    Needs a CUDA build of PyTorch (every caller holds a CUDA tensor).  The
    raw getter skips the Stream object that the public
    ``torch.cuda.current_stream(device).cuda_stream`` builds first, host
    time that a small launch's issue time feels."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
