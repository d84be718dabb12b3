"""Build and load the port's hand-written CUDA kernels (one helper for all).

Each kernel module names one source under ``csrc/`` and the C functions it
exports.  At first use the source is compiled with ``nvcc`` for
``sm_90a`` into ``<build dir>/<stem>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds), then loaded with
``ctypes`` and every exported function gets its ``argtypes`` and an
``int`` return (``cudaGetLastError()``).  Nothing is
built or imported at module import, so the CPU tests import the kernel
modules on a machine without ``nvcc`` or a card; a missing compiler or a
failed build raises.

The build directory is ``build/repro_torch/`` at the root of the checkout
unless ``$REPRO_COMPILE_CACHE`` or :func:`set_build_dir` says otherwise
(``launch/compile_cache.py``): another directory, or none, in which case
each process builds into a temporary directory of its own, removed at its
exit.  Every :meth:`CudaLibrary.load` reads it.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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


_UNSET = object()
_build_dir = _UNSET              # a Path, None (per-process), or unset
_tmp_dir: Optional[Path] = None


def set_build_dir(path) -> None:
    """Build into ``path``; ``None``: a per-process temporary directory."""
    global _build_dir
    _build_dir = None if path is None else Path(path)


def build_dir() -> Path:
    """The directory :meth:`CudaLibrary.load` builds into and loads from:
    the one :func:`set_build_dir` named, else ``$REPRO_COMPILE_CACHE``'s
    (``launch/compile_cache.default_cache_dir``; unset: ``BUILD_DIR``)."""
    global _tmp_dir
    d = _build_dir
    if d is _UNSET:
        from repro_torch.launch.compile_cache import default_cache_dir
        env = default_cache_dir()
        d = None if env is None else Path(env)
    if d is not None:
        return d
    if _tmp_dir is None:
        _tmp_dir = Path(tempfile.mkdtemp(prefix="repro_torch_build_"))
        atexit.register(shutil.rmtree, str(_tmp_dir), True)
    return _tmp_dir


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
            out_dir = build_dir()
            so = out_dir / f"{self.stem}-{tag}.so"
            t0 = time.perf_counter()
            log = ""
            built = not so.exists()
            if built:
                out_dir.mkdir(parents=True, exist_ok=True)
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
