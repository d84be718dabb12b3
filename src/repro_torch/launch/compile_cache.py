"""The build cache of the port's CUDA kernels (port of
``repro.launch.compile_cache``).

The reference points JAX's persistent compilation cache at a directory,
so a relaunch reads its compiled executables from disk.  The port
compiles with ``nvcc`` only: each ``csrc/*.cu`` source is built at first
use into a shared library named by a hash of the source and the flags
(``kernels/_build.py``), and a later process that finds the library
loads it without building.  Nothing in ``repro_torch`` calls
``torch.compile``, so there is no inductor cache to point anywhere; this
module points the nvcc build directory.

``$REPRO_COMPILE_CACHE`` keeps the reference's rules: unset, the
checkout's ``build/repro_torch/`` (git-ignored); a path, that directory;
``0``, ``off``, ``none`` or ``disable``, no cache: each process builds into
a temporary directory of its own.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.kernels import _build

_DISABLE = ("0", "off", "none", "disable")


def default_cache_dir() -> Optional[str]:
    """Resolve the cache dir from ``$REPRO_COMPILE_CACHE`` (None = off)."""
    env = os.environ.get("REPRO_COMPILE_CACHE")
    if env is not None:
        return None if env.strip().lower() in _DISABLE else env
    return str(_build.BUILD_DIR)


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Point every later ``CudaLibrary.load`` at ``cache_dir`` (default:
    :func:`default_cache_dir`).  Returns the active directory, or None when
    the cache is off (by the environment, or because the directory cannot
    be created or written): the kernels then build into a per-process
    temporary directory."""
    d = cache_dir if cache_dir is not None else default_cache_dir()
    if d is not None:
        try:
            os.makedirs(d, exist_ok=True)
            if not os.access(d, os.W_OK):
                d = None
        except OSError:
            d = None
    _build.set_build_dir(d)
    return d
