"""The NPB class-S programs of the paper's evaluation (§IV), in PyTorch.

Port of ``repro.npb``: the same state names, checkpoint instants, read
ranges and arithmetic, in float64, complex128 and int32 named at every
tensor (the reference turns on JAX's x64 globally; this package sets no
default dtype).  ``get_benchmark(name, device=None)`` runs on the card
unless ``device="cpu"`` is passed.
"""

from repro_torch.npb import common
from repro_torch.npb.common import ALL_BENCHMARKS, get_benchmark

__all__ = ["common", "ALL_BENCHMARKS", "get_benchmark"]
