"""Production mesh shapes and the hardware constants of the roofline
(port of ``repro.launch.mesh``).

A mesh is a mesh-shape dict, ``{"data": 16, "model": 16}``, the form
``distributed/sharding.py`` takes: the port has no device mesh object, and
the dry run (``launch/dryrun.py``) only needs the axes' sizes to fit the
partition specs.  The production shapes are the reference's logical ones,
so the partition decisions (``fit_spec``) stay the reference's.

The constants are an H100 SXM5's (NVIDIA H100 Tensor Core GPU datasheet,
the "H100 SXM" column; NVIDIA DGX H100 datasheet for the network):

- ``PEAK_FLOPS`` = 989e12: BF16 Tensor Core FLOP/s, dense (the datasheet's
  1,979 TFLOPS is with 2:4 sparsity, twice the dense rate);
- ``HBM_BW`` = 3.35e12: HBM3 bytes/s;
- ``LINK_BW`` = 50e9: bytes/s a GPU across nodes, one 400 Gb/s NDR
  InfiniBand port (ConnectX-7) a GPU in a DGX H100;
- ``NVLINK_BW`` = 900e9: NVLink 4 bytes/s a GPU, both directions summed,
  within a node of 8.

The collective term of the roofline uses ``LINK_BW``: a 256-GPU mesh spans
32 nodes of 8, so the data axis (16) and, in a 16 × 16 mesh, the model
axis too cross nodes, and a ring over them runs at the rate of its
slowest link, the inter-node one.  ``NVLINK_BW`` bounds only collectives
that stay inside one node, which no axis of the production meshes does.
"""

from __future__ import annotations

from typing import Dict

import torch

PEAK_FLOPS = 989e12          # bf16 FLOP/s a GPU, dense
HBM_BW = 3.35e12             # bytes/s a GPU
LINK_BW = 50e9               # bytes/s a GPU across nodes (400 Gb/s NDR)
NVLINK_BW = 900e9            # bytes/s a GPU within a node (bidirectional)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16 × 16 (data, model), or 2 × 16 × 16 (pod, data, model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """A mesh over the local devices: the CUDA devices there are, or one
    (the CPU) where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    n = max(1, n)
    data = min(data, n)
    model = min(model, max(1, n // data))
    return {"data": data, "model": model}


def mesh_chips(mesh: Dict[str, int]) -> int:
    out = 1
    for size in mesh.values():
        out *= int(size)
    return out


def mesh_name(mesh: Dict[str, int]) -> str:
    """``pod16x16`` or ``pod2x16x16``, the reference's names."""
    sizes = [str(mesh[a]) for a in ("pod", "data", "model") if a in mesh]
    return "pod" + "x".join(sizes)
