"""K1's, K5's and K7's times on the card, two ways (needs one CUDA device).

    python3 scripts/kernel_timing.py [--src DIR]

Times the kernels that ``chip_smoke.py`` phase 5 times at the same shapes:
K1 (``threshold_bitpack``) on a 2^29-element f32 leaf, 14.8 % non-zero,
and on the 2^28-element f64 leaf of the same bytes; K5
(``ops.unpack_group``) over the NPB restart's eight programs, one group
of their leaves' sizes and dtypes each, summed; K7 forward and backward
at the training shape (B=2, T=1024, R=2560, f32) with h0.  Each is timed
two ways: one call started on an idle card (``single``, as
``chip_smoke.py``'s ``median_ms``: the wrapper's host issue time is in
it) and the mean of 20 calls issued back to back (``batched``: after the
first call the host issues the next while the card runs this one, so a
call that keeps the card busier than the host is timed by the card).
Median of 10 samples each; the card's name and power limit come first.
Beside K5 it prints the host time of one cast of its fill,
``torch.as_tensor(0).to(dtype)`` with its bytes read back, per dtype of
those leaves (median of 1000 on the host's clock, in µs): what the K5
wrapper does per leaf where it does not cache the fill's bytes.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that one call can time two trees.  Its
kernels are built into that tree's ``build/`` at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 10
BATCH = 20
# The NPB restart's leaves (n, dtype) per program, as chip_smoke.py's
# phase 8 restores them.
NPB_LEAVES = {
    "bt": [(1, torch.int32), (10140, torch.float64)],
    "cg": [(1, torch.int32), (1402, torch.float64)],
    "ep": [(1, torch.int32), (10, torch.float64), (1, torch.float64),
           (1, torch.float64)],
    "ft": [(1, torch.int32), (6, torch.complex128),
           (266240, torch.complex128)],
    "is": [(512, torch.int32), (1, torch.int32), (65536, torch.int32),
           (1, torch.int32)],
    "lu": [(1, torch.int32), (2028, torch.float64), (2028, torch.float64),
           (10140, torch.float64), (10140, torch.float64)],
    "mg": [(1, torch.int32), (46480, torch.float64),
           (46480, torch.float64)],
    "sp": [(1, torch.int32), (10140, torch.float64)],
}


def single_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def batched_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return float(np.median(times))


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "..", "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_timing: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.lru_scan import kernel as LK
    from repro_torch.kernels.mask_pack import kernel as K
    from repro_torch.kernels.mask_pack import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": os.path.abspath(args.src)}
    for name, dt, n in (("K1 f32", torch.float32, 1 << 29),
                        ("K1 f64", torch.float64, 1 << 28)):
        mag = torch.rand(n, generator=gen, device="cuda", dtype=dt)
        mag = torch.where(mag < 0.148, mag + 0.5, torch.zeros_like(mag))
        fn = lambda: K.bitpack(mag, 0.0)           # noqa: E731
        out[name] = {"single": single_ms(fn), "batched": batched_ms(fn)}
        del mag
        torch.cuda.empty_cache()
    groups = []
    for leaves in NPB_LEAVES.values():
        packs, words, ns = [], [], []
        for n, dt in leaves:
            flat = torch.randint(0, 100, (n,), generator=gen,
                                 device="cuda").to(dt)
            w = torch.randint(0, 256, ((n + 7) // 8,), generator=gen,
                              device="cuda").to(torch.uint8)
            packs.append(ops.pack(flat, w)[0])
            words.append(w)
            ns.append(n)
        groups.append((packs, words, ns))
    out["K5 NPB groups"] = {
        way: sum(timer(lambda: ops.unpack_group(*g, fill=0))
                 for g in groups)
        for way, timer in (("single", single_ms), ("batched", batched_ms))}
    cast_us = {}
    for dt in (torch.int32, torch.float64, torch.complex128):
        fn = lambda: torch.as_tensor(0).to(dt).reshape(1).view(  # noqa
            torch.uint8).tolist()
        times = []
        for _ in range(1000):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        cast_us[str(dt)] = float(np.median(times)) * 1e6
    out["K5 fill cast host us"] = cast_us
    shape = (2, 1024, 2560)
    a = torch.rand(shape, generator=gen, device="cuda")
    b, dh = (torch.randn(shape, generator=gen, device="cuda")
             for _ in range(2))
    h0 = torch.randn((2, 2560), generator=gen, device="cuda")
    h = LK.lru_scan(a, b, h0)
    for name, fn in (("K7", lambda: LK.lru_scan(a, b, h0)),
                     ("K7 backward",
                      lambda: LK.lru_scan_backward(a, h, h0, dh))):
        out[name] = {"single": single_ms(fn), "batched": batched_ms(fn)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
