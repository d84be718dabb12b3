"""Where K2's and K4's time goes on the card (needs one CUDA device).

    python3 scripts/mask_pack_breakdown.py

At chip_smoke.py's phase-5 shape, a 2^29-element f32 leaf, for mask
densities 0, 0.148 and 1: the move kernels alone (``mp_pack``,
``mp_mask_scatter`` with the counts and their scan made beforehand), the
count pass and its scan alone, and the whole wrappers (``ops.pack_group``,
``ops.mask_scatter``), beside PyTorch's own streaming passes over the same
bytes (``fill_`` writes 2^29 f32, ``copy_`` reads and writes them).  It
also counts the 32-, 64- and 128-byte pieces of the leaf that hold a
critical element at density 0.148: the word bound counts 32-byte sectors,
the memory moves larger pieces.  Median of 10 CUDA-event timings; the
card's name and power limit come first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels._build import stream_of  # noqa: E402
from repro_torch.kernels.mask_pack import kernel as K  # noqa: E402
from repro_torch.kernels.mask_pack import ops  # noqa: E402

N = 1 << 29
REPS = 10


def median_ms(fn) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mask_pack_breakdown: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = K.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(N, generator=gen, device="cuda")
    out = torch.empty_like(w)
    st = stream_of(w)
    print(f"fill_ (writes {4 * N} B): {median_ms(lambda: out.fill_(0.0)):.4f}"
          f" ms; copy_ (reads and writes {4 * N} B): "
          f"{median_ms(lambda: out.copy_(w)):.4f} ms")
    for frac in (0.0, 0.148, 1.0):
        sel = torch.rand(N, generator=gen, device="cuda") < frac
        words = ops.mask_to_words(sel)
        total = int(sel.sum())
        counts, ends = K._counts_and_ends(lib, words, N)
        pay = torch.masked_select(w, sel) if total else w[:1].clone()
        dst = torch.empty(max(total, 1), device="cuda")

        def k2():
            lib.mp_pack(w.data_ptr(), words.data_ptr(), N, counts.data_ptr(),
                        ends.data_ptr(), dst.data_ptr(), total, None, 4, st)

        def k4():
            lib.mp_mask_scatter(pay.data_ptr(), pay.numel(), words.data_ptr(),
                                N, counts.data_ptr(), ends.data_ptr(), 0, 0,
                                out.data_ptr(), 4, st)

        k2()
        k4()
        ok = torch.equal(dst[:total], pay[:total]) and torch.equal(
            out, torch.where(sel, w, torch.zeros_like(w)))
        if not ok:
            sys.exit(f"mask_pack_breakdown: wrong result at density {frac}")
        print(f"density {frac}: K2 move {median_ms(k2):.4f} ms, K4 move "
              f"{median_ms(k4):.4f} ms, count pass + scan "
              f"{median_ms(lambda: K._counts_and_ends(lib, words, N)):.4f}"
              f" ms; whole pack_group "
              f"{median_ms(lambda: ops.pack_group([w], [words], [total])):.4f}"
              f" ms, whole mask_scatter "
              f"{median_ms(lambda: ops.mask_scatter(pay, words, n=N)):.4f} ms")
        if frac == 0.148:
            pieces = {b: int(sel.view(-1, b // 4).any(1).sum())
                      for b in (32, 64, 128)}
            print("pieces of w holding a critical element: " + ", ".join(
                f"{v} of {N * 4 // b} {b}-byte ({v * b} B)"
                for b, v in pieces.items()))


if __name__ == "__main__":
    main()
