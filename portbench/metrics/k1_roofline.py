"""K1 threshold_bitpack's share of its roofline: the bytes of the cache
leaves it packs (``arith.bitpack_bytes``) at 3.35 TB/s over its device
time in the profile of the window."""

from portbench.metrics import arith

KERNELS = ("bitpack_kernel",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_seconds(KERNELS)
    b = run.window.work.get("k1_bytes")
    if not t or not b:
        return None
    return 100 * arith.roofline_share(sum(b), t)
