"""K4 mask_scatter's share of its roofline (its count pass and its move):
the bytes of the restored cache leaves (``arith.scatter_bytes``) at
3.35 TB/s over its device time in the profile of the window."""

from portbench.metrics import arith

KERNELS = ("scatter_kernel", "word_counts_kernel",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_seconds(KERNELS)
    b = run.window.work.get("k4_bytes")
    if not t or not b:
        return None
    return 100 * arith.roofline_share(sum(b), t)
