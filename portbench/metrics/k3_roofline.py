"""K3 delta_flags' share of its roofline: the bytes of the delta
snapshots' payloads (``arith.delta_bytes``) at 3.35 TB/s over its device
time in the profile of the window."""

from portbench.metrics import arith

KERNELS = ("delta_kernel",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_seconds(KERNELS)
    b = run.window.work.get("k3_bytes")
    if not t or not b:
        return None
    return 100 * arith.roofline_share(sum(b), t)
