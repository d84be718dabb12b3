"""The whole delta snapshot: the bytes it has to move on the card (K2's
pack and K3's compare), over the synchronized time of the operation, as
a share of the card's roofline (3.35 TB/s; the step does no model FLOPs,
so the byte bound is the roofline)."""

from portbench.metrics import arith


def read(run):
    t = run.window.ops.get("snapshot")
    b = run.window.work.get("snapshot_bytes")
    if not t or not b:
        return None
    return 100 * arith.roofline_share(sum(b), sum(t))
