"""The whole restore: the bytes it has to move on the card (K4's, and the
H2D copy's landing), over the synchronized time of the operation, as a
share of the card's roofline (3.35 TB/s; the step does no model FLOPs,
so the byte bound is the roofline)."""

from portbench.metrics import arith


def read(run):
    t = run.window.ops.get("restore")
    b = run.window.work.get("restore_bytes")
    if not t or not b:
        return None
    return 100 * arith.roofline_share(sum(b), sum(t))
