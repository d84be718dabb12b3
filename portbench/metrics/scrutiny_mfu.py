"""The whole re-scrutiny's share of the card's bf16 peak: model FLOPs of
the pre-pass, the linearization and each probe's backward with respect to
the state (``arith.scrutiny_flops``) over the synchronized scrutiny time."""

from portbench.metrics import arith


def read(run):
    t = run.window.ops.get("scrutiny")
    f = run.window.work.get("scrutiny_flops")
    if not t or not f:
        return None
    return 100 * sum(f) / (sum(t) * arith.PEAK_BF16_FLOPS)
