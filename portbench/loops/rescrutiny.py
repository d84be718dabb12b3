"""Decode ``steps_between`` greedy steps, then re-scrutinize
``resume_fn(horizon)`` at pos + ``headroom``, so the mask covers every
snapshot until the next re-scrutiny; time the scrutiny.  Nothing is written
to disk."""

from __future__ import annotations

from portbench import judge as J
from portbench.metrics import arith
from portbench.serving import Reservoir


def run(host, window, root, keep: int = 6) -> dict:
    tr = host.traffic
    steps, head, hz = tr["steps_between"], tr["headroom"], tr["horizon"]
    masks = Reservoir(keep, host.rng)
    host.start()
    cache_n = {n: t.numel() for n, t in host.cache_leaves().items()}

    def cycle() -> None:
        host.room(steps, head + hz)
        with window.span("decode"):
            host.decode(steps)
        probe = host.pos + head
        with window.op("scrutiny", host.device) as op:
            rep = host.scrutinize(probe)
            op.record("scrutiny", rep.stats)
        if window.started is None:
            return
        window.add("work", "k1_bytes",
                   sum(arith.bitpack_bytes(n) for n in cache_n.values()))
        window.add("work", "scrutiny_flops", arith.scrutiny_flops(
            host.config, tr["batch"], probe, hz, tr["probes"]))
        masks.offer({"probe": probe, "words": {
            n: (rep[n].device_words() if n in cache_n else None,
                rep[n].all_critical) for n in rep.leaves}})

    cycle()                                        # warm
    window.open()
    while window.is_open():
        cycle()
    shapes = {n: tuple(t.shape) for n, t in host.cache_leaves().items()}
    return {"masks": masks.sample(), "cache_shapes": shapes}


def judge(kept: dict, control: bool):
    return ({"mask_mismatch": J.mask_mismatch(kept["masks"],
                                              kept["cache_shapes"])}, {})
