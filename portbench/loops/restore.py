"""A scrutinized base and ``deltas`` deltas ``steps_between`` decode steps
apart in set-up; restore the newest step into fresh tensors on the card
over and over; time each restore.  Repeated reads come from the page
cache."""

from __future__ import annotations

import torch

from portbench import judge as J
from portbench.loops.snapshot import _manager
from portbench.metrics import arith
from portbench.serving import Reservoir


def run(host, window, root, keep: int = 2) -> dict:
    from portbench.reference.store import chain_of, step_bytes
    from repro_torch import _tree
    tr = host.traffic
    host.start()
    crit = host.pos + tr["headroom"]
    rep = host.scrutinize(crit)
    mgr = _manager(host, root, rep, tr["deltas"], keep_n=tr["deltas"] + 2)
    mgr.save(0, host.state, block=True)
    for step in range(1, tr["deltas"] + 1):
        host.decode(tr["steps_between"])
        mgr.save(step, host.state, block=True)
    saved, newest = host.state, tr["deltas"]
    window.counts["stored_bytes"] = step_bytes(root, chain_of(root, newest))
    window.counts["state_bytes"] = host.state_bytes()
    shapes = {n: (t.numel(), t.element_size(), t.shape[2])
              for n, t in host.cache_leaves().items()}
    k4 = sum(arith.scatter_bytes(n, n * crit // s, es)
             for n, es, s in shapes.values())
    kept = Reservoir(keep, host.rng)
    # what restore() is handed for the shapes: ones, not the saved state,
    # so a restore that hands it back shows
    named, treedef = _tree.flatten_with_names(saved)
    like = _tree.unflatten(treedef, [torch.ones_like(t) for _, t in named])

    def once() -> None:
        with window.op("restore", host.device) as op:
            step, out = mgr.restore(like)
            op.record("restore", mgr.last_restore_stats)
        if step != newest:
            raise RuntimeError(f"restored step {step}, not {newest}")
        if window.started is None:
            return
        window.add("work", "k4_bytes", k4)
        window.add("work", "restore_bytes",
                   k4 + mgr.last_restore_stats["h2d_bytes"])
        kept.offer(out)

    once()                                          # warm
    window.open()
    while window.is_open():
        once()
    mgr.close()
    return {"restored": kept.sample(), "saved": saved, "crit": crit}


def judge(kept: dict, control: bool):
    numbers = {"restore_mismatch": J.restore_mismatch(
        kept["restored"], kept["saved"], kept["crit"])}
    controls = {}
    if control:
        controls["restore_mismatch"] = J.restore_mismatch(
            [J.fp8_state(kept["saved"])], kept["saved"], kept["crit"])
    return numbers, controls
