"""One scrutinized base covering ``cover`` decode steps, then decode
``steps_between`` steps and save a delta, waited on; time the save.  Past
the cover or the chain's length (``max_chain``) the host re-scrutinizes and
writes a new base, timed apart (``rebase``)."""

from __future__ import annotations

from portbench import judge as J
from portbench.metrics import arith
from portbench.serving import DELTA_CHUNK_BYTES, Reservoir


def _manager(host, root: str, report, max_chain: int, keep_n: int):
    from repro_torch import CheckpointManager, Level
    return CheckpointManager([Level(root, keep_n=keep_n,
                                    max_chain=max_chain)],
                             scrutiny_fn=lambda s: report,
                             save_mode="device", restore_mode="device",
                             device=host.device)


def run(host, window, root, keep: int = 2) -> dict:
    tr = host.traffic
    steps, hz = tr["steps_between"], tr["horizon"]
    kept = Reservoir(keep, host.rng)
    base = {}

    def new_base(step: int) -> None:
        if base.get("mgr") is not None:
            base["mgr"].close()
            # retention drops the old chain: judge a sample of the new one
            kept.reset()
        host.room(steps, hz)
        crit = min(host.pos + tr["cover"], host.max_len - hz)
        rep = host.scrutinize(crit)
        mgr = _manager(host, root, rep, tr["max_chain"], keep_n=2)
        mgr.save(step, host.state, block=True)
        base.update(mgr=mgr, crit=crit)

    host.start()
    new_base(0)
    step = 0

    def cycle() -> None:
        nonlocal step
        step += 1
        if host.pos + steps > base["crit"]:
            with window.op("rebase", host.device):
                new_base(step)
            step += 1
        with window.span("decode"):
            host.decode(steps)
        mgr = base["mgr"]
        with window.op("snapshot", host.device) as op:
            for f in mgr.save(step, host.state, block=False):
                f.result()
            stats = mgr.last_save_stats
            if stats["levels"][root]["kind"] != "delta":
                op.name = "rebase"
                return
            op.record("save", stats)
        if window.started is None:
            return
        payload = _payload_bytes(host, base["crit"])
        k3 = arith.delta_bytes(payload, DELTA_CHUNK_BYTES)
        window.add("work", "k3_bytes", k3)
        window.add("work", "snapshot_bytes", k3 + sum(
            arith.pack_bytes(t.numel(), t.numel() * base["crit"]
                             // t.shape[2], t.element_size())
            for t in host.cache_leaves().values()))
        kept.offer({"step": step, "state": host.state, "crit": base["crit"]})

    cycle()                                        # warm: K3, the delta write
    window.open()
    while window.is_open():
        cycle()
    base["mgr"].close()
    return {"snapshots": kept.sample(), "root": root}


def _payload_bytes(host, crit: int) -> int:
    """Bytes of the cache leaves' critical payload: slots < crit."""
    return sum(t.numel() * crit // t.shape[2] * t.element_size()
               for t in host.cache_leaves().values())


def judge(kept: dict, control: bool):
    return ({"durable_mismatch": J.durable_mismatch(kept["root"],
                                                    kept["snapshots"])}, {})
