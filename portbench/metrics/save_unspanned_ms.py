"""Mean milliseconds of a delta snapshot that no stage of the save covers:
the operation's time (``save()`` until its writes are done) less the
caller's stall (``save.blocked_s``) and the writer thread's stages
(``delta_s``, ``write_s``, ``retention_s``: its ``delta``, ``write`` and
``save.retention`` spans).  Only delta snapshots record them, one each,
in the order of the window's ``snapshot`` operations."""

PARTS = ("save.blocked_s", "save.stages.delta_s", "save.stages.write_s",
         "save.stages.retention_s")


def read(run):
    ops = run.window.ops.get("snapshot")
    parts = [run.window.program.get(k) for k in PARTS]
    if not ops or not all(p and len(p) == len(ops) for p in parts):
        return None
    return 1e3 * sum(o - sum(r) for o, *r in zip(ops, *parts)) / len(ops)
