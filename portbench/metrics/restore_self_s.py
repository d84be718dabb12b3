"""Mean seconds of a restore that no finer span of the port covers: its
``restore.step`` span less the spans the step opens (the read, and a
leaf at a time the words, the copies, K4's launch or the host expand)."""

CHILDREN = ("restore.read", "restore.mask", "restore.h2d", "restore.scatter",
            "restore.expand")


def read(run):
    p = run.window.program
    step = p.get("span.restore.step")
    n = len(run.window.ops.get("restore", ()))
    if not step or not n:
        return None
    return (sum(step) - sum(sum(p.get(f"span.{c}", ())) for c in CHILDREN)
            ) / n
