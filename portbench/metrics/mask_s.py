"""Mean seconds a restore spends making K4's words on the host: the sum of
the port's ``restore.mask`` spans (the region decode and the ``packbits``,
a leaf at a time) over a restore."""


def read(run):
    t = run.window.program.get("span.restore.mask")
    n = len(run.window.ops.get("restore", ()))
    return sum(t) / n if t and n else None
