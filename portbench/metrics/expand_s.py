"""Mean seconds a restore spends expanding leaves on the host: the sum of
the port's ``restore.expand`` spans (a leaf stored ``full`` or tiered:
``unpack_leaf``, then ``from_host``'s copy to the card) over a restore."""


def read(run):
    t = run.window.program.get("span.restore.expand")
    n = len(run.window.ops.get("restore", ()))
    return sum(t) / n if t and n else None
