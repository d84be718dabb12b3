"""Mean seconds a restore spends moving payloads and words to the card: the
sum of the port's ``restore.h2d`` spans (``from_host``'s host copy and the
pageable copies, a leaf at a time) over a restore."""


def read(run):
    t = run.window.program.get("span.restore.h2d")
    n = len(run.window.ops.get("restore", ()))
    return sum(t) / n if t and n else None
