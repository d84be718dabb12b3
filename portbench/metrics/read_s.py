"""Mean seconds of the restore's read of the step from the store: the
port's own ``restore.read`` span (a host read, chain walk and CRCs)."""


def read(run):
    t = run.window.program.get("span.restore.read")
    return sum(t) / len(t) if t else None
