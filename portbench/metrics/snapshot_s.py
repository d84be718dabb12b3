"""Mean seconds of a delta snapshot, from save() until its writes are done:
all of them in the window over their number."""


def read(run):
    t = run.window.ops.get("snapshot")
    return sum(t) / len(t) if t else None
