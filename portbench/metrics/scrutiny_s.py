"""Mean seconds of a re-scrutiny, synchronized: all of them in the window over
their number."""


def read(run):
    t = run.window.ops.get("scrutiny")
    return sum(t) / len(t) if t else None
