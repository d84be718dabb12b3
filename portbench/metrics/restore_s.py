"""Mean seconds of a restore into fresh tensors on the card, synchronized:
all of them in the window over their number."""


def read(run):
    t = run.window.ops.get("restore")
    return sum(t) / len(t) if t else None
