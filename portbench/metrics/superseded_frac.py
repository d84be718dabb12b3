"""Share of the bytes a restore's chain walk read (``bytes_read``: the base
and every delta of the chain) that a later entry of the same walk wrote
over (``superseded_bytes``), summed over the window's restores: the read
that a chain of deltas wastes."""


def read(run):
    s = run.window.program.get("restore.superseded_bytes")
    r = run.window.program.get("restore.bytes_read")
    if not s or not r or not sum(r):
        return None
    return sum(s) / sum(r)
