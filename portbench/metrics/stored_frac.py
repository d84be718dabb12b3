"""Bytes the store holds for the restored step (its base and every delta of
its chain: manifests and shards) over the state's bytes."""


def read(run):
    c = run.window.counts
    if "stored_bytes" not in c:
        return None
    return c["stored_bytes"] / c["state_bytes"]
