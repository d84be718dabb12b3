"""Mean milliseconds a delta snapshot holds its caller in ``save()``
(``last_save_stats["blocked_s"]``)."""


def read(run):
    t = run.window.program.get("save.blocked_s")
    return 1e3 * sum(t) / len(t) if t else None
