"""Mean milliseconds of a delta snapshot's retention sweep on the writer
thread (``last_save_stats["stages"]["retention_s"]``, the time of its
``save.retention`` span): listing the level, the kept steps' manifests,
removing what no kept step needs."""


def read(run):
    t = run.window.program.get("save.stages.retention_s")
    return 1e3 * sum(t) / len(t) if t else None
