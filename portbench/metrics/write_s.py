"""Mean seconds of a delta snapshot's write stage on the writer thread
(``last_save_stats["stages"]["write_s"]``)."""


def read(run):
    t = run.window.program.get("save.stages.write_s")
    return sum(t) / len(t) if t else None
