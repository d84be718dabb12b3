"""Mean seconds of the scrutiny's reads pre-pass, as the report states it
(``stats["prepass_reads_s"]``)."""


def read(run):
    t = run.window.program.get("scrutiny.prepass_reads_s")
    return sum(t) / len(t) if t else None
