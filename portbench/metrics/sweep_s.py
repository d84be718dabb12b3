"""Mean seconds of a re-scrutiny outside its pre-pass: the benchmark's
synchronized span around ``scrutinize`` less the report's pre-pass time."""


def read(run):
    t = run.window.ops.get("scrutiny")
    p = run.window.program.get("scrutiny.prepass_reads_s")
    if not t or not p:
        return None
    return sum(t) / len(t) - sum(p) / len(p)
