"""Set-up: from the process's start to the window's open (import, weights
and prompts on the card, kernel builds, prefill, the loop's warm round)."""


def read(run):
    return run.setup_s
