"""setup_s: process start to the first timed request (imports, the card's
start, any kernel build, the weights, the warm-up calls)."""


def read(run):
    return run.setup_s
