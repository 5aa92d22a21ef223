"""setup_s: from the start of the process's run to the first timed call:
imports, the card's context, lowering the game, loading (on a checkout's
first run, building) the kernels, making the inputs and weights, and the
warm-up calls (host clock)."""


def read(cell, run):
    return run.setup_s
