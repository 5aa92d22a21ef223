"""env_steps_per_s: the room-steps whose results were synchronised inside
the window, over the window's seconds (host clock)."""


def read(cell, run):
    return run.work / run.window_s
