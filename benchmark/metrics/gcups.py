"""gcups (GCUPS, higher is better; end to end, host clock).

DP cells of every job that answered in the window, over all of the window's
seconds, in 1e9 a second: the reference program's figure of merit (cells
over its ``Time:`` line), taken over the whole window.
"""


def read(run):
    return run.cells / run.window_s / 1e9 if run.done else None
