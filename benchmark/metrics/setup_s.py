"""setup_s (s, lower is better; end to end, host clock).

From the start of ``run.py`` to the start of the window: imports, the
problems made from the seed, the CUDA context, the kernels' build (first run
in a checkout) and load, and the warm-up jobs.
"""


def read(run):
    return run.setup_s
