"""Set-up: process start to the first timed request or step (imports, the
kernels' build on a cold checkout, the model made and filled, the
warm-up)."""


def read(run):
    return run.setup_s
