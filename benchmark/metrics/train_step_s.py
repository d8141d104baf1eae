"""A fine-tuning job's step: the window over the steps it completed."""


def read(run):
    return run.window_s / run.units if run.units else None
