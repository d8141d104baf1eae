"""A renderer's throughput: clips completed over the window's minutes."""


def read(run):
    return run.units / (run.window_s / 60.0) if run.window_s > 0 else None
