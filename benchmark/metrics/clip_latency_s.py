"""Seconds an animator waits for a clip: the window over the clips it
completed (one client, batch 1, requests back to back)."""


def read(run):
    return run.window_s / run.units if run.units else None
