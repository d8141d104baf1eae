"""The device's idle share, in %: 1 - the union of device activity in the
profiled request or steps over the untraced window's host time for the
same work. The profiler lengthens the profiled call's own wall; busy, the
device's time, it leaves as it is."""

from benchmark.harness.trace import untraced_wall


def read(run):
    tr = run.trace
    if not tr or not tr["device_events"] or not run.units:
        return None
    return (1.0 - tr["busy_s"] / untraced_wall(run)) * 100.0
