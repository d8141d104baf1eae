"""The whole request's or step's share of the bf16 peak: the frozen model
FLOP count of the work completed in the window over the window's seconds
times 989 TFLOP/s, in %."""

from benchmark.harness.counts import PEAK_FLOPS


def read(run):
    if not run.flops_per_unit or run.window_s <= 0:
        return None
    return run.flops_per_unit * run.units / (run.window_s * PEAK_FLOPS) \
        * 100.0
