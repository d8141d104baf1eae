"""A block's share of its roofline: the least time of every call of the
block in the profiled request (``harness/counts.py``) over the device time
of the kernels launched inside the block's calls."""


def share(run, label):
    tr = run.trace
    if not tr or not tr.get("block_device_s", {}).get(label):
        return None
    return tr["block_least_s"][label] / tr["block_device_s"][label] * 100.0
