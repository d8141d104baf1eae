"""Milliseconds a request spends decoding: the full dual-ref decode and the
splice's second decode, averaged over the window's requests."""


def read(run):
    if "decode" not in run.phases or not run.requests:
        return None
    total = run.phases["decode"] + run.phases.get("decode_splice", 0.0)
    return total / run.requests * 1e3
