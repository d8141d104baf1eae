"""Milliseconds of one DDIM step (a CFG-batched UNet call and the sampler's
update): the pipeline's ``denoise`` phase over the window's requests, over
their steps."""


def read(run):
    steps = run.requests * run.steps_per_unit
    if "denoise" not in run.phases or not steps:
        return None
    return run.phases["denoise"] / steps * 1e3
