"""The UNet SpatialTransformers' share of their roofline (flash attention,
the cross-attention, the fused feed-forward, norms, projections), in %."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "transformer")
