"""The UNet ResBlocks' share of their roofline (the 3x3 conv, the temporal
convs, the norms and elementwise work between them), in %."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "resblock")
