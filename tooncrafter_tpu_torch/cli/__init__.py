"""Command-line entry points of the PyTorch port."""

import torch


def resolve_device(flag: str) -> torch.device:
    """``--device``: ``cpu``, else the first CUDA device; exits where there
    is none, so nothing falls back to the CPU unasked."""
    if flag == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("the PyTorch port runs on a CUDA device and none "
                         "is available (pass --device cpu to run on the "
                         "CPU)")
    return torch.device("cuda", 0)
