"""A fan-in-scaled constant fill for compile-style checks and the graft
entry (tooncrafter_tpu/utils/synth.py).

Each parameter is set to ``scale / fan_in``, where fan_in is the product of
every dim but the last of the tensor *in the JAX package's layout*, and a
tensor of fewer than two dims (in either layout) to ``scale``: constant
weights sum coherently over constant activations, so 1/fan_in keeps them
bounded through a deep stack. In torch's layouts a Linear or conv weight
((O, I, ...), the JAX kernel (..., I, O)) and the CLIP towers' fused
``in_proj_weight`` ((3W, W), the JAX kernel (W, 3W)) take the product of
every dim but the first, ``p[0].numel()``; every other tensor (embeddings,
position tables, the resampler's latents) has the JAX layout. Time does
not depend on the values, which are no model.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_WEIGHTED = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def fan_in(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The JAX layout's product of every dim but the last."""
    if p.ndim < 2:
        return 1
    if (isinstance(module, _WEIGHTED) and name == "weight") \
            or name == "in_proj_weight":
        return p[0].numel()
    return math.prod(p.shape[:-1])


@torch.no_grad()
def synth_(module: nn.Module, dtype: torch.dtype = torch.bfloat16,
           scale: float = 0.5) -> nn.Module:
    """Fill every parameter of ``module`` in place with ``scale /
    fan_in`` in ``dtype``; GroupNorm and LayerNorm parameters keep fp32
    (the port's compute-dtype rule; the values are ``dtype``'s)."""
    norms = (nn.GroupNorm, nn.LayerNorm)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            keep = torch.float32 if isinstance(mod, norms) else dtype
            p.data = torch.full(p.shape, scale / fan_in(mod, name, p),
                                dtype=dtype, device=p.device).to(keep)
    return module
