"""Weights for the port: JAX parameter trees to an upstream-named state
dict, random initialisation from an explicit generator, and the cast to
the compute dtype.

``from_jax_params`` inverts the layout transforms of the checkpoint mapping
(``utils/checkpoint.py``, the port's copy of the JAX package's tables), so
the port and the JAX package can be given the same weights: the port's
module names are the upstream ``lvdm`` state-dict keys that mapping
targets.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from tooncrafter_tpu_torch.utils import checkpoint as ckpt

_INVERSE = {
    ckpt.t_linear: lambda w: w.T,                             # (I,O)->(O,I)
    ckpt.t_conv2d: lambda w: w.transpose(3, 2, 0, 1),         # HWIO->OIHW
    ckpt.t_conv1x1: lambda w: w.T[:, :, None, None],
    ckpt.t_conv1d1: lambda w: w.T[:, :, None],
    ckpt.t_conv3d: lambda w: w.transpose(4, 3, 0, 1, 2),      # THWIO->OITHW
    ckpt.t_none: lambda w: w,
}


def _leaf(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def from_jax_params(params: Dict[str, Any], config,
                    dualref: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``ToonCrafter.init_params``-shaped tree (arrays of any kind) ->
    fp32 state dict for ``tooncrafter_tpu_torch.models.diffusion.
    ToonCrafter(config, dualref)``. The JAX model holds both decoders: the
    dual-ref one (``params["dualref_decoder"]``) goes to
    ``first_stage_model.decoder`` when ``dualref``, else the plain one
    (``params["vae"]["decoder"]``); ``post_quant_conv`` goes either way."""
    sd = {}
    for tower, entries in ckpt.full_mapping(config, dualref=dualref).items():
        for jpath, tkey, fn in entries:
            leaf = _leaf(params.get(tower, {}), jpath)
            if leaf is None:
                continue  # optional tensor absent from this topology
            arr = _INVERSE[fn](np.asarray(leaf, np.float32))
            sd[tkey] = torch.from_numpy(np.array(arr, order="C"))
    return sd


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator``: norms get ones and zeros,
    biases and scalar gates zeros, every other tensor a normal with std
    fan_in^-1/2 (LeCun, the JAX package's default)."""
    convs = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias" or p.ndim == 0 or name == "mix_factor":
                p.zero_()
            else:
                fan_in = (p[0].numel() if isinstance(mod, convs)
                          and name == "weight" else p.shape[-1])
                p.normal_(0.0, fan_in ** -0.5, generator=generator)


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module`` to ``dtype`` in place, keeping the norms' parameters
    fp32 (their statistics are fp32 either way)."""
    module.to(dtype)
    for mod in module.modules():
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.float()
    return module
