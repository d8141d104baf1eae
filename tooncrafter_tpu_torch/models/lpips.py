"""LPIPS perceptual distance (Zhang et al. 2018), VGG16 variant
(tooncrafter_tpu/models/lpips.py), as the ``lpips`` package computes it
with ``net='vgg'``:

  input in [-1, 1] -> shift and scale (the package's ScalingLayer)
  -> VGG16 features, tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
     relu5_3 (torchvision ``features`` indices 3, 8, 15, 22, 29)
  -> each position's channels unit-normalised (eps 1e-10)
  -> squared difference -> a 1x1 "lin" head (C_l -> 1, no bias, its
     weights clamped at 0) -> spatial mean, summed over the 5 taps.

The modules carry the weights' own keys: torchvision's ``features.N.*``
and the package's ``linN.model.1.weight``. The weights are not shipped;
``load_lpips_params`` assembles a state dict from the two. The convs are
plain ``F.conv2d`` (the TPU package runs them as XLA convs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tooncrafter_tpu_torch.utils.checkpoint import t_conv2d, t_none

# torchvision VGG16 ``features``: (layer index, out channels) of each conv,
# 'M' a 2x2 max pool; a ReLU follows every conv. Taps fire after the ReLU
# of the listed convs.
_VGG16_LAYOUT: Sequence[Any] = (
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), "M",
    (17, 512), (19, 512), (21, 512), "M",
    (24, 512), (26, 512), (28, 512),
)
_TAP_AFTER = (2, 7, 14, 21, 28)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer buffers (shift and scale of the [-1, 1] input)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Sequential):
    """The VGG16 feature trunk under torchvision's indices (NCHW); returns
    the 5 LPIPS taps."""

    def __init__(self):
        layers, cin = [], 3
        for item in _VGG16_LAYOUT:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            _, ch = item
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        super().__init__(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i - 1 in _TAP_AFTER:
                taps.append(x)
        return taps


class _Lin(nn.Module):
    """The package's NetLinLayer: ``model`` = [Dropout, 1x1 conv C -> 1]."""

    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0),
                                   nn.Conv2d(c, 1, 1, bias=False))


class LPIPS(nn.Module):
    """forward(a, b) -> (B,) distances of (B, H, W, 3) images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.features = VGG16Features()
        for i, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{i}", _Lin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def _features(self, x):
        x = x.permute(0, 3, 1, 2).float()
        return self.features((x - self.shift) / self.scale)

    @torch.no_grad()
    def forward(self, a, b):
        dist = 0.0
        for i, (fa, fb) in enumerate(zip(self._features(a),
                                         self._features(b))):
            na = fa / (fa.square().sum(1, keepdim=True).sqrt() + 1e-10)
            nb = fb / (fb.square().sum(1, keepdim=True).sqrt() + 1e-10)
            lin = getattr(self, f"lin{i}").model[1].weight
            d = F.conv2d((na - nb).square(), lin.clamp(min=0.0))
            dist = dist + d.mean(dim=(1, 2, 3))
        return dist


def lpips_mapping() -> List[Tuple[Tuple[str, ...], str, Any]]:
    """Entries (TPU package parameter path, weights key, layout transform)
    of every LPIPS tensor: torchvision VGG16 ``features.N.weight/bias``
    and the lin heads ``linN.model.1.weight`` (1, C, 1, 1)."""
    entries: List[Tuple[Tuple[str, ...], str, Any]] = []
    for item in _VGG16_LAYOUT:
        if item == "M":
            continue
        idx, _ = item
        entries.append((("net", f"conv{idx}", "kernel"),
                        f"features.{idx}.weight", t_conv2d))
        entries.append((("net", f"conv{idx}", "bias"),
                        f"features.{idx}.bias", t_none))
    for i in range(len(TAP_CHANNELS)):
        entries.append(((f"lin{i}",), f"lin{i}.model.1.weight",
                        lambda w: np.reshape(w, (w.shape[1], 1))))
    return entries


def load_lpips_params(vgg_sd: Dict[str, Any],
                      lin_sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``LPIPS`` state dict from the two weight files' state dicts
    (numpy or torch values). Missing lin heads default to ones (the
    unweighted distance); a missing VGG16 tensor raises."""
    sd = {**vgg_sd, **lin_sd}
    out: Dict[str, torch.Tensor] = {}
    for jpath, tkey, _ in lpips_mapping():
        if tkey in sd:
            out[tkey] = torch.as_tensor(np.asarray(sd[tkey], np.float32))
        elif jpath[0].startswith("lin"):
            c = TAP_CHANNELS[int(jpath[0][3:])]
            out[tkey] = torch.ones(1, c, 1, 1)
        else:
            raise KeyError(f"missing VGG16 tensor {tkey}")
    return out
