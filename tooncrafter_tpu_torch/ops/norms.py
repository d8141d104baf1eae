"""GroupNorm and LayerNorm over channels-last tensors with fp32 statistics.

Statistics are always taken in fp32 and the result is cast back to the
input dtype; the activation (SiLU) of a GN+SiLU pair runs after that cast,
the "ref" cast point of tooncrafter_tpu/ops/spatial_conv.py. Eps differs by
site: 1e-6 in the VAE and transformer norms, 1e-5 in the UNet ResBlocks and
temporal convs (the callers pass it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tooncrafter_tpu_torch.ops import stats as _stats


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
               act: bool = False, shift: Optional[torch.Tensor] = None):
    """x: (N, *spatial, C). Statistics span every spatial axis and the
    channels of a group (torch's 4-D and 5-D semantics). ``shift`` (N, C)
    is added to x before the norm (the UNet ResBlock's time embedding)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if shift is not None:
        xf = xf + shift.float().reshape((n,) + (1,) * (x.ndim - 2) + (c,))
    g = xf.reshape(n, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(g, dim=(1, 3), correction=0, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (y * weight.float() + bias.float()).to(x.dtype)
    return F.silu(y) if act else y


def gn_affine_from_stats(s1, s2, spatial: int, weight, bias,
                         num_groups: int = 32, eps: float = 1e-6,
                         shift: Optional[torch.Tensor] = None):
    """Folded per-sample GroupNorm affine from per-channel fp32 sums.

    s1, s2: (N, C) sums of x and x^2 over ``spatial`` positions, typically
    from a producing conv's stats epilogue. Returns fp32 (A, B), each
    (N, C), with group_norm(x + shift) == x * A + B. The variance is
    E[x^2] - mean^2 clamped at 0, as the JAX package computes it. A
    ``shift`` (N, C) (the ResBlock's time embedding) is folded in from the
    sums: s1' = s1 + P e, s2' = s2 + 2 e s1 + P e^2, B += e A.
    """
    n, c = s1.shape
    count = spatial * (c // num_groups)
    if shift is not None:
        e = shift.float()
        s2 = s2 + 2.0 * e * s1 + spatial * e.square()
        s1 = s1 + spatial * e
    mean = s1.reshape(n, num_groups, -1).sum(-1, keepdim=True) / count
    var = (s2.reshape(n, num_groups, -1).sum(-1, keepdim=True) / count
           - mean.square()).clamp_min(0.0)
    # the group statistics broadcast over each group's channels
    a = torch.rsqrt(var + eps) * weight.float().reshape(num_groups, -1)
    b = (bias.float().reshape(num_groups, -1) - mean * a).reshape(n, c)
    a = a.reshape(n, c)
    if shift is not None:
        b = b + e * a
    return a, b


# Per-sample per-channel fp32 sums of x and x^2 over every axis but the
# first and the last: (N, *spatial, C) -> two (N, C). The plain version of
# ops/stats.py, beside its kernel; the models keep it (the JAX package's
# models take their sums inline, not through its parked kernel).
channel_sums = _stats._plain_sums


# ---------------------------------------------------------------------------
# the cross-block stats chain (tooncrafter_tpu/models/unet.py:844-970,
# vae_dualref.py:392-446): per-channel fp32 sums (s1, s2) travel with the
# activation from the block that produced it to the next norm
# ---------------------------------------------------------------------------

def output_sums(y, axes):
    """fp32 sums of y and y^2 over ``axes``: the sums a block takes of its
    own output, as the JAX transformers and Combiner take them inline
    (y cast to fp32 before the square)."""
    yf = y.float()
    return yf.sum(axes), yf.square().sum(axes)


def sums_over_frames(stats, b: int, t: int):
    """Per-frame sums (B*T, C) -> sums over (T, H, W), each (B, C): what a
    5-D GroupNorm spans (unet.py:893-897)."""
    return tuple(s.reshape(b, t, -1).sum(1) for s in stats)


def concat_sums(a, b):
    """The sums of a channel concat [x_a, x_b]: the concat of their sums;
    None unless both are known (unet.py:954-960)."""
    if a is None or b is None:
        return None
    return tuple(torch.cat([p, q], dim=-1) for p, q in zip(a, b))


def replace_end_frames(stats, first, last):
    """Per-frame (B, T, C) sums of a clip whose frames 0 and -1 became
    ``first`` and ``last`` (each (B, 1, H, W, C)): their sums taken afresh,
    the T - 2 frames between kept (the Combiner, vae_dualref.py:209-235)."""
    f, l = output_sums(first, (2, 3)), output_sums(last, (2, 3))
    return tuple(torch.cat([fs, s[:, 1:-1], ls], dim=1)
                 for s, fs, ls in zip(stats, f, l))


def apply_affine(x, a, b, act: bool):
    """x * A + B in fp32 (A, B: (N, C)), SiLU in fp32 when ``act``, one
    rounding to x's dtype: a GroupNorm applied from chained sums (the JAX
    ``GroupNormAct`` with ``stats``, norms.py:153-171)."""
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    out = torch.addcmul(b.reshape(bshape), x, a.reshape(bshape))
    if act:
        out = out.mul_(torch.sigmoid(out))
    return out.to(x.dtype)


def gn_affine(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
              shift: Optional[torch.Tensor] = None):
    """gn_affine_from_stats with the sums taken from x (plain torch: the
    first norm of a chain, as the JAX package does)."""
    spatial = 1
    for d in x.shape[1:-1]:
        spatial *= d
    return gn_affine_from_stats(*channel_sums(x), spatial, weight, bias,
                                num_groups, eps, shift)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


def layer_norm_ex2(x, weight, bias, eps: float, cdt):
    """LayerNorm as the fused kernels' prologues compute it (the TPU
    kernels' ``_ln_tile``): fp32, variance E[x^2] - mean^2 clamped at 0,
    rounded to ``cdt`` and returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight.float()
            + bias.float()).to(cdt).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """torch.nn.GroupNorm's parameters (``weight``, ``bias``) applied to a
    channels-last tensor with fp32 statistics; ``act`` adds SiLU.

    Given ``stats`` (the producer's sums of x), the norm folds them and
    applies x * A + B without reading x for statistics (``apply_affine``).
    Without them, ``one_pass`` marks the JAX package's ``GroupNormAct``
    sites (False where it runs its plain ``GroupNorm``): there the norm goes
    through ``fused_norms.group_norm_silu``, as ``GroupNormAct`` does
    (tooncrafter_tpu/ops/norms.py:170-175): the one-pass kernel under
    TOONCRAFTER_FUSED_GN=1 where a sample fits its budget, else this
    module's own formula."""

    def __init__(self, channels: int, eps: float = 1e-6, act: bool = False,
                 num_groups: int = 32, one_pass: bool = True):
        super().__init__(num_groups, channels, eps=eps)
        self.act = act
        self.one_pass = one_pass

    def forward(self, x, shift=None, stats=None):
        from tooncrafter_tpu_torch.ops import fused_norms

        if stats is not None:
            return apply_affine(x, *self._from_stats(x, shift, stats),
                                self.act)
        if not self.one_pass:
            return group_norm(x, self.weight, self.bias, self.num_groups,
                              self.eps, self.act, shift)
        return fused_norms.group_norm_silu(x, self.weight, self.bias,
                                           self.num_groups, self.eps,
                                           self.act, shift)

    def folded(self, x, shift=None, stats=None):
        """Folded fp32 (A, B) for a fused conv prologue; ``stats`` (s1, s2)
        are per-(N, C) sums of x from the producer (x then only gives the
        spatial count)."""
        if stats is None:
            return gn_affine(x, self.weight, self.bias, self.num_groups,
                             self.eps, shift)
        return self._from_stats(x, shift, stats)

    def _from_stats(self, x, shift, stats):
        spatial = 1
        for d in x.shape[1:-1]:
            spatial *= d
        return gn_affine_from_stats(stats[0], stats[1], spatial, self.weight,
                                    self.bias, self.num_groups, self.eps,
                                    shift)


class LayerNorm(nn.LayerNorm):
    """torch.nn.LayerNorm's parameters with fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
