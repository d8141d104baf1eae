"""The (3, 1, 1) temporal convolution over (B, T, *spatial, C): the module,
the fused form's CUDA kernel wrapper (``csrc/temporal_conv.cu``, replacing
the TPU kernel ops/temporal_conv.py::_pallas_tconv) and its plain version.

The fused form (``temporal_conv3``) is

    z = silu(x * A + B)                      (fp32, rounded to x's dtype)
    y = (conv(z) + b) * out_scale + residual (fp32, rounded once)

with z zero-padded in T, and optionally per-frame per-channel fp32 sums
(s1, s2), each (B, T, Cout), of the rounded y over the spatial axes: the
next GroupNorm's statistics. The module keeps nn.Conv3d's parameters
(weight (O, I, 3, 1, 1), bias), the weight stored channels-last from
construction on, (O, 3, 1, 1, I) in memory: the kernel's layout, so it takes
the parameter itself, no copy. Its ``forward`` is the unfused plain form
(three dense products over the channel axis), used by the training branch
and by the decoder's 3 -> 3 ``time_mix_conv``, which the TPU package also
leaves outside its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch

LAUNCHES: Dict[str, int] = {"_pallas_tconv": 0}
_CIN_CHUNK = 32  # csrc/implicit_gemm.cuh kBK


def reset_launch_counts() -> None:
    LAUNCHES["_pallas_tconv"] = 0


def _frame_sums(y):
    """(B, T, P, C) -> per-frame fp32 sums of y and y^2, each (B, T, C)."""
    yf = y.float()
    return yf.sum(2), yf.square().sum(2)


def _plain_tconv(x, w3, bias, a, b, res, scale, silu: bool, stats: bool,
                 cdt: Optional[torch.dtype] = None):
    """x: (B, T, P, Cin); w3: (Cout, 3, Cin) taps t-1, t, t+1; a, b: (B,
    Cin) fp32 or None; res: (B, T, P, Cout) or None; scale: fp32 scalar
    tensor or None. The kernel's rounding points: z rounds to ``cdt`` (x's
    dtype unless given), y once to x's dtype."""
    cdt = x.dtype if cdt is None else cdt
    if a is not None:
        zf = x.float() * a[:, None, None] + b[:, None, None]
        if silu:
            zf = zf * torch.sigmoid(zf)
        zf = zf.to(cdt).float()
    else:
        zf = x.float()
    w = w3.float()
    y = torch.matmul(zf, w[:, 1].t()) + bias.float()
    y[:, 1:] += torch.matmul(zf[:, :-1], w[:, 0].t())
    y[:, :-1] += torch.matmul(zf[:, 1:], w[:, 2].t())
    if scale is not None:
        y = y * scale.float()
    if res is not None:
        y = y + res.float()
    y = y.to(x.dtype)
    return (y,) + _frame_sums(y) if stats else y


LIBRARY = ("temporal_conv", ("temporal_conv.cu",))
_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tc_temporal_conv.argtypes = [vp] * 10 + [i] * 8 + [vp]
    lib.tc_temporal_conv.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def _launch_tconv(x, w3, bias, a, b, res, scale, silu: bool, stats: bool):
    bsz, t, p, cin = x.shape
    cout = w3.shape[0]
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _launch.check("x", x, (bsz, t, p, cin), bf, dev)
    _launch.check("w", w3, (cout, 3, cin), bf, dev)
    _launch.check("bias", bias, (cout,), bf, dev)
    if a is not None:
        _launch.check("affine A", a, (bsz, cin), f32, dev)
        _launch.check("affine B", b, (bsz, cin), f32, dev)
    if res is not None:
        _launch.check("residual", res, (bsz, t, p, cout), bf, dev)
    if scale is not None:
        _launch.check("out_scale", scale, (), f32, dev)
    if cin % _CIN_CHUNK or cout % 8:
        raise ValueError(f"temporal conv kernel: needs Cin % {_CIN_CHUNK} "
                         f"== 0 and Cout % 8 == 0; got {cin}, {cout}")
    out = torch.empty((bsz, t, p, cout), dtype=bf, device=dev)
    # the UNet's widths (multiples of 320) take a 320-wide Cout tile, with 64
    # pixels: each source element is activated once per tap, not once per
    # 128-wide tile (csrc/implicit_gemm.cuh)
    bm, bn = (64, 320) if cout % 320 == 0 else (_launch.pixel_tile(p), 128)
    n_tiles = -(-p // bm)
    sums = ([torch.empty((bsz, t, n_tiles, cout), dtype=f32, device=dev)
             for _ in range(2)] if stats else [None, None])
    err = _library().tc_temporal_conv(
        x.data_ptr(), w3.data_ptr(), bias.data_ptr(), _launch.ptr(a),
        _launch.ptr(b), _launch.ptr(res), _launch.ptr(scale), out.data_ptr(),
        _launch.ptr(sums[0]), _launch.ptr(sums[1]), bsz, t, p, cin, cout,
        int(silu), bm, bn, _launch.stream(x))
    _launch.raise_on_error(err, f"temporal conv (B={bsz}, T={t}, P={p}, "
                                f"C={cin}->{cout})")
    if stats:
        return out, sums[0].sum(2), sums[1].sum(2)
    return out


def _pallas_tconv(x, w3, bias, a=None, b=None, res=None, scale=None,
                  silu: bool = False, stats: bool = False):
    """The wrapper named after the TPU kernel it replaces. x: (B, T, P,
    Cin); CPU tensors take the plain version, CUDA tensors the kernel."""
    if silu and a is None:
        a = torch.ones(x.shape[0], x.shape[-1], device=x.device)
        b = torch.zeros_like(a)
    cdt = _launch.compute_dtype(x)  # CUDA autocast's dtype while it is on
    x, w3, bias = x.to(cdt), w3.to(cdt), bias.to(cdt)
    res = None if res is None else res.to(cdt)
    if _launch.on_cpu("temporal conv", x, w3, bias, a, b, res, scale):
        return _plain_tconv(x, w3, bias, a, b, res, scale, silu, stats)
    _launch.refuse_grad("temporal conv", x, w3, bias, a, b, res, scale)
    out = _launch_tconv(x, w3, bias, a, b, res, scale, silu, stats)
    LAUNCHES["_pallas_tconv"] += 1
    return out


def taps(weight):
    """nn.Conv3d weight (Cout, Cin, 3, 1, 1) as (Cout, 3, Cin): K = 3 * Cin,
    tap-major, as the kernel reads it. A view of a channels-last weight (as
    ``TemporalConv3`` keeps it); a copy of any other."""
    return weight[:, :, :, 0, 0].permute(0, 2, 1).contiguous()


def temporal_conv3(x, weight, bias, affine=None, silu: bool = False,
                   residual=None, out_scale=None, return_stats: bool = False):
    """The fused form over x (B, T, *spatial, Cin) with nn.Conv3d's
    ``weight``/``bias``; ``affine`` is a folded GroupNorm (A, B) from ops/norms.gn_affine,
    ``out_scale`` a 0-d fp32 tensor. Returns y, or (y, s1, s2) with
    per-frame sums (B, T, Cout)."""
    bsz, t = x.shape[:2]
    cout = weight.shape[0]
    a, b = affine if affine is not None else (None, None)
    res = None if residual is None else residual.reshape(bsz, t, -1, cout)
    scale = None if out_scale is None else out_scale.float().reshape(())
    out = _pallas_tconv(x.reshape(bsz, t, -1, x.shape[-1]),
                        taps(weight), bias, a, b, res, scale, silu,
                        return_stats)
    y = out[0] if return_stats else out
    y = y.reshape(x.shape[:-1] + (cout,))
    return (y,) + tuple(out[1:]) if return_stats else y


class TemporalConv3(nn.Conv3d):
    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0))
        self.weight.data = self.weight.data.contiguous(
            memory_format=torch.channels_last_3d)

    def forward(self, x, residual=None, out_scale=None):
        """out_scale * conv(x) + residual (each optional), plain."""
        w = self.weight[:, :, :, 0, 0]
        # out of place: selective checkpointing may keep the products
        y = F.linear(x, w[:, :, 1], self.bias)
        pad = y.new_zeros(y[:, :1].shape)
        y = (y + torch.cat([pad, F.linear(x[:, :-1], w[:, :, 0])], 1)
             + torch.cat([F.linear(x[:, 1:], w[:, :, 2]), pad], 1))
        if out_scale is not None:
            y = y * out_scale.to(y.dtype)
        if residual is not None:
            y = y + residual
        return y

    def fused(self, x, affine, residual=None, out_scale=None,
              return_stats: bool = False):
        """silu(x * A + B) through this conv, with the fused epilogue."""
        return temporal_conv3(x, self.weight, self.bias, affine, silu=True,
                              residual=residual, out_scale=out_scale,
                              return_stats=return_stats)
