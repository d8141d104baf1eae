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
(three dense products over the channel axis), used by the decoder's 3 -> 3
``time_mix_conv``, which the TPU package also leaves outside its kernel;
the UNet's training branch takes the kernel without a prologue.

On the card a call runs two kernels (``csrc/temporal_conv.cu``): the z pass
writes z, the tensor the TPU kernel rounds to bf16, into a zero-framed bf16
buffer (B, T + 2, P, Cin), and a persistent three-tap wgmma GEMM reads
each tap as a shifted box of it; ``plan`` picks the GEMM's tiles and grid
and the scratch shapes, and the wrapper allocates them with ``torch.empty``
on the caller's stream. One call counts one launch of the TPU kernel's
name. Under autograd the wrapper runs ``_TconvFunction``: the kernels (the
plain version on the CPU) forward, the gradient of the XLA form
``_xla_tconv`` back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch

LAUNCHES: Dict[str, int] = {"_pallas_tconv": 0}


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


def _xla_tconv(x, w3, bias, a, b, res, scale, silu: bool, stats: bool):
    """The JAX package's XLA form (``_xla_tconv``) in x's dtype: z =
    silu(x * A + B) in fp32 rounded to x's dtype (z = x without an affine
    or SiLU), the three shifted products, the bias, the scale and the
    residual each in x's dtype; with stats the per-frame fp32 sums.
    x: (B, T, P, Cin) (any spatial axes without stats); w3: (Cout, 3,
    Cin). Out of place: selective checkpointing may keep the products."""
    if a is not None or silu:
        z = x.float()
        if a is not None:
            z = z * a[:, None, None] + b[:, None, None]
        if silu:
            z = z * torch.sigmoid(z)
        x = z.to(x.dtype)
    y = F.linear(x, w3[:, 1])
    pad = y.new_zeros(y[:, :1].shape)
    y = y + torch.cat([pad, F.linear(x[:, :-1], w3[:, 0])], 1)
    y = y + torch.cat([F.linear(x[:, 1:], w3[:, 2]), pad], 1)
    y = y + bias
    if scale is not None:
        y = y * scale.to(y.dtype)
    if res is not None:
        y = y + res.to(y.dtype)
    return (y,) + _frame_sums(y) if stats else y


class _TconvFunction(torch.autograd.Function):
    """The kernels' forward with the gradient of the unfused XLA form
    ``_xla_tconv`` in the compute dtype, as the JAX package's custom_vjp
    recomputes through ``_xla_tconv`` (tooncrafter_tpu/ops/
    temporal_conv.py:226-263): x, the taps, the bias, A, B, the residual
    and the scale, through y and (with stats) the per-frame sums."""

    @staticmethod
    def forward(ctx, silu, stats, x, w3, bias, a, b, res, scale):
        ops = (x, w3, bias, a, b, res, scale)
        ctx.save_for_backward(*ops)
        ctx.flags = (silu, stats)
        ctx.set_materialize_grads(False)
        return _dispatch(*ops, silu, stats)

    @staticmethod
    def backward(ctx, *grads):
        return _launch.recompute_grads(ctx, grads, _xla_tconv, 2)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("temporal_conv", ("temporal_conv.cu",))
_LIB: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """A call's two kernels: the z pass into ``z``, the zero-framed bf16
    (B, T + 2, P, Cin); the three-tap GEMM over ``tiles`` tiles of ``rows``
    rows (of one sample's T P) by ``width`` output channels, walked by
    ``grid`` persistent blocks; ``sums``, the fp32 (B, T, slots, Cout)
    partial sums each of s1 and s2 (slots: the most row tiles one frame
    touches), which the caller sums over the slots."""
    z: Tuple[int, int, int, int]
    rows: int
    width: int
    tiles: int
    grid: int
    sums: Tuple[int, int, int, int]


def _slots(t: int, p: int, rows: int) -> int:
    """The most row tiles of ``rows`` rows that one frame of p rows
    touches, at the frames' offsets 0, p, ..., (t - 1) p."""
    return max(((f + 1) * p - 1) // rows - f * p // rows + 1
               for f in range(t))


@functools.lru_cache(maxsize=None)
def plan(bsz: int, t: int, p: int, cin: int, cout: int,
         sms: int = _launch.H100_SMS) -> Plan:
    """The kernels' tiles, grid and scratch for x (B, T, P, Cin) and Cout:
    128-row tiles unless they give fewer tiles than SMs, then 64; 160
    output channels where Cout allows, else 128. Raises ValueError outside
    the kernels' envelope: Cin % 8 == 0 and at most 8192 (the z pass's
    16-byte rows, one thread a channel group), Cout % 8 == 0, B (T + 2) <=
    65535 (the z pass's grid), T P <= 2^30; TMA zero-fills each tap's
    ragged last K block, Cout's last tile and a sample's last row tile.
    Cached: a request calls it thousands of times at a dozen shapes."""
    if (min(bsz, t, p, cin, cout) <= 0 or cin % 8 or cin > 8192 or cout % 8
            or bsz * (t + 2) > 65535 or t * p > 2 ** 30):
        raise ValueError(f"temporal conv kernels: need Cin % 8 == 0 (at "
                         f"most 8192), Cout % 8 == 0, B (T + 2) <= 65535 "
                         f"and T P <= 2^30; got B={bsz}, T={t}, P={p}, "
                         f"Cin={cin}, Cout={cout}")
    width = 160 if cout % 160 == 0 else 128
    col_tiles = -(-cout // width)
    for rows in (128, 64):
        tiles = bsz * -(-(t * p) // rows) * col_tiles
        if tiles >= sms:
            break
    return Plan(z=(bsz, t + 2, p, cin), rows=rows, width=width, tiles=tiles,
                grid=min(tiles, sms),
                sums=(bsz, t, _slots(t, p, rows), cout))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tc_temporal_conv.argtypes = [vp] * 11 + [i] * 10 + [vp]
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
    pl = plan(bsz, t, p, cin, cout, _launch.sm_count(dev))
    lib = _library()
    out = torch.empty((bsz, t, p, cout), dtype=bf, device=dev)
    zf = torch.empty(pl.z, dtype=bf, device=dev)
    # s1's and s2's partial sums in one buffer: one reduction over the slots
    sums = (torch.empty((2,) + pl.sums, dtype=f32, device=dev) if stats
            else None)
    err = lib.tc_temporal_conv(
        x.data_ptr(), w3.data_ptr(), bias.data_ptr(), _launch.ptr(a),
        _launch.ptr(b), _launch.ptr(res), _launch.ptr(scale), zf.data_ptr(),
        out.data_ptr(), *((sums[0].data_ptr(), sums[1].data_ptr()) if stats
                          else (None, None)), bsz, t,
        p, cin, cout, int(silu), pl.rows, pl.width, pl.grid, pl.sums[2],
        _launch.stream(x))
    _launch.raise_on_error(err, f"temporal conv (B={bsz}, T={t}, P={p}, "
                                f"C={cin}->{cout})")
    if stats:
        s1, s2 = sums.sum(3)
        return out, s1, s2
    return out


def _dispatch(x, w3, bias, a, b, res, scale, silu: bool, stats: bool):
    """The plain version for CPU tensors, the kernels for CUDA tensors (one
    call counts one launch of the TPU kernel's name)."""
    if _launch.on_cpu("temporal conv", x, w3, bias, a, b, res, scale):
        return _plain_tconv(x, w3, bias, a, b, res, scale, silu, stats)
    out = _launch_tconv(x, w3, bias, a, b, res, scale, silu, stats)
    LAUNCHES["_pallas_tconv"] += 1
    return out


def _pallas_tconv(x, w3, bias, a=None, b=None, res=None, scale=None,
                  silu: bool = False, stats: bool = False):
    """The wrapper named after the TPU kernel it replaces. x: (B, T, P,
    Cin); CPU tensors take the plain version, CUDA tensors the kernels;
    under autograd ``_TconvFunction``."""
    if silu and a is None:
        a = torch.ones(x.shape[0], x.shape[-1], device=x.device)
        b = torch.zeros_like(a)
    cdt = _launch.compute_dtype(x)  # CUDA autocast's dtype while it is on
    x, w3, bias = x.to(cdt), w3.to(cdt), bias.to(cdt)
    res = None if res is None else res.to(cdt)
    ops = (x, w3, bias, a, b, res, scale)
    if _launch.needs_grad(*ops):
        return _TconvFunction.apply(silu, stats, *ops)
    return _dispatch(*ops, silu, stats)


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
        """out_scale * conv(x) + residual (each optional), plain: the XLA
        form over x (B, T, *spatial, Cin)."""
        return _xla_tconv(x, taps(self.weight), self.bias, None, None,
                          residual, out_scale, False, False)

    def fused(self, x, affine, residual=None, out_scale=None,
              return_stats: bool = False):
        """silu(x * A + B) through this conv, with the fused epilogue;
        ``affine`` None: x itself, no SiLU (the JAX TemporalConv3 without a
        prologue)."""
        return temporal_conv3(x, self.weight, self.bias, affine,
                              silu=affine is not None, residual=residual,
                              out_scale=out_scale, return_stats=return_stats)
