"""Spatial convolutions on channels-last (N, H, W, C) tensors, and the
fused GroupNorm-affine + SiLU + 3x3 conv.

The modules keep torch's Conv2d parameters (``weight`` (O, I, kh, kw),
``bias``) so their state-dict names follow the upstream checkpoint, and run
``F.conv2d`` on the channels-last view. ``Conv2d`` stores its weight
channels-last, (O, kh, kw, I) in memory, from construction on (``to``,
``load_state_dict`` and in-place initialisation keep it): the layout the
fused conv's kernel reads, so it takes the parameter itself, no copy.

``gn_silu_conv3x3`` is the fused form of the UNet ResBlock's GN+SiLU+conv:

    z = silu(bf16(x * A + B))          (the "ref" cast point: the fp32
                                        affine rounds to x's dtype, then
                                        SiLU in fp32, rounded once)
    y = conv3x3(z) + bias + residual   (fp32, rounded once)

with per-image per-channel fp32 sums of the rounded y when asked (the next
GroupNorm's statistics). Its CUDA kernel (``csrc/gn_silu_conv3x3.cu``, a
direct implicit GEMM) runs at every shape, where the TPU package dispatched
its kernels only on measured allowlists. The TPU package has two Winograd
kernels for this one function, F(2x2) (ops/winograd.py::
winograd_gn_silu_conv3x3) and F(2x4) (``winograd24_gn_silu_conv3x3``, taken
first, on its own allowlist ``_TABLE24``); both are the TPU's way to the
function, and the CUDA kernel replaces both. ``gn_silu_conv3x3`` counts a
launch under the F(2x4) wrapper's name exactly where the TPU package takes
F(2x4) (``table_entry24``: the 576x1024 model's 36x64 640->640 convs), and
under the F(2x2) name everywhere else.

Four more of the JAX package's switches are read once, at import, into
module globals (tests set the globals): ``TC_WINOGRAD=0`` (``_WINOGRAD``)
empties both Winograd tables and ``TC_WINOGRAD24=0`` (``_WINOGRAD24``) the
F(2x4) one, so those shapes fall through to the rule below, as in the JAX
``_impl``; ``TC_PROLOGUE_DTYPE`` (``_PROLOGUE_DTYPE``: "ref", the default,
"f32" or "bf16") picks the prologue's cast point (ops/spatial_conv.py:
312-336): under "f32" every launch takes the kernel's fp32 cast point (the
SiLU in fp32, one rounding, as #15 always does), under "bf16" the JAX
package declines both Winograd kernels, so the tables name nothing and a
conv no kernel takes runs the plain route with (A, B) folded to bf16 and
the prologue in bf16; ``TC_STATS_SQ_BF16`` (``_STATS_SQ_BF16``, any
non-empty value) squares in bf16 in the plain route's sums. The backward
(``_xla_conv3x3``) follows the same prologue, as the JAX ``_fused_bwd``
differentiates ``_xla_impl`` under the same globals.

``TC_SPATIAL_CONV_PALLAS`` (read once, at import, as the JAX package reads
it: any non-empty value) adds the TPU package's im2col kernel
(spatial_conv.py::_pallas_fused_conv, #15) to that dispatch: where neither
Winograd table has the shape and its own rule ``_use_kernel`` (the VMEM
tiling of ``_pick_tiles``, copied here as a rule) admits it, a launch is
counted under #15's name and runs the same CUDA kernel with #15's prologue,
the SiLU in fp32 before the one rounding. ``spatial_conv3x3`` is that
dispatch as the JAX package's ``_impl`` takes it (the VAE's ResnetBlocks):
the kernel where a TPU kernel runs, else the plain formula in the compute
dtype (``F.conv2d``), where it runs XLA.

Under autograd the kernel runs inside ``_ConvFunction``: its forward (the
plain version on the CPU), the gradient of the XLA form ``_xla_conv3x3``
back, as the JAX package's custom_vjp differentiates ``_xla_impl``
whichever kernel ran. An affine of None is the identity (the training
branch's plain convs: z = x, ``silu`` False).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch

LAUNCHES: Dict[str, int] = {"winograd_gn_silu_conv3x3": 0,
                             "winograd24_gn_silu_conv3x3": 0,
                             "_pallas_fused_conv": 0}
_CIN_CHUNK = 32  # the kernel's Cin step (csrc/gn_silu_conv3x3.cu)
_MAX_WIDTH = 256  # csrc/gn_silu_conv3x3.cu kMaxWidth (the halo staging)

# the keys (H, W, Cin, Cout) of the TPU package's F(2x4) allowlist
# (tooncrafter_tpu/ops/winograd.py:366-369)
_TABLE24 = frozenset({(36, 64, 640, 640)})
# the keys of its F(2x2) allowlist (winograd.py:67-82)
_TABLE = frozenset({
    (20, 32, 640, 640), (20, 32, 1280, 640), (20, 32, 1920, 640),
    (10, 16, 1280, 1280), (10, 16, 1920, 1280), (10, 16, 2560, 1280),
    (36, 64, 640, 640), (18, 32, 1280, 1280), (18, 32, 1920, 1280),
    (18, 32, 2560, 1280)})
_SPATIAL_CONV_PALLAS = bool(os.environ.get("TC_SPATIAL_CONV_PALLAS"))
# tooncrafter_tpu/ops/winograd.py:51, 371 and spatial_conv.py:312, 318
_WINOGRAD = os.environ.get("TC_WINOGRAD", "1") != "0"
_WINOGRAD24 = os.environ.get("TC_WINOGRAD24", "1") != "0"
_PROLOGUE_DTYPE = os.environ.get("TC_PROLOGUE_DTYPE", "ref")
_STATS_SQ_BF16 = bool(os.environ.get("TC_STATS_SQ_BF16"))
_VMEM_BUDGET = 12 * 1024 * 1024


def conv2d_nhwc(x, weight, bias, stride=1, padding=0):
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over (N, H, W, C), its weight stored channels-last."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.weight.data = self.weight.data.contiguous(
            memory_format=torch.channels_last)

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.padding)


class Conv1x1(nn.Conv2d):
    """A 1x1 nn.Conv2d applied as a dense layer over the last axis."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class Conv1d1(nn.Conv1d):
    """A kernel-size-1 nn.Conv1d applied as a dense layer over the last
    axis (the UNet's init attention projections)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class Downsample(nn.Module):
    """Stride-2 3x3 conv; ``asymmetric`` pads (0, 1) on H and W and runs
    VALID (the VAE encoder), else symmetric padding 1 (the UNet)."""

    def __init__(self, channels: int, asymmetric: bool, name: str = "conv"):
        super().__init__()
        self.asymmetric = asymmetric
        self.name = name
        setattr(self, name, Conv2d(channels, channels, 3, stride=2,
                                   padding=0 if asymmetric else 1))

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return getattr(self, self.name)(x)


class Upsample(nn.Module):
    """Nearest 2x upsample followed by a 3x3 SAME conv (``conv``); with
    ``return_stats`` also the per-image sums of its output, each (N, C),
    which re-seed the decoder's stats chain (the JAX package takes them
    inline, ops/resize.py:117-122)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, return_stats: bool = False):
        from tooncrafter_tpu_torch.ops.norms import output_sums

        y = self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2,
                                                                     dim=2))
        return (y, *output_sums(y, (1, 2))) if return_stats else y


# ---------------------------------------------------------------------------
# the fused GN-affine + SiLU + 3x3 conv
# ---------------------------------------------------------------------------

def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def table_entry24(h: int, w: int, cin: int, cout: int) -> bool:
    """Would the TPU package take its F(2x4) kernel here? Its allowlist and
    the tiling's geometry gates (2-row, 4-column output tiles)."""
    return (_WINOGRAD24 and _WINOGRAD and h % 2 == 0 and w % 4 == 0
            and (h, w, cin, cout) in _TABLE24)


def table_entry(h: int, w: int, cin: int, cout: int) -> bool:
    """Would the TPU package take its F(2x2) kernel here?"""
    return _WINOGRAD and (h, w, cin, cout) in _TABLE


# the TPU package's rule for its im2col kernel (spatial_conv.py:43-114):
# the VMEM bytes of a (ck, ct) channel tiling, and the tiling it picks

def _vmem_bytes(hw: int, ck: int, cout_t: int, pad_hw: int, wimg: int,
                hb: int, k_tiled: bool, w_dbl: bool) -> int:
    ebytes = 2
    x_blk = 2 * hw * ck * ebytes
    zp = pad_hw * ck * ebytes
    out = 2 * hw * cout_t * ebytes
    w = (2 if w_dbl else 1) * 9 * ck * cout_t * ebytes
    band = hb * wimg * 9 * ck * ebytes
    acc = hw * cout_t * 4 if k_tiled else hb * wimg * cout_t * 4
    return x_blk + zp + acc + out + w + band


def _band_rows(w: int) -> int:
    return max(1, -(-256 // w))


def _pick_tiles(h: int, w: int, cin: int, cout: int):
    hw, pad_hw, hb = h * w, (h + 2) * (w + 2), _band_rows(w)
    for ck in (cin, 1024, 512, 256, 128):
        if ck > cin or cin % ck or (ck != cin and ck % 128):
            continue
        for ct in (cout, 512, 384, 256, 128):
            if ct <= cout and cout % ct == 0 \
                    and (ct == cout or ct % 128 == 0) \
                    and _vmem_bytes(
                        hw, ck, ct, pad_hw, w, hb, ck != cin,
                        ck != cin or ct != cout) <= _VMEM_BUDGET:
                return ck, ct
    return 0, 0


def _use_kernel(h: int, w: int, cin: int, cout: int) -> bool:
    """Would the TPU package take _pallas_fused_conv here (switch on)?"""
    if not _SPATIAL_CONV_PALLAS:
        return False
    if h < 8 or w < 8 or cin % 64 or cout % 64:
        return False
    return _pick_tiles(h, w, cin, cout)[0] > 0


def tpu_kernel(h: int, w: int, cin: int, cout: int) -> Optional[str]:
    """The TPU kernel the JAX package's ``_impl`` (spatial_conv.py:371-395)
    takes at this shape, by name, or None where it runs XLA. The "bf16"
    prologue declines both Winograd kernels."""
    if _PROLOGUE_DTYPE != "bf16":
        if table_entry24(h, w, cin, cout):
            return "winograd24_gn_silu_conv3x3"
        if table_entry(h, w, cin, cout):
            return "winograd_gn_silu_conv3x3"
    if _use_kernel(h, w, cin, cout):
        return "_pallas_fused_conv"
    return None


def conv_kernel_name(h: int, w: int, cin: int, cout: int) -> Optional[str]:
    """The TPU kernel a launch at this shape is counted under: the one the
    JAX package takes, and F(2x2)'s where it runs XLA (the port's kernel
    runs at every UNet conv), except under the "bf16" prologue, which no
    kernel computes: None there (the plain route)."""
    name = tpu_kernel(h, w, cin, cout)
    if name is None and _PROLOGUE_DTYPE != "bf16":
        return "winograd_gn_silu_conv3x3"
    return name


def round_first(name: str) -> bool:
    """The cast point a launch under ``name`` takes: the "ref" point (the
    affine rounds before the SiLU) where the JAX kernel of that name takes
    it, else the fp32 point (one rounding after the SiLU): #15 always,
    every kernel under TC_PROLOGUE_DTYPE=f32."""
    return name != "_pallas_fused_conv" and _PROLOGUE_DTYPE == "ref"


def _prologue(x, a, b, silu: bool, cdt, round_first: bool = True):
    """silu(round(x * A + B)) at the "ref" cast point, the SiLU in fp32
    and rounded once, as the kernel does; rounds to ``cdt``. With
    round_first False, the fp32 cast point: one rounding after the SiLU
    (_pallas_fused_conv's prologue). ``a`` None: the identity affine."""
    if a is None:
        return (F.silu(x.float()) if silu else x).to(cdt)
    u = x.float() * a[:, None, None] + b[:, None, None]
    if round_first:
        u = u.to(cdt).float()
    return (F.silu(u) if silu else u).to(cdt)


def _plain_conv3x3(x, a, b, weight, bias, res, silu: bool, stats: bool,
                   cdt: Optional[torch.dtype] = None,
                   round_first: bool = True):
    """x: (N, H, W, Cin); a, b: (N, Cin) fp32 or None; weight (Cout, Cin,
    3, 3);
    res: (N, H, W, Cout) or None. The kernel's rounding points: z rounds
    to ``cdt`` (x's dtype unless given), y once to x's dtype."""
    z = _prologue(x, a, b, silu, x.dtype if cdt is None else cdt,
                  round_first).float()
    y = F.conv2d(z.permute(0, 3, 1, 2), weight.float(), bias.float(),
                 padding=1).permute(0, 2, 3, 1)
    if res is not None:
        y = y + res.float()
    y = y.to(x.dtype)
    if stats:
        yf = y.float()
        return y, yf.sum((1, 2)), yf.square().sum((1, 2))
    return y


LIBRARY = ("gn_silu_conv3x3", ("gn_silu_conv3x3.cu",))
_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tc_gn_silu_conv3x3.argtypes = [vp] * 9 + [i] * 8 + [vp]
    lib.tc_gn_silu_conv3x3.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def _launch_conv(x, a, b, w9, bias, res, silu: bool, stats: bool,
                 round_first: bool = True):
    n, h, w, cin = x.shape
    cout = w9.shape[0]
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _launch.check("x", x, (n, h, w, cin), bf, dev)
    _launch.check("affine A", a, (n, cin), f32, dev)
    _launch.check("affine B", b, (n, cin), f32, dev)
    _launch.check("weight", w9, (cout, 3, 3, cin), bf, dev)
    _launch.check("bias", bias, (cout,), bf, dev)
    if res is not None:
        _launch.check("residual", res, (n, h, w, cout), bf, dev)
    if cin % _CIN_CHUNK or cout % 8 or w > _MAX_WIDTH:
        raise ValueError(f"GN+SiLU+3x3 conv kernel: needs Cin % {_CIN_CHUNK}"
                         f" == 0, Cout % 8 == 0 and W <= {_MAX_WIDTH}; got "
                         f"Cin={cin}, Cout={cout}, W={w}")
    out = torch.empty((n, h, w, cout), dtype=bf, device=dev)
    bm, n_tiles = conv_tiles(h, w)
    sums = ([torch.empty((n, n_tiles, cout), dtype=f32, device=dev)
             for _ in range(2)] if stats else [None, None])
    err = _library().tc_gn_silu_conv3x3(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w9.data_ptr(),
        bias.data_ptr(), _launch.ptr(res), out.data_ptr(),
        _launch.ptr(sums[0]), _launch.ptr(sums[1]), n, h, w, cin, cout,
        int(silu), bm, int(round_first), _launch.stream(x))
    _launch.raise_on_error(err, f"GN+SiLU+3x3 conv (N={n}, {h}x{w}, "
                                f"C={cin}->{cout})")
    if stats:
        return out, sums[0].sum(1), sums[1].sum(1)
    return out


def conv_tiles(h: int, w: int):
    """(BM, tiles) of the conv kernel for (h, w) images: BM pixels a block
    (BM / 64 wgmma warpgroups), so its sums come per tile as (N, tiles,
    Cout), which the wrapper adds over the tiles."""
    bm = _launch.pixel_tile(h * w)
    return bm, -(-(h * w) // bm)


def kernel_weight(weight):
    """nn.Conv2d weight (Cout, Cin, 3, 3) as (Cout, 3, 3, Cin): K = 9 * Cin,
    tap-major, as the kernel reads it. A view of a channels-last weight (as
    ``Conv2d`` keeps it); a copy of any other."""
    return weight.permute(0, 2, 3, 1).contiguous()


class _ConvFunction(torch.autograd.Function):
    """The kernel's forward with the gradient of the XLA form
    ``_xla_conv3x3``, as the JAX package's ``_fused`` custom_vjp
    differentiates ``_xla_impl`` whichever kernel ran
    (tooncrafter_tpu/ops/spatial_conv.py:397-423): x, A, B, the weight, the
    bias and the residual, through y and (with stats) the per-channel
    sums."""

    @staticmethod
    def forward(ctx, name, silu, stats, x, a, b, weight, bias, res):
        ops = (x, a, b, weight, bias, res)
        ctx.save_for_backward(*ops)
        ctx.flags = (silu, stats)
        ctx.set_materialize_grads(False)
        return _dispatch(name, *ops, silu, stats)

    @staticmethod
    def backward(ctx, *grads):
        return _launch.recompute_grads(ctx, grads, _xla_conv3x3, 3)


def _dispatch(name: str, x, a, b, weight, bias, res, silu: bool,
              stats: bool):
    """The plain version for CPU tensors, the kernel for CUDA tensors, its
    launch counted under ``name``, at ``round_first(name)``'s cast point."""
    rf = round_first(name)
    if _launch.on_cpu("GN+SiLU+3x3 conv", x, a, b, weight, bias, res):
        return _plain_conv3x3(x, a, b, weight, bias, res, silu, stats,
                              round_first=rf)
    if a is None:
        a = torch.ones(x.shape[0], x.shape[-1], device=x.device)
        b = torch.zeros_like(a)
    out = _launch_conv(x, a, b, kernel_weight(weight), bias, res, silu, stats,
                       **({} if rf else {"round_first": False}))
    LAUNCHES[name] += 1
    return out


def _conv(name: str, x, a, b, weight, bias, res, silu: bool, stats: bool):
    """In CUDA autocast's dtype while it is on; under autograd through
    ``_ConvFunction``."""
    cdt = _launch.compute_dtype(x)
    x, weight, bias = x.to(cdt), weight.to(cdt), bias.to(cdt)
    res = None if res is None else res.to(cdt)
    ops = (x, a, b, weight, bias, res)
    if _launch.needs_grad(*ops):
        return _ConvFunction.apply(name, silu, stats, *ops)
    return _dispatch(name, *ops, silu, stats)


def winograd_gn_silu_conv3x3(x, a, b, weight, bias, res=None,
                             silu: bool = True, stats: bool = False):
    """The wrapper named after the TPU kernel it replaces (the function,
    not the Winograd algorithm). weight: nn.Conv2d's (Cout, Cin, 3, 3)."""
    return _conv("winograd_gn_silu_conv3x3", x, a, b, weight, bias, res,
                 silu, stats)


def winograd24_gn_silu_conv3x3(x, a, b, weight, bias, res=None,
                               silu: bool = True, stats: bool = False):
    """The same function and kernel, named after the TPU package's F(2x4)
    kernel (tooncrafter_tpu/ops/winograd.py:390)."""
    return _conv("winograd24_gn_silu_conv3x3", x, a, b, weight, bias, res,
                 silu, stats)


def gn_silu_conv3x3(x, affine, conv: nn.Conv2d, residual=None,
                    return_stats: bool = False):
    """conv3x3(silu(x * A + B)) + bias (+ residual) with ``conv``'s
    parameters; with return_stats also per-channel sums (s1, s2), each
    (N, Cout), of the output over (H, W)."""
    n, h, w, cin = x.shape
    name = conv_kernel_name(h, w, cin, conv.weight.shape[0])
    if name is None:
        return _xla_conv3x3(x, affine[0], affine[1], conv.weight, conv.bias,
                            residual, True, return_stats)
    return _conv(name, x, affine[0], affine[1], conv.weight, conv.bias,
                 residual, True, return_stats)


def _pallas_fused_conv(x, a, b, weight, bias, res=None, silu: bool = True,
                       stats: bool = False):
    """The same kernel, named after the TPU package's im2col kernel
    (tooncrafter_tpu/ops/spatial_conv.py:117), with its prologue: the SiLU
    in fp32, one rounding."""
    return _conv("_pallas_fused_conv", x, a, b, weight, bias, res, silu,
                 stats)


def _apply_prologue(x, a, b, silu: bool, cdt):
    """The JAX ``_apply_prologue`` (spatial_conv.py:322-336) at
    TC_PROLOGUE_DTYPE's cast point, in ``cdt``: "ref" and "f32" as
    ``_prologue`` rounds them; "bf16" (for a ``cdt`` other than fp32) folds
    (A, B) to ``cdt`` and runs the affine and the SiLU there, each step
    rounded, the sigmoid as 1 / (1 + exp(-z)) (as XLA lowers a bf16
    logistic)."""
    if _PROLOGUE_DTYPE == "bf16" and cdt != torch.float32 and a is not None:
        z = (x.to(cdt) * a.to(cdt)[:, None, None]
             + b.to(cdt)[:, None, None])
        return z * (1.0 / (1.0 + torch.exp(-z))) if silu else z
    return _prologue(x, a, b, silu, cdt, _PROLOGUE_DTYPE == "ref")


def _xla_conv3x3(x, a, b, weight, bias, res, silu: bool, stats: bool):
    """The JAX package's XLA form (``_xla_impl``) in the compute dtype: the
    prologue at TC_PROLOGUE_DTYPE's cast point, F.conv2d with its bias, +
    res; the sums with y squared in fp32, or in y's dtype under
    TC_STATS_SQ_BF16; ``a`` None: the identity affine."""
    cdt = _launch.compute_dtype(x)
    z = _apply_prologue(x, a, b, silu, cdt)
    y = conv2d_nhwc(z, weight.to(cdt), bias.to(cdt), padding=1)
    if res is not None:
        y = y + res.to(cdt)
    if stats:
        yf = y.float()
        sq = y.square().float() if _STATS_SQ_BF16 else yf.square()
        return y, yf.sum((1, 2)), sq.sum((1, 2))
    return y


def spatial_conv3x3(x, affine, conv: nn.Conv2d, residual=None,
                    return_stats: bool = False, silu: bool = True):
    """conv3x3(silu(x * A + B)) + bias (+ residual) dispatched as the JAX
    package's ``_impl``: a kernel where it takes a TPU kernel, the plain
    formula where it runs XLA. ``affine`` None: the identity (the JAX
    ``SpatialConv3x3`` without a prologue passes ones and zeros)."""
    n, h, w, cin = x.shape
    a, b = (None, None) if affine is None else affine
    name = tpu_kernel(h, w, cin, conv.weight.shape[0])
    if name is None:
        return _xla_conv3x3(x, a, b, conv.weight, conv.bias, residual, silu,
                            return_stats)
    return _conv(name, x, a, b, conv.weight, conv.bias, residual, silu,
                 return_stats)
