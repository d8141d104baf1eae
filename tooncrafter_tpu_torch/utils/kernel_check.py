"""The fused kernels (GEGLU feed-forward, temporal conv, GN+SiLU+3x3 conv,
temporal attention pair) against their plain versions on the card, at the
shapes the 320x512 path gives them (``fused_cases``) and at the 576x1024
path's most-launched shapes (``fused_cases_1024``), and the kernels of the
JAX package's opt-in switches (the single-stage temporal attention, the
T-attention core, the im2col-named conv, the one-pass GroupNorm) at the
switched 320x512 path's (``switched_cases``), and the kernels that no
model reaches, driven through their op functions (``op_cases``: the dual
cross-attention at the 512 UNet's attn2 shapes, the per-channel sums at its
GroupNorm inputs, the ones-column flash at #2's and the 1024 attn1 shapes):
the cases, the bounds, the times and the least time the card could take.
``chip_smoke.py`` phase 2 runs every case; the mutation tests in
``tests/test_torch_cuda_kernels.py`` run them against broken builds.

Times. ``ms`` is the kernel's; ``plain_ms`` its plain version's on the same
bf16 operands, which computes in fp32 (TF32 off) to state the kernel's
rounding, so it is a reference and not what the port ran before the kernel;
``chain_ms`` is that: the unfused module chain in bf16 (cuBLAS / cuDNN in
bf16, fp32 statistics), as the model ran it before the kernel existed;
``library_ms`` one PyTorch call for the same function where there is one.

Bounds. The reference is the plain version run in fp32 on the same
bf16-valued operands, rounding the kernel's intermediates to bf16 where the
kernel does (the FF's LayerNorm output and gated product m, the convs'
activated input z), so that only the kernel's last roundings and its
summation order separate the two. The output is held to
``flash_attention.error_bounds`` of that reference: at most 2 bf16 ulps of
max|ref| anywhere, and a mean error at most 4x the mean error of rounding
the reference itself to bf16. The per-channel sums are held against the
sums of the kernel's own output, taken by torch in fp32: within
STATS_REL of the sum of |y| (s1) or of y^2 (s2), a margin for summation
order only; #18's sums of its input the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tooncrafter_tpu_torch.ops import attention as attn
from tooncrafter_tpu_torch.ops import cross_attention as ca
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import stats as st
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops import temporal_conv as tc

# the card's published peaks (H100 SXM, dense, at a 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
STATS_REL = 1e-5

MODULES = (fa, ff, tc, sc, ta, fn, ca, st)
SOURCES = {name: "tooncrafter_tpu_torch/csrc/" + mod.LIBRARY[1][0]
           for mod in MODULES for name in mod.LAUNCHES}
SOURCES["_flash_bwd_bh"] = ("tooncrafter_tpu_torch/csrc/"
                            + fa.BWD_LIBRARY[1][0])
SOURCES["_ptc_kernel_call"] = ("tooncrafter_tpu_torch/csrc/"
                               + ta.PTC_LIBRARY[1][0])
# the libraries, each built by one nvcc: every module's, the backward's and
# the T-attention core's
LIBRARIES = dict([mod.LIBRARY for mod in MODULES]
                 + [fa.BWD_LIBRARY, ta.PTC_LIBRARY])
REPLACES = {
    "_flash_mh_packed": "tooncrafter_tpu/ops/flash_attention.py:605",
    "_flash_mh": "tooncrafter_tpu/ops/flash_attention.py:414",
    "_flash_bh_with_lse": "tooncrafter_tpu/ops/flash_attention.py:695",
    "_flash_bh_single": "tooncrafter_tpu/ops/flash_attention.py:313",
    "_pallas_ff": "tooncrafter_tpu/ops/fused_ff.py:205",
    "_pallas_ff_streamed": "tooncrafter_tpu/ops/fused_ff.py:275",
    "_pallas_tconv": "tooncrafter_tpu/ops/temporal_conv.py:68",
    "winograd_gn_silu_conv3x3": "tooncrafter_tpu/ops/winograd.py:129",
    "winograd24_gn_silu_conv3x3": "tooncrafter_tpu/ops/winograd.py:390",
    "_fused_tpair_call": "tooncrafter_tpu/ops/temporal_attention.py:379",
    "_flash_bwd_bh": "tooncrafter_tpu/ops/flash_attention.py:126",
    "_fused_tattn_call": "tooncrafter_tpu/ops/temporal_attention.py:243",
    "_ptc_kernel_call": "tooncrafter_tpu/ops/temporal_attention.py:89",
    "_pallas_fused_conv": "tooncrafter_tpu/ops/spatial_conv.py:117",
    "_pallas_gn": "tooncrafter_tpu/ops/fused_norms.py:88",
    "_flash_mh_ones": "tooncrafter_tpu/ops/flash_attention.py:474",
    "_dual_kernel_call": "tooncrafter_tpu/ops/cross_attention.py:81",
    "_pallas_sums": "tooncrafter_tpu/ops/stats.py:55",
}


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for mod in MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for mod in MODULES:
        mod.reset_launch_counts()


def build_all() -> Dict[str, float]:
    """Build every kernel library, one nvcc each, all at once; bind them.
    Returns the build seconds per library."""
    from tooncrafter_tpu_torch.ops import _build

    _build.build(LIBRARIES)
    for mod in MODULES:
        mod._library()
    fa._bwd_library()
    ta._ptc_library()
    return {name: _build.BUILD_SECONDS[name] for name in LIBRARIES}


@contextlib.contextmanager
def fp32_reference():
    """Full fp32 products (no TF32) for the references and library calls."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float,
          peak: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """(least ms on the card, what bounds it): each input read once and
    each output written once at the memory rate, against the operations at
    ``peak`` (the bf16 tensor-core rate unless given)."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


@dataclasses.dataclass
class Case:
    name: str                        # the TPU kernel (and its counter)
    label: str
    kernel: Callable[[], Sequence[torch.Tensor]]    # (y, [s1, s2])
    reference: Callable[[], torch.Tensor]           # fp32 y
    plain: Callable[[], object]      # the plain version on bf16 operands
    chain: Callable[[], object]      # the unfused module chain in bf16
    library: Optional[Callable[[], object]]
    flops: float
    nbytes: float
    reps: Tuple[int, int]            # timing reps of kernel, plain/library
    peak: float = PEAK_BF16_FLOPS    # the rate ``flops`` runs at


def _stats_error(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                 axes: Tuple[int, ...]) -> Tuple[float, bool]:
    yf = y.float()
    ref1, ref2 = yf.sum(axes), yf.square().sum(axes)
    e1 = (s1 - ref1).abs().max().item()
    e2 = (s2 - ref2).abs().max().item()
    ok = (e1 <= STATS_REL * yf.abs().sum(axes).max().item()
          and e2 <= STATS_REL * ref2.max().item())
    return max(e1, e2), ok


def run_case(case: Case, stats_axes: Optional[Tuple[int, ...]] = None,
             timed: bool = True) -> dict:
    """One launch checked against the reference (and its sums against its
    own output), then timed. Returns the numbers and ``ok``."""
    before = launch_counts()[case.name]
    got = case.kernel()
    if launch_counts()[case.name] != before + 1:
        raise SystemExit(f"{case.label} did not launch {case.name}")
    with fp32_reference():
        ref = case.reference()
    torch.cuda.synchronize()
    if isinstance(ref, tuple):
        row = _sums_row(got, ref)
    else:
        row = _output_row(got, ref, stats_axes)
    del got, ref
    if timed:
        reps, plain_reps = case.reps
        row["ms"] = cuda_ms(case.kernel, reps)
        row["plain_ms"] = cuda_ms(case.plain, plain_reps)
        row["chain_ms"] = cuda_ms(case.chain, plain_reps)
        with fp32_reference():
            row["library_ms"] = (None if case.library is None
                                 else cuda_ms(case.library, reps))
    row["bound_ms"], row["bound_by"] = bound(case.flops, case.nbytes,
                                             case.peak)
    return row


def _sums_row(got, ref) -> dict:
    """#18's (s1, s2) against the fp32 sums of its input (s1, s2, sum |x|):
    each within STATS_REL of sum |x| (s1) or of s2."""
    (s1, s2), (r1, r2, a1) = got, ref
    tiny = torch.finfo(torch.float32).tiny
    e1, e2 = (s1 - r1).abs(), (s2 - r2).abs()
    rel = max((e1 / a1.clamp_min(tiny)).max().item(),
              (e2 / r2.clamp_min(tiny)).max().item())
    ok = (rel <= STATS_REL and bool(torch.isfinite(s1).all().item())
          and bool(torch.isfinite(s2).all().item()))
    return {"max_abs_err": max(e1.max().item(), e2.max().item()),
            "rel_err": rel, "ok": ok}


def _output_row(got, ref, stats_axes) -> dict:
    y = got[0].float()
    err = (y - ref).abs()
    mx, mean = err.max().item(), err.mean().item()
    max_bound, mean_bound = fa.error_bounds(ref)
    ok = (mx <= max_bound and mean <= mean_bound
          and bool(torch.isfinite(y).all().item()))
    row = {"max_abs_err": mx, "max_bound": max_bound, "mean_abs_err": mean,
           "mean_bound": mean_bound, "ref_abs_max": ref.abs().max().item()}
    if len(got) == 3:
        row["stats_err"], stats_ok = _stats_error(got[0], got[1], got[2],
                                                  stats_axes)
        ok = ok and stats_ok
    row["ok"] = ok
    return row


def line(case: Case, row: dict) -> str:
    if "rel_err" in row:
        s = (f"{case.name} {case.label}: max_abs_err="
             f"{row['max_abs_err']:.3e}, largest error relative to sum |x| "
             f"(s1) or s2: {row['rel_err']:.3e} (bound {STATS_REL:.0e})")
    else:
        s = (f"{case.name} {case.label}: max_abs_err={row['max_abs_err']:.3e} "
             f"(bound {row['max_bound']:.3e}) mean_abs_err="
             f"{row['mean_abs_err']:.3e} (bound {row['mean_bound']:.3e}, "
             f"|ref| max {row['ref_abs_max']:.3e})")
    if "stats_err" in row:
        s += f" stats_err={row['stats_err']:.3e}"
    if "ms" in row:
        lib = row["library_ms"]
        s += (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"chain_ms={row['chain_ms']:.4f} "
              f"library_ms={'none' if lib is None else f'{lib:.4f}'}")
    s += f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
    return s + (" ok" if row["ok"] else " FAIL")


# ---------------------------------------------------------------------------
# the cases at the 320x512 path's shapes (UNet: 2 CFG branches x 16 frames)
# ---------------------------------------------------------------------------

def _rnd(gen, dev, *shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
    t = torch.randn(*shape, device=dev, generator=gen) * scale + offset
    return t.to(dtype)


def _activated(x, a, b, round_first: bool):
    """silu(x * A + B) in bf16 from (N, ..., C) x and (N, C) A, B, as the
    unfused chain's GroupNorm + SiLU produced it."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    u = x.float() * a.reshape(shape) + b.reshape(shape)
    if round_first:
        return F.silu(u.to(x.dtype))
    return F.silu(u).to(x.dtype)


def _chain_ff(x, w1, b1, w2, b2, lw, lb):
    h, g = F.linear(norms.layer_norm(x, lw, lb, 1e-5), w1, b1).chunk(2, -1)
    return F.linear(h * F.gelu(g), w2, b2) + x


def _chain_tconv(x, w3, bias, a, b, res, scale, stats):
    z = _activated(x, a, b, False)
    y = F.linear(z, w3[:, 1], bias)
    y[:, 1:] += F.linear(z[:, :-1], w3[:, 0])
    y[:, :-1] += F.linear(z[:, 1:], w3[:, 2])
    if scale is not None:
        y = y * scale.to(y.dtype)
    if res is not None:
        y = y + res
    return (y,) + tc._frame_sums(y) if stats else y


def _chain_conv(x, a, b, weight, bias, res):
    y = sc.conv2d_nhwc(_activated(x, a, b, True), weight, bias,
                       padding=1) + res
    return (y,) + norms.channel_sums(y)


def _chain_tpair(x, stages, heads):
    for ln_w, ln_b, wq, wk, wv, wo, bo in stages:
        z = norms.layer_norm(x, ln_w, ln_b, 1e-5).unsqueeze(3)
        o = attn.temporal_attention_inplace(
            F.linear(z, wq), F.linear(z, wk), F.linear(z, wv), heads=heads)
        x = F.linear(o.squeeze(3), wo, bo) + x
    return x


# (label, N tokens, C): the transformer blocks' FF at each UNet level; the
# mid block's is the streamed kernel's call with the fewest tokens
FF_512 = (("ds1", 81920, 320), ("ds2", 20480, 640), ("ds4", 5120, 1280),
          ("init_attn", 81920, 512), ("mid", 1280, 1280))
FF_1024 = (("1024 ds1", 294912, 320), ("1024 ds2", 73728, 640),
           ("1024 ds4", 18432, 1280), ("1024 mid", 4608, 1280))


def ff_cases(dev, gen, shapes=FF_512) -> List[Case]:
    """LN prologue + GEGLU FF + residual, as the transformer blocks call it
    (``FeedForward.fused``)."""
    cases = []
    for label, n, c in shapes:
        d = 4 * c
        x = _rnd(gen, dev, n, c)
        w1 = _rnd(gen, dev, 2 * d, c, scale=c ** -0.5)
        b1 = _rnd(gen, dev, 2 * d, scale=0.1)
        w2 = _rnd(gen, dev, c, d, scale=d ** -0.5)
        b2 = _rnd(gen, dev, c, scale=0.1)
        lw = _rnd(gen, dev, c, scale=0.1, offset=1.0, dtype=torch.float32)
        lb = _rnd(gen, dev, c, scale=0.1, dtype=torch.float32)
        ops = (x, w1, b1, w2, b2, lw, lb)
        name = ff.kernel_name(n, c, d, c)
        cases.append(Case(
            name, f"{label} N={n} C={c} D={d} LN+residual",
            kernel=lambda o=ops: (ff.fused_geglu_ff(*o, 1e-5, True),),
            reference=lambda o=ops: ff._plain_ff(
                *(t.float() for t in o[:5]), o[5], o[6], 1e-5, True,
                cdt=torch.bfloat16),
            plain=lambda o=ops: ff._plain_ff(*o, 1e-5, True),
            chain=lambda o=ops: _chain_ff(*o),
            library=None,
            flops=2.0 * n * c * 2 * d + 2.0 * n * d * c,
            nbytes=2.0 * (2 * n * c + 3 * d * c + 2 * d + c) + 8.0 * c,
            reps=(10, 3)))
    return cases


# (label, (B, T, P, C), residual, out_scale, stats): every shape and
# epilogue a request launches #12 with (the launches by shape and epilogue
# are in tests/test_torch_selectors_switched.py and _1024.py, which
# tests/test_torch_temporal_conv.py holds these rows to). The UNet's
# TemporalConvBlocks (2 CFG branches): conv1-3 with the next norm's sums,
# conv4 with the block residual and the sums of the block's output (the
# stats chain); the decoder's TimeStacks: in_layers with sums, out_layers
# with the alpha merge as out_scale + residual and the merged output's sums
def _tconv_rows(prefix, unet, decoder):
    """The rows of one model: ``unet`` (level, P, C, a note on its stats
    row), ``decoder`` (P, C) from level 0 up."""
    rows = []
    for level, p, c, note in unet:
        rows += [(f"{prefix}UNet {level} affine+SiLU+stats{note}",
                  (2, 16, p, c), False, False, True),
                 (f"{prefix}UNet {level} affine+SiLU+residual+stats",
                  (2, 16, p, c), True, False, True)]
    for level, (p, c) in enumerate(decoder):
        rows += [(f"{prefix}decoder level {level} affine+SiLU+stats",
                  (1, 16, p, c), False, False, True),
                 (f"{prefix}decoder level {level} out_scale+residual+stats",
                  (1, 16, p, c), True, True, True)]
    return tuple(rows)


_STRADDLE = " (tiles straddle frames)"
TCONV_512 = _tconv_rows(
    "", (("ds1", 2560, 320, ""), ("ds2", 640, 640, ""),
         ("ds4", 160, 1280, _STRADDLE), ("ds8", 40, 1280, " (ragged P)")),
    ((163840, 128), (40960, 256), (10240, 512), (2560, 512)))
# the 576x1024 path (the decoder's level 0: 1.2e9 elements)
TCONV_1024 = _tconv_rows(
    "1024 ", (("ds1", 9216, 320, ""), ("ds2", 2304, 640, ""),
              ("ds4", 576, 1280, ""), ("ds8", 144, 1280, _STRADDLE)),
    ((589824, 128), (147456, 256), (36864, 512), (9216, 512)))


def tconv_bytes(bsz: int, t: int, p: int, c: int, res: bool,
                stats: bool) -> float:
    """Bytes #12 must move: x read and y written (and the residual read)
    in bf16, the taps and the bias, the affine, the per-frame sums."""
    n = bsz * t * p * c
    return (2.0 * (n * (2 + res) + 3 * c * c + c) + 8.0 * bsz * c
            + (8.0 * bsz * t * c if stats else 0))


def tconv_flops(bsz: int, t: int, p: int, c: int) -> float:
    """The products z taps need: three taps but at the clip's two ends."""
    return 2.0 * bsz * p * c * c * (3 * t - 2)


def tconv_cases(dev, gen, shapes=TCONV_512) -> List[Case]:
    """(B, T, P, C): the UNet TemporalConvBlock's convs (GN+SiLU prologue,
    stats, the block residual on conv4) and the decoder's TimeStack convs
    (in_layers with stats, out_layers with the alpha merge as out_scale +
    residual)."""
    cases = []
    for label, (bsz, t, p, c), res_on, scale_on, stats in shapes:
        x = _rnd(gen, dev, bsz, t, p, c)
        w3 = _rnd(gen, dev, c, 3, c, scale=(3 * c) ** -0.5)
        bias = _rnd(gen, dev, c, scale=0.1)
        a = _rnd(gen, dev, bsz, c, scale=0.2, offset=1.0,
                 dtype=torch.float32)
        # the folded shift B = beta - mean A at a GroupNorm's size: what a
        # zero frame of z must not be (silu(B) != 0)
        b = _rnd(gen, dev, bsz, c, scale=0.5, dtype=torch.float32)
        res = _rnd(gen, dev, bsz, t, p, c) if res_on else None
        scale = (torch.tensor(0.3, device=dev) if scale_on else None)
        ops = (x, w3, bias, a, b, res, scale)
        w5 = w3.permute(0, 2, 1)[..., None, None].contiguous(
            memory_format=torch.channels_last_3d)

        def library(o=ops, w5=w5):
            # the conv alone on the activated input: (B, C, T, P, 1) views
            # of the channels-last data, a (3, 1, 1) kernel
            z5 = o[0].permute(0, 3, 1, 2).unsqueeze(-1)
            return F.conv3d(z5, w5, o[2], padding=(1, 0, 0))

        cases.append(Case(
            "_pallas_tconv", f"{label} B={bsz} T={t} P={p} C={c}",
            kernel=lambda o=ops, s=stats: tc._pallas_tconv(
                *o, silu=True, stats=s) if s else (
                tc._pallas_tconv(*o, silu=True, stats=False),),
            reference=lambda o=ops: tc._plain_tconv(
                o[0].float(), o[1].float(), o[2].float(), o[3], o[4],
                None if o[5] is None else o[5].float(), o[6], True, False,
                cdt=torch.bfloat16),
            plain=lambda o=ops, s=stats: tc._plain_tconv(*o, True, s),
            chain=lambda o=ops, s=stats: _chain_tconv(*o, s),
            library=library,
            flops=tconv_flops(bsz, t, p, c),
            nbytes=tconv_bytes(bsz, t, p, c, res_on, stats),
            reps=(10, 3)))
    return cases


# (label, (N, H, W, Cin, Cout))
CONV_512 = (("ds1", (32, 40, 64, 320, 320)),
            ("ds2 skip concat", (32, 20, 32, 1920, 640)),
            ("ds4 skip concat (ragged tile)", (32, 10, 16, 2560, 1280)))
# ds2 of the 576x1024 model is the TPU package's F(2x4) shape (#14)
CONV_1024 = (("1024 ds2", (32, 36, 64, 640, 640)),
             ("1024 ds1", (32, 72, 128, 320, 320)))


@contextlib.contextmanager
def prologue_dtype(value: str):
    """``spatial_conv._PROLOGUE_DTYPE`` (TC_PROLOGUE_DTYPE) set to
    ``value`` for the calls inside."""
    saved, sc._PROLOGUE_DTYPE = sc._PROLOGUE_DTYPE, value
    try:
        yield
    finally:
        sc._PROLOGUE_DTYPE = saved


def _under(prologue, fn_):
    """fn_ with TC_PROLOGUE_DTYPE at ``prologue`` (None: as it is)."""
    if prologue is None:
        return fn_

    def call(*a, **k):
        with prologue_dtype(prologue):
            return fn_(*a, **k)
    return call


def conv_cases(dev, gen, shapes=CONV_512, name=None,
               prologue: Optional[str] = None) -> List[Case]:
    """(N, H, W, Cin -> Cout): the UNet ResBlocks' out_conv form (folded GN
    affine + SiLU prologue, bias, the skip as residual, sums for the next
    norm) at the input level, an output level's skip concat and the widest
    concat at 10x16 (a ragged pixel tile). Each case's wrapper is the one
    ``gn_silu_conv3x3`` takes at its shape, or ``name``'s (#15, with its
    prologue's cast point); ``prologue`` sets TC_PROLOGUE_DTYPE for the
    case (its name and cast point as the route takes them there)."""
    fixed = name
    cases = []
    for label, (n, h, w, cin, cout) in shapes:
        x = _rnd(gen, dev, n, h, w, cin)
        a = _rnd(gen, dev, n, cin, scale=0.2, offset=1.0,
                 dtype=torch.float32)
        b = _rnd(gen, dev, n, cin, scale=0.1, dtype=torch.float32)
        # channels-last, as the model's Conv2d keeps its weight
        weight = _rnd(gen, dev, cout, cin, 3, 3, scale=(9 * cin) ** -0.5
                      ).contiguous(memory_format=torch.channels_last)
        bias = _rnd(gen, dev, cout, scale=0.1)
        res = _rnd(gen, dev, n, h, w, cout)
        ops = (x, a, b, weight, bias, res)

        def library(o=ops):
            # the conv alone on the activated input, channels-last (cuDNN)
            return F.conv2d(o[0].permute(0, 3, 1, 2), o[3], o[4], padding=1)

        with prologue_dtype(prologue or sc._PROLOGUE_DTYPE):
            name = fixed or sc.conv_kernel_name(h, w, cin, cout)
            rf = sc.round_first(name)
        cast = "" if prologue is None else f", TC_PROLOGUE_DTYPE={prologue}"
        cases.append(Case(
            name, f"{label} N={n} {h}x{w} C={cin}->{cout} stats+residual"
            f"{cast}",
            kernel=_under(prologue, lambda o=ops, f=getattr(sc, name): f(
                *o, silu=True, stats=True)),
            reference=lambda o=ops, rf=rf: sc._plain_conv3x3(
                o[0].float(), o[1], o[2], o[3].float(), o[4].float(),
                o[5].float(), True, False, cdt=torch.bfloat16,
                round_first=rf),
            plain=lambda o=ops, rf=rf: sc._plain_conv3x3(
                *o, True, True, round_first=rf),
            chain=lambda o=ops: _chain_conv(*o),
            library=library,
            # only in-image taps: (3H - 2)(3W - 2) (pixel, tap) pairs
            flops=2.0 * n * (3 * h - 2) * (3 * w - 2) * cin * cout,
            nbytes=(2.0 * (n * h * w * (cin + 2 * cout) + 9 * cin * cout
                           + cout) + 8.0 * n * cin + 8.0 * n * cout),
            reps=(10, 3)))
    return cases


# (label, P, C): every shape a request launches the pair at (the launch
# tables of tests/test_torch_selectors_1024.py and _switched.py hold them
# to the models)
TPAIR_512 = (("ds1", 2560, 320), ("init_attn", 2560, 512), ("ds2", 640, 640),
             ("ds4", 160, 1280), ("mid 5x8", 40, 1280))
TPAIR_1024 = (("1024 ds1", 9216, 320), ("1024 ds2", 2304, 640),
              ("1024 ds4", 576, 1280), ("1024 mid 9x16", 144, 1280),
              ("1024 init_attn", 9216, 512))


def tpair_flops(n: int, t: int, c: int, stages: int = 2) -> float:
    """Per stage: the q, k, v and out projections, q k^T and p v over T."""
    return stages * (8.0 * n * c * c + 4.0 * n * t * c)


def tpair_bytes(n: int, c: int, stages: int = 2) -> float:
    """x read and the output written once; each stage's weights, biases
    and fp32 LayerNorm parameters."""
    return 2.0 * 2 * n * c + stages * (8.0 * c * c + 2.0 * c + 8.0 * c)


def tpair_cases(dev, gen, shapes=TPAIR_512, t: int = 16,
                bsz: int = 2) -> List[Case]:
    """(B, T, P, C): the temporal transformer blocks' attention pair at each
    UNet level, the init attention's 512-wide blocks, and the mid block (T
    frames: the UNet's 16 unless given; B clips: a CFG pair's two unless
    given)."""
    cases = []
    for label, p, c in shapes:
        heads = c // ta.HEAD_DIM
        x = _rnd(gen, dev, bsz, t, p, c)
        stages = tuple(
            (_rnd(gen, dev, c, scale=0.1, offset=1.0, dtype=torch.float32),
             _rnd(gen, dev, c, scale=0.1, dtype=torch.float32),
             *(_rnd(gen, dev, c, c, scale=c ** -0.5) for _ in range(4)),
             _rnd(gen, dev, c, scale=0.1)) for _ in range(2))
        ref_stages = tuple(tuple(w.float() for w in s) for s in stages)
        n = bsz * t * p
        cases.append(Case(
            "_fused_tpair_call", f"{label} B={bsz} T={t} P={p} C={c}",
            kernel=lambda x=x, s=stages, h=heads: (ta._fused_tpair_call(
                x, *s, h, 0.125),),
            reference=lambda x=x, s=ref_stages, h=heads: ta._plain_tpair(
                x.float(), *s, h, 0.125, 1e-5, cdt=torch.bfloat16),
            plain=lambda x=x, s=stages, h=heads: ta._plain_tpair(
                x, *s, h, 0.125, 1e-5),
            chain=lambda x=x, s=stages, h=heads: _chain_tpair(x, s, h),
            library=None,
            flops=tpair_flops(n, t, c),
            nbytes=tpair_bytes(n, c),
            reps=(10, 3)))
    return cases


# the temporal sub-block (#10) under TC_TATTN_PAIR=0: (label, P, C), the
# pair's shapes
TATTN_512 = (("ds1", 2560, 320), ("init_attn", 2560, 512), ("ds4", 160, 1280),
             ("ds2", 640, 640), ("mid 5x8", 40, 1280))


def tattn_cases(dev, gen, shapes=TATTN_512) -> List[Case]:
    """One temporal self-attention sub-block (B, T, P, C) at the UNet's
    levels: the single-stage kernel (#10); its chain is one stage of the
    pair's unfused bf16 chain."""
    cases = []
    for label, p, c in shapes:
        bsz, t, heads = 2, 16, c // ta.HEAD_DIM
        x = _rnd(gen, dev, bsz, t, p, c)
        stage = (_rnd(gen, dev, c, scale=0.1, offset=1.0, dtype=torch.float32),
                 _rnd(gen, dev, c, scale=0.1, dtype=torch.float32),
                 *(_rnd(gen, dev, c, c, scale=c ** -0.5) for _ in range(4)),
                 _rnd(gen, dev, c, scale=0.1))
        ref_stage = tuple(w.float() for w in stage)
        n = bsz * t * p
        cases.append(Case(
            "_fused_tattn_call", f"{label} B={bsz} T={t} P={p} C={c}",
            kernel=lambda x=x, s=stage, h=heads: (ta._fused_tattn_call(
                x, s, h, 0.125),),
            reference=lambda x=x, s=ref_stage, h=heads: ta._plain_stage(
                x.float(), s, h, 0.125, 1e-5, torch.bfloat16),
            plain=lambda x=x, s=stage, h=heads: ta._plain_stage(
                x, s, h, 0.125, 1e-5, x.dtype),
            chain=lambda x=x, s=stage, h=heads: _chain_tpair(x, (s,), h),
            library=None,
            flops=tpair_flops(n, t, c, 1),
            nbytes=tpair_bytes(n, c, 1),
            reps=(10, 3)))
    return cases


# the T-attention core (#11): (label, T, P, inner, heads)
PTC_512 = (("ds1", 16, 2560, 320, 5), ("ds4", 16, 160, 1280, 20),
           ("T=8 d=128", 8, 640, 640, 5))


def ptc_cases(dev, gen, shapes=PTC_512) -> List[Case]:
    """(B, T, P, heads * d) q, k, v as slices of one packed projection (the
    strides the UNet's ``temporal_ptc`` gives them); library: SDPA over the
    (B, P, heads) batch."""
    cases = []
    for label, t, p, inner, heads in shapes:
        bsz, d = 2, inner // heads
        scale = d ** -0.5
        qkv = _rnd(gen, dev, bsz, t, p, 3 * inner)
        q, k, v = qkv.chunk(3, dim=-1)

        def split(z, h=heads):  # (B, T, P, inner) -> (B, P, heads, T, d)
            return z.unflatten(-1, (h, -1)).permute(0, 2, 3, 1, 4)

        n = bsz * t * p
        cases.append(Case(
            "_ptc_kernel_call", f"{label} B={bsz} T={t} P={p} inner={inner}"
            f" heads={heads} (strided q, k, v)",
            kernel=lambda q=q, k=k, v=v, h=heads, sc_=scale: (
                ta._ptc_kernel_call(q, k, v, h, sc_),),
            reference=lambda q=q, k=k, v=v, h=heads, sc_=scale: ta._xla_ptc(
                q.float(), k.float(), v.float(), h, sc_, cdt=torch.bfloat16),
            plain=lambda q=q, k=k, v=v, h=heads, sc_=scale: ta._xla_ptc(
                q, k, v, h, sc_),
            chain=lambda q=q, k=k, v=v, h=heads: attn.temporal_attention_inplace(
                q.unsqueeze(3), k.unsqueeze(3), v.unsqueeze(3), heads=h),
            library=lambda q=q, k=k, v=v, sc_=scale: (
                F.scaled_dot_product_attention(split(q), split(k), split(v),
                                               scale=sc_)),
            flops=4.0 * n * t * inner,
            nbytes=2.0 * 4 * n * inner,
            reps=(10, 3)))
    return cases


# the im2col conv's shapes (#15) on the switched 512 path: (label, (N, H, W,
# Cin, Cout)): the UNet's 40x64 ResBlock convs and the VAE's 40x64 level
CONV15_512 = (("UNet ds1", (32, 40, 64, 320, 320)),
              ("VAE 40x64 (decoder, 16 frames)", (16, 40, 64, 512, 512)))

# the one-pass GroupNorm (#16) at every (N, HW, C, SiLU) the switched 512
# path launches it with, and its launches in one training UNet forward (the
# encoder's norm_out: once an encoded frame, in inference), read off the
# model on the meta device (tests/test_torch_row_sums.py):
# (label, (N, HW, C), silu, launches)
GN_512 = (
    ("train ResBlock ds1", (32, 2560, 320), True, 8),
    ("train spatial norm ds1", (32, 2560, 320), False, 5),
    ("train ResBlock ds1 skip concat 640", (32, 2560, 640), True, 2),
    ("train ResBlock ds2 in", (32, 640, 320), True, 1),
    ("train ResBlock ds2", (32, 640, 640), True, 6),
    ("train spatial norm ds2", (32, 640, 640), False, 5),
    ("train ResBlock ds2 skip concat 960", (32, 640, 960), True, 1),
    ("train ResBlock ds2 skip concat 1280", (32, 640, 1280), True, 1),
    ("train ResBlock ds2 skip concat 1920", (32, 640, 1920), True, 1),
    ("train ResBlock ds4 in", (32, 160, 640), True, 1),
    ("train ResBlock ds4", (32, 160, 1280), True, 6),
    ("train spatial norm ds4", (32, 160, 1280), False, 5),
    ("train ResBlock ds4 skip concat 1920", (32, 160, 1920), True, 1),
    ("train ResBlock ds4 skip concat 2560", (32, 160, 2560), True, 2),
    ("train ResBlock ds8", (32, 40, 1280), True, 11),
    ("train spatial norm ds8", (32, 40, 1280), False, 1),
    ("train ResBlock ds8 skip concat 2560", (32, 40, 2560), True, 3),
    ("train temporal norm ds8", (2, 640, 1280), True, 28),
    ("train temporal norm ds8 without SiLU", (2, 640, 1280), False, 1),
    ("encoder norm_out", (1, 2560, 512), True, 0),
)
# samples that no cluster holds in shared memory, which stream through a
# ring twice (``fused_norms.plan``'s L2 branch): the 4 MiB edge of the
# dispatch rule, and the decoder's level 0, past it (no path launches #16
# there)
GN_L2 = (("4 MiB edge (L2 branch)", (2, 16384, 128), True, 0),
         ("decoder level 0 (past the 4 MiB rule)", (16, 163840, 128), True,
          0))
GN_RAMP = 4.0  # x's mean runs from -GN_RAMP to GN_RAMP down the rows


def gn_input(dev, gen, n: int, hw: int, c: int) -> torch.Tensor:
    """bf16 x (N, HW, C): N(0.5, 2) plus a mean that ramps down the rows,
    as activations vary across an image, so that the cluster's blocks (row
    slices) hold different sums and a fold that mixes them up shows."""
    ramp = torch.linspace(-GN_RAMP, GN_RAMP, hw, device=dev)[:, None]
    return (torch.randn(n, hw, c, device=dev, generator=gen) * 2.0 + 0.5
            + ramp).to(torch.bfloat16)


def gn_cases(dev, gen, shapes=GN_512 + GN_L2) -> List[Case]:
    """GroupNorm (+SiLU) over (N, HW, C) at the switched 512 path's sites
    and the L2 branch; chain: ``norms.group_norm`` (+ SiLU) in bf16, the
    port's route before; library: ATen's ``F.group_norm`` on the
    channels-first view, the whole function without SiLU and the core op
    with it (as ``F.conv2d`` is for the GN+SiLU+3x3 conv)."""
    cases = []
    for label, (n, hw, c), silu, *_ in shapes:
        x = gn_input(dev, gen, n, hw, c)
        w = _rnd(gen, dev, c, scale=0.2, offset=1.0, dtype=torch.float32)
        b = _rnd(gen, dev, c, scale=0.2, dtype=torch.float32)
        w16, b16 = w.to(x.dtype), b.to(x.dtype)  # ATen's wants x's dtype
        cases.append(Case(
            "_pallas_gn", f"{label} N={n} HW={hw} C={c} silu={silu}",
            kernel=lambda x=x, w=w, b=b, s=silu: (
                fn._pallas_gn(x, w, b, 32, 1e-5, s),),
            reference=lambda x=x, w=w, b=b, s=silu: fn._plain_gn(
                x.float(), w, b, 32, 1e-5, s, cdt=torch.bfloat16),
            plain=lambda x=x, w=w, b=b, s=silu: fn._plain_gn(
                x, w, b, 32, 1e-5, s),
            chain=lambda x=x, w=w, b=b, s=silu: norms.group_norm(
                x, w, b, 32, 1e-5, s),
            library=lambda x=x, w=w16, b=b16: F.group_norm(
                x.transpose(1, 2), 32, w, b, 1e-5),
            flops=12.0 * n * hw * c,
            nbytes=2.0 * 2 * n * hw * c + 8.0 * c,
            reps=(10, 3)))
    return cases


def switched_cases(dev, seed: int = 0
                   ) -> List[Tuple[Case, Optional[tuple]]]:
    """The kernels of the three opt-in switches at the switched 512 path's
    shapes: #10, #11, #15 and #16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: List[Tuple[Case, Optional[tuple]]] = []
    out += [(c, None) for c in tattn_cases(dev, gen)]
    out += [(c, None) for c in ptc_cases(dev, gen)]
    out += [(c, (1, 2)) for c in conv_cases(dev, gen, CONV15_512,
                                             "_pallas_fused_conv")]
    out += [(c, None) for c in gn_cases(dev, gen)]
    return out


def fused_cases(dev, seed: int = 0, ff=FF_512, tconv=TCONV_512,
                conv=CONV_512, tpair=TPAIR_512
                ) -> List[Tuple[Case, Optional[tuple]]]:
    """Every fused-kernel case with the axes its sums span (None: no sums),
    at the 320x512 path's shapes unless given others."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: List[Tuple[Case, Optional[tuple]]] = []
    out += [(c, None) for c in ff_cases(dev, gen, ff)]
    out += [(c, (2,) if "stats" in c.label else None)
            for c in tconv_cases(dev, gen, tconv)]
    out += [(c, (1, 2)) for c in conv_cases(dev, gen, conv)]
    out += [(c, None) for c in tpair_cases(dev, gen, tpair)]
    return out


# The stem under CFG stem sharing (``ToonCrafter.denoise`` passes
# cfg_groups=2): the init attention and the first ResBlock run on one clip's
# 16 frames (tests/test_torch_selectors_stem.py holds these rows to the
# launches of both models): the init attention's pair and FF, the ResBlock's
# two convs and its TemporalConvBlock's four temporal convs
STEM_512 = dict(ff=(("stem init_attn", 40960, 512),),
                tconv=(("stem UNet ds1 affine+SiLU+stats", (1, 16, 2560, 320),
                        False, False, True),
                       ("stem UNet ds1 affine+SiLU+residual+stats",
                        (1, 16, 2560, 320), True, False, True)),
                conv=(("stem ds1", (16, 40, 64, 320, 320)),),
                tpair=(("stem init_attn", 2560, 512),))
STEM_1024 = dict(ff=(("1024 stem init_attn", 147456, 512),),
                 tconv=(("1024 stem UNet ds1 affine+SiLU+stats",
                         (1, 16, 9216, 320), False, False, True),
                        ("1024 stem UNet ds1 affine+SiLU+residual+stats",
                         (1, 16, 9216, 320), True, False, True)),
                 conv=(("1024 stem ds1", (16, 72, 128, 320, 320)),),
                 tpair=(("1024 stem init_attn", 9216, 512),))
# TC_PROLOGUE_DTYPE=f32: #13's and #14's names at the fp32 cast point
F32_CONV = CONV_512 + CONV_1024[:1]


def chain_cases(dev, seed: int = 0) -> List[Tuple[Case, Optional[tuple]]]:
    """The launches the stats chain, the stem sharing and the conv switches
    add: the stem's B/n-row shapes of both models, and #13 and #14 at the
    fp32 cast point (TC_PROLOGUE_DTYPE=f32); the temporal convs' residual
    and merge epilogues with sums are rows of TCONV_512 and TCONV_1024."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: List[Tuple[Case, Optional[tuple]]] = []
    for stem in (STEM_512, STEM_1024):
        out += [(c, None) for c in ff_cases(dev, gen, stem["ff"])]
        out += [(c, (2,)) for c in tconv_cases(dev, gen, stem["tconv"])]
        out += [(c, (1, 2)) for c in conv_cases(dev, gen, stem["conv"])]
        out += [(c, None) for c in tpair_cases(dev, gen, stem["tpair"],
                                                bsz=1)]
    out += [(c, (1, 2)) for c in conv_cases(dev, gen, F32_CONV,
                                             prologue="f32")]
    return out


def fused_cases_1024(dev, seed: int = 0
                     ) -> List[Tuple[Case, Optional[tuple]]]:
    """The fused kernels at the 576x1024 path's most-launched shapes (2 CFG
    branches x 16 frames of a 72x128 latent): the F(2x4)-named conv (#14)
    first, then #13, the FF at each UNet level and the 9x16 mid block
    (streamed at C = 1280), the temporal conv (every shape and epilogue a
    request launches it with) and the pair at each level and the mid
    block."""
    return fused_cases(dev, seed, FF_1024, TCONV_1024, CONV_1024, TPAIR_1024)


# ---------------------------------------------------------------------------
# tensor parallelism (parallel/tensor.py): a rank's share of the heads or of
# the FF width, with the partial out-GEMM (the fp32 accumulator, no bias,
# no residual, no rounding)
# ---------------------------------------------------------------------------

# (label, N tokens, C, local D, whole D): the FF at a model rank's half of D
TP_FF = (("TP ds1", 81920, 320, 640, 1280),
         ("TP ds4", 5120, 1280, 2560, 5120))
# (label, P, C, local heads, whole heads): #10 at a rank's heads of the 512
# model's ds1 (5 heads: 3 + 2 at n_model = 2)
TP_TATTN = (("TP ds1 3 of 5 heads", 2560, 320, 3, 5),
            ("TP ds1 2 of 5 heads", 2560, 320, 2, 5))


def tp_cases(dev, seed: int = 0) -> List[Tuple[Case, Optional[tuple]]]:
    """The partial calls of the FF (#7/#8, named by the whole call's D) and
    of the single temporal stage (#10) at a model rank's local shapes;
    their plain versions return the same fp32 accumulator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: List[Tuple[Case, Optional[tuple]]] = []
    for label, n, c, d, whole in TP_FF:
        x = _rnd(gen, dev, n, c)
        w1 = _rnd(gen, dev, 2 * d, c, scale=c ** -0.5)
        b1 = _rnd(gen, dev, 2 * d, scale=0.1)
        w2 = _rnd(gen, dev, c, d, scale=whole ** -0.5)
        lw = _rnd(gen, dev, c, scale=0.1, offset=1.0, dtype=torch.float32)
        lb = _rnd(gen, dev, c, scale=0.1, dtype=torch.float32)
        ops = (x, w1, b1, w2, None, lw, lb)
        out.append((Case(
            ff.kernel_name(n, c, whole, c),
            f"{label} N={n} C={c} D={d} of {whole} LN, partial (fp32 out)",
            kernel=lambda o=ops, w=whole: (ff.fused_geglu_ff(
                *o, 1e-5, partial=True, name_d=w),),
            reference=lambda o=ops: ff._plain_ff(
                *(t.float() for t in o[:4]), None, o[5], o[6], 1e-5, False,
                cdt=torch.bfloat16, partial=True),
            plain=lambda o=ops: ff._plain_ff(*o, 1e-5, False, partial=True),
            chain=lambda o=ops: F.linear(
                (lambda h, g: h * F.gelu(g))(*F.linear(norms.layer_norm(
                    o[0], o[5], o[6], 1e-5), o[1], o[2]).chunk(2, -1)),
                o[3]).float(),
            library=None,
            flops=2.0 * n * c * 2 * d + 2.0 * n * d * c,
            nbytes=2.0 * (n * c + 3 * d * c + 2 * d) + 4.0 * n * c + 8.0 * c,
            reps=(10, 3)), None))
    for label, p, c, heads, whole in TP_TATTN:
        bsz, t, inner = 2, 16, heads * ta.HEAD_DIM
        x = _rnd(gen, dev, bsz, t, p, c)
        stage = (_rnd(gen, dev, c, scale=0.1, offset=1.0, dtype=torch.float32),
                 _rnd(gen, dev, c, scale=0.1, dtype=torch.float32),
                 *(_rnd(gen, dev, inner, c, scale=c ** -0.5)
                   for _ in range(3)),
                 _rnd(gen, dev, c, inner, scale=c ** -0.5), None)
        ref_stage = tuple(None if w is None else w.float() for w in stage)
        n = bsz * t * p
        out.append((Case(
            "_fused_tattn_call",
            f"{label} B={bsz} T={t} P={p} C={c} inner={inner}, partial "
            f"(fp32 out)",
            kernel=lambda x=x, s=stage, h=heads: (ta._fused_tattn_call(
                x, s, h, 0.125, partial=True),),
            reference=lambda x=x, s=ref_stage, h=heads: ta._plain_stage(
                x.float(), s, h, 0.125, 1e-5, torch.bfloat16, partial=True),
            plain=lambda x=x, s=stage, h=heads: ta._plain_stage(
                x, s, h, 0.125, 1e-5, x.dtype, partial=True),
            chain=lambda x=x, s=stage, h=heads: F.linear(
                attn.temporal_attention_inplace(
                    *(F.linear(norms.layer_norm(x, s[0], s[1], 1e-5
                                                ).unsqueeze(3), w)
                      for w in s[2:5]), heads=h).squeeze(3), s[5]).float(),
            library=None,
            flops=8.0 * n * c * inner + 4.0 * n * t * inner,
            nbytes=2.0 * n * c + 4.0 * n * c + 8.0 * inner * c + 8.0 * c,
            reps=(10, 3)), None))
    return out


# ---------------------------------------------------------------------------
# the kernels no model reaches, through their op functions: dual
# cross-attention (#17), per-channel sums (#18), the ones-column flash (#5)
# ---------------------------------------------------------------------------

# the 512 UNet's attn2 sites (2 CFG branches x 16 frames; 77 text and 16
# image tokens): (label, Sq, C)
ATTN2_512 = (("ds1", 2560, 320), ("ds2", 640, 640), ("ds4", 160, 1280))
DUAL_S_IP = 0.73  # the JAX test's gate


def dual_operands(dev, gen, sq: int, c: int, b: int = 32, lt: int = 77,
                  li: int = 16):
    """bf16 q (B, Sq, C), kt, vt (B, Lt, C), ki, vi (B, Li, C)."""
    return tuple(_rnd(gen, dev, b, n, c) for n in (sq, lt, lt, li, li))


def _sdpa_heads(t, heads: int):
    return t.unflatten(-1, (heads, -1)).transpose(1, 2)


def dual_cases(dev, gen, shapes=ATTN2_512) -> List[Case]:
    """#17 through its wrapper; chain: the off route (two attentions and a
    bf16 combine, ``_xla_dual``); library: two SDPA calls and the add."""
    cases = []
    for label, sq, c in shapes:
        heads = c // ca.HEAD_DIM
        ops = dual_operands(dev, gen, sq, c)
        b, lt, li = ops[0].shape[0], ops[1].shape[1], ops[3].shape[1]

        def library(o=ops, h=heads):
            q = _sdpa_heads(o[0], h)
            out = F.scaled_dot_product_attention(
                q, _sdpa_heads(o[1], h), _sdpa_heads(o[2], h), scale=0.125)
            return out + DUAL_S_IP * F.scaled_dot_product_attention(
                q, _sdpa_heads(o[3], h), _sdpa_heads(o[4], h), scale=0.125)

        cases.append(Case(
            "_dual_kernel_call", f"attn2 {label} B={b} Sq={sq} C={c} "
            f"Lt={lt} Li={li}",
            kernel=lambda o=ops, h=heads: (ca._dual_kernel_call(
                *o, DUAL_S_IP, h, 0.125),),
            reference=lambda o=ops, h=heads: ca._plain_dual(
                *(t.float() for t in o), DUAL_S_IP, h, 0.125,
                cdt=torch.bfloat16),
            plain=lambda o=ops, h=heads: ca._plain_dual(*o, DUAL_S_IP, h,
                                                        0.125),
            chain=lambda o=ops, h=heads: ca._xla_dual(*o, DUAL_S_IP, h,
                                                      0.125),
            library=library,
            flops=4.0 * b * sq * (lt + li) * c,
            nbytes=2.0 * (2 * b * sq * c + 2 * b * (lt + li) * c) + 4.0,
            reps=(20, 3)))
    return cases


# the 512 UNet's GroupNorm inputs that ``ops/stats._use_kernel`` takes,
# with their count in one UNet call (2 CFG branches x 16 frames; read off
# the model on the meta device by tests/test_torch_stats.py), then the JAX
# test's shape: (label, (N, S, C), count)
STATS_512 = (
    ("ResBlock / transformer norm ds1", (32, 2560, 320), 13),
    ("temporal conv norm ds8", (2, 640, 1280), 29),
    ("temporal conv norm ds1", (2, 40960, 320), 26),
    ("temporal conv norm ds2", (2, 10240, 640), 25),
    ("temporal conv norm ds4", (2, 2560, 1280), 25),
    ("ResBlock / transformer norm ds2", (32, 640, 640), 11),
    ("ResBlock skip concat ds1", (32, 2560, 640), 2),
    ("ResBlock skip concat ds1, 960", (32, 2560, 960), 1),
    ("ResBlock ds2 in", (32, 640, 320), 1),
    ("ResBlock skip concat ds2, 960", (32, 640, 960), 1),
    ("ResBlock skip concat ds2, 1280", (32, 640, 1280), 1),
    ("ResBlock skip concat ds2, 1920", (32, 640, 1920), 1),
    ("JAX test (2, 16, 16, 128)", (2, 256, 128), 0),
)


def sums_reference(x):
    """(s1, s2, sum |x|) of x (N, S, C) in fp32."""
    xf = x.float()
    return xf.sum(1), xf.square().sum(1), xf.abs().sum(1)


def stats_cases(dev, gen, shapes=STATS_512) -> List[Case]:
    """#18 through its wrapper on bf16 (N, S, C); plain and chain: the fp32
    sums in torch (``ops/norms.channel_sums``, the models' route); no one
    PyTorch call returns both sums."""
    cases = []
    for label, (n, s, c), count in shapes:
        x = _rnd(gen, dev, n, s, c, scale=2.0, offset=0.5)
        cases.append(Case(
            "_pallas_sums", f"{label} N={n} S={s} C={c} ({count} a UNet "
            f"call)",
            kernel=lambda x=x: st._pallas_sums(x),
            reference=lambda x=x: sums_reference(x),
            plain=lambda x=x: st._plain_sums(x),
            chain=lambda x=x: (x.float().sum(1), x.float().square().sum(1)),
            library=None,
            flops=3.0 * n * s * c,
            nbytes=2.0 * n * s * c + 8.0 * n * c,
            reps=(20, 5), peak=PEAK_FP32_FLOPS))
    return cases


# #5 at #2's most-launched 512 shape (attn1 ds4) and at the two shapes of
# tools/bench_attn1_1024.py: (label, B, S, C, reps)
ONES_SHAPES = (("512 ds4 attn1 (#2's shape)", 32, 160, 1280, (50, 10)),
               ("1024 ds2 attn1", 32, 2304, 640, (20, 3)),
               ("1024 ds1 attn1", 32, 9216, 320, (5, 1)))


def _chain_attention(q, k, v, heads: int):
    """``ops.attention.dot_product_attention`` (fp32 logits, bf16 p and PV)
    on as many images at a time as keep the logits within the plain
    version's 2^28 scores: the unfused route at a bounded footprint."""
    images = max(1, fa._PLAIN_SCORES // (heads * q.shape[1] * k.shape[1]))
    split = lambda t: t.unflatten(-1, (heads, -1))
    return torch.cat([attn.dot_product_attention(
        split(q[i:i + images]), split(k[i:i + images]),
        split(v[i:i + images]), scale=0.125).flatten(2)
        for i in range(0, q.shape[0], images)])


def ones_cases(dev, gen, shapes=ONES_SHAPES) -> List[Case]:
    """#5 on slices of a packed projection, as attn1 gives them; library:
    SDPA."""
    cases = []
    for label, b, s, c, reps in shapes:
        heads = c // 64
        qkv = _rnd(gen, dev, b, s, 3 * c)
        ops = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
        cases.append(Case(
            "_flash_mh_ones", f"{label} B={b} S={s} C={c} heads={heads}",
            kernel=lambda o=ops, h=heads: (fa._flash_mh_ones(*o, h, 0.125),),
            reference=lambda o=ops, h=heads: fa._plain_mh_ones(
                *(t.float() for t in o), h, 0.125, cdt=torch.bfloat16),
            plain=lambda o=ops, h=heads: fa._plain_mh_ones(*o, h, 0.125),
            chain=lambda o=ops, h=heads: _chain_attention(*o, h),
            library=lambda o=ops, h=heads: F.scaled_dot_product_attention(
                *(_sdpa_heads(t, h) for t in o), scale=0.125),
            flops=4.0 * b * s * s * c,
            nbytes=2.0 * 4 * b * s * c,
            reps=reps))
    return cases


def dual_pin_inputs():
    """#17's cast point: every branch exact before the combine. Row r's
    text attention is one-hot on key r % 64 (q, kt one-hot at 32: a score
    gap of 184 in log2 units, so every other p is exactly 0); its image
    attention is one-hot on key r % 64 where r % 64 < 16, else uniform over
    the 16 keys (all scores 0). V entries are multiples of 1/128 in [-1, 1]
    (bf16-exact), so every sum, the division by l (1 or 16) and s_ip = 0.75
    times it are exact in fp32, with more bits than bf16 keeps: the one
    rounding after the combine is the only one, and rounding each branch
    first moves many outputs. Returns fp32 (bf16-exact) q, kt, vt, ki, vi
    (B = 2, Sq = 128, C = 128), s_ip and heads."""
    b, sq, heads, d = 2, 128, 2, 64
    c = heads * d
    rng = np.random.default_rng(6)
    eye = np.eye(d, dtype=np.float32)
    q = 32 * np.tile(eye[np.arange(sq) % d], (b, 1, heads))
    kt = np.zeros((b, 77, c), np.float32)
    kt[:, :d] = 32 * np.tile(eye, (1, heads))
    ki = np.zeros((b, 16, c), np.float32)
    ki[:, :16] = 32 * np.tile(eye[:16], (1, heads))
    vt, vi = (rng.integers(-128, 129, size=(b, n, c)).astype(np.float32)
              / 128 for n in (77, 16))
    return [q.reshape(b, sq, c), kt, vt, ki, vi], 0.75, heads


def ones_pin_inputs():
    """#5's cast point: V = 1; row r's one top key is key r % 64 (q and k
    one-hot), every other key scores 0, and the scale puts p = exp(-scale)
    = 0.5 + 0.9 * 2^-9 there, which bf16 rounds down to 0.5. l = sum of
    bf16(p) (#5's) gives exactly 1.0; the unrounded sum (#2's) gives
    32.5 / 32.61 -> 0.99609375 in bf16. Returns fp32 q, k, v (B = 2, S =
    128, C = 128), heads and the scale."""
    b, s, heads, d = 2, 128, 2, 64
    eye = np.eye(d, dtype=np.float32)
    q = np.tile(eye[np.arange(s) % d], (b, 1, heads)).reshape(b, s, heads * d)
    k = np.zeros((b, s, heads * d), np.float32)
    k[:, :d] = np.tile(eye, (1, heads))
    v = np.ones((b, s, heads * d), np.float32)
    return q, k, v, heads, float(np.log(2.0) - np.log1p(0.9 * 2.0 ** -8))


def op_cases(dev, seed: int = 0) -> List[Tuple[Case, Optional[tuple]]]:
    """#17, #18 and #5 at the shapes their op functions are driven with."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: List[Tuple[Case, Optional[tuple]]] = []
    for make in (dual_cases, stats_cases, ones_cases):
        out += [(c, None) for c in make(dev, gen)]
    return out


# ---------------------------------------------------------------------------
# the flash-attention backward (#6) at the training path's attn1 shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BwdCase:
    label: str
    qkv: torch.Tensor     # (B, S, 3C) bf16, the packed projection
    out: torch.Tensor     # (B, S, C) bf16, the forward kernel's output
    lse: torch.Tensor     # (B*H, S) fp32, the forward kernel's lse
    dout: torch.Tensor    # (B, S, C) bf16
    heads: int
    reps: Tuple[int, int]
    scale: float = 0.125


def bwd_cases(dev, seed: int = 0, shapes=None) -> List[BwdCase]:
    """The UNet's attn1 in a training step of the 512 model (B = 2 clips x
    16 frames): ds1 (S = 2560, 5 heads), ds2 (640, 10) and ds4 (160, 20),
    d = 64; the forward kernel makes out and lse."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for label, b, s, heads, reps in shapes or (
            ("ds1", 32, 2560, 5, (10, 2)), ("ds2", 32, 640, 10, (20, 5)),
            ("ds4", 32, 160, 20, (50, 10))):
        c = 64 * heads
        qkv = _rnd(gen, dev, b, s, 3 * c)
        out = torch.empty((b, s, heads, 64), dtype=torch.bfloat16,
                          device=dev)
        lse = torch.empty((b * heads, s), dtype=torch.float32, device=dev)
        fa._launch(*fa._packed_views(qkv, heads), out, lse, 0.125)
        cases.append(BwdCase(f"{label} B={b} S={s} C={c} heads={heads}",
                             qkv, out.flatten(2), lse,
                             _rnd(gen, dev, b, s, c), heads, reps))
    return cases


def _fold(x, heads: int):
    return fa._fold_heads(x.float(), heads)


def bwd_reference(case: BwdCase):
    """``_plain_bwd_bh`` in fp32 on the case's bf16 operands: (dq, dk, dv),
    each (B*H, S, 64)."""
    c = case.out.shape[-1]
    q, k, v = (_fold(case.qkv[..., i * c:(i + 1) * c], case.heads)
               for i in range(3))
    return fa._plain_bwd_bh(q, k, v, _fold(case.dout, case.heads),
                            case.scale, _fold(case.out, case.heads),
                            case.lse)


def _sdpa_ms(case: BwdCase, reps: int) -> float:
    """F.scaled_dot_product_attention's backward at the case's shape:
    forward + backward minus forward (the library yardstick only)."""
    c = case.out.shape[-1]
    q, k, v = (case.qkv[..., i * c:(i + 1) * c].unflatten(-1, (
        case.heads, 64)).transpose(1, 2).detach().requires_grad_()
        for i in range(3))
    do = case.dout.unflatten(-1, (case.heads, 64)).transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=case.scale)

    def fwd_bwd():
        torch.autograd.backward(fwd(), do)
    return cuda_ms(fwd_bwd, reps) - cuda_ms(fwd, reps)


def run_bwd_case(case: BwdCase, timed: bool = True) -> dict:
    """One launch of #6 on the packed projection, each gradient held to
    ``flash_attention.grad_error_bounds`` of the fp32 reference, then
    timed against the plain version and SDPA's backward."""
    before = fa.LAUNCHES["_flash_bwd_bh"]

    def kernel():
        return fa.flash_bwd_packed(case.qkv, case.out, case.lse, case.dout,
                                   case.heads, case.scale)
    dqkv = kernel()
    if fa.LAUNCHES["_flash_bwd_bh"] != before + 1:
        raise SystemExit(f"{case.label} did not launch _flash_bwd_bh")
    with fp32_reference():
        refs = bwd_reference(case)
    torch.cuda.synchronize()
    c = case.out.shape[-1]
    row = {"ok": True, "max_abs_err": 0.0, "parts": []}
    for i, (name, ref) in enumerate(zip(("dq", "dk", "dv"), refs)):
        got = _fold(dqkv[..., i * c:(i + 1) * c], case.heads)
        err = (got - ref).abs()
        mx, mean = err.max().item(), err.mean().item()
        max_bound, mean_bound = fa.grad_error_bounds(ref)
        ok = (mx <= max_bound and mean <= mean_bound
              and bool(torch.isfinite(got).all().item()))
        row["parts"].append((name, mx, max_bound, mean, mean_bound,
                             ref.abs().max().item(), ok))
        row["ok"] = row["ok"] and ok
        row["max_abs_err"] = max(row["max_abs_err"], mx)
    del refs, dqkv
    b, s = case.qkv.shape[:2]
    bh, d = b * case.heads, 64
    if timed:
        reps, plain_reps = case.reps
        row["ms"] = cuda_ms(kernel, reps)
        with fp32_reference():
            row["plain_ms"] = cuda_ms(lambda: bwd_reference(case),
                                      plain_reps)
        row["library_ms"] = _sdpa_ms(case, reps)
    # five S x S x 64 products per (b, h); q, k, v, out, dout and the lse
    # read once, dq, dk, dv written once
    row["bound_ms"], row["bound_by"] = bound(
        10.0 * bh * s * s * d, 2.0 * 8 * bh * s * d + 4.0 * bh * s)
    return row


def bwd_line(case: BwdCase, row: dict) -> str:
    s = f"_flash_bwd_bh {case.label}:"
    for name, mx, mxb, mean, meanb, top, _ in row["parts"]:
        s += (f" {name} max_abs_err={mx:.3e} (bound {mxb:.3e}) "
              f"mean_abs_err={mean:.3e} (bound {meanb:.3e}, |ref| max "
              f"{top:.3e});")
    if "ms" in row:
        s += (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f}")
    s += f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
    return s + (" ok" if row["ok"] else " FAIL")


# ---------------------------------------------------------------------------
# the training branch's convs under autograd: the 3x3 conv with no prologue
# (#13, #14 through ``_ConvFunction``) and the temporal conv (#12 through
# ``_TconvFunction``) at the 512 (2 clips x 16 frames) and 1024 (1 clip)
# training steps' shapes
# ---------------------------------------------------------------------------

# (label, wrapper, (N, H, W, Cin, Cout)): the shapes a TPU kernel takes
TRAIN_CONV = (
    ("512 ds2", "winograd_gn_silu_conv3x3", (32, 20, 32, 640, 640)),
    ("512 ds4 skip concat (ragged tile)", "winograd_gn_silu_conv3x3",
     (32, 10, 16, 2560, 1280)),
    ("1024 ds2", "winograd24_gn_silu_conv3x3", (16, 36, 64, 640, 640)),
    ("1024 ds4", "winograd_gn_silu_conv3x3", (16, 18, 32, 1280, 1280)))
# (label, (B, T, P, C)): every shape at the 1280-wide levels runs where the
# JAX package runs XLA
TRAIN_TCONV = (("512 ds1", (2, 16, 2560, 320)),
               ("512 ds4 (tiles straddle frames)", (2, 16, 160, 1280)),
               ("1024 ds1", (1, 16, 9216, 320)),
               ("1024 ds8 (tiles straddle frames)", (1, 16, 144, 1280)))


@dataclasses.dataclass
class GradCase:
    name: str                        # the TPU kernel (and its counter)
    label: str
    fn: Callable[..., torch.Tensor]      # the wrapper under autograd
    plain: Callable[..., torch.Tensor]   # the plain version, fp32 leaves
    inputs: Tuple[torch.Tensor, ...]     # bf16: x, weight, bias
    reps: int = 5


def train_grad_cases(dev, seed: int = 0) -> List[GradCase]:
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for label, name, (n, h, w, cin, cout) in TRAIN_CONV:
        weight = _rnd(gen, dev, cout, cin, 3, 3, scale=(9 * cin) ** -0.5
                      ).contiguous(memory_format=torch.channels_last)
        cases.append(GradCase(
            name, f"{label} N={n} {h}x{w} C={cin}->{cout} no prologue",
            fn=lambda x, wt, bias, f=getattr(sc, name): f(
                x, None, None, wt, bias, silu=False),
            plain=lambda x, wt, bias: sc._plain_conv3x3(
                x, None, None, wt, bias, None, False, False),
            inputs=(_rnd(gen, dev, n, h, w, cin), weight,
                    _rnd(gen, dev, cout, scale=0.1))))
    for label, (bsz, t, p, c) in TRAIN_TCONV:
        cases.append(GradCase(
            "_pallas_tconv", f"{label} B={bsz} T={t} P={p} C={c} no prologue",
            fn=lambda x, w3, bias: tc._pallas_tconv(x, w3, bias),
            plain=lambda x, w3, bias: tc._plain_tconv(
                x, w3, bias, None, None, None, None, False, False),
            inputs=(_rnd(gen, dev, bsz, t, p, c),
                    _rnd(gen, dev, c, 3, c, scale=(3 * c) ** -0.5),
                    _rnd(gen, dev, c, scale=0.1))))
    return cases


def run_grad_case(case: GradCase, timed: bool = True) -> dict:
    """One forward launch through the wrapper's Function and its backward
    on a bf16 cotangent. The kernel's y is held to
    ``flash_attention.error_bounds`` (phase 2's forward bound) of the plain
    version in fp32 (TF32 off) on the same bf16 values; x's, the weight's
    and the bias's gradients to ``grad_error_bounds`` of that version's
    autograd. Then the Function's forward + backward timed against the
    plain version's."""
    leaves = [t.detach().requires_grad_() for t in case.inputs]
    before = launch_counts()[case.name]
    y = case.fn(*leaves)
    if launch_counts()[case.name] != before + 1:
        raise SystemExit(f"{case.label} did not launch {case.name}")
    gen = torch.Generator(device=y.device).manual_seed(1)
    gy = _rnd(gen, y.device, *y.shape)
    torch.autograd.backward(y, gy)
    with fp32_reference():
        ref = [t.detach().float().requires_grad_() for t in case.inputs]
        y_ref = case.plain(*ref)
        torch.autograd.backward(y_ref, gy.float())
    torch.cuda.synchronize()
    row = {"ok": True, "max_abs_err": 0.0, "parts": []}
    parts = [("y", y.detach(), y_ref.detach(), fa.error_bounds)]
    parts += [(part, got.grad, want.grad, fa.grad_error_bounds)
              for part, got, want in zip(("dx", "dw", "db"), leaves, ref)]
    for part, got, want, bounds in parts:
        err = (got.float() - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        max_bound, mean_bound = bounds(want)
        ok = (mx <= max_bound and mean <= mean_bound
              and bool(torch.isfinite(got).all().item()))
        row["parts"].append((part, mx, max_bound, mean, mean_bound,
                             want.abs().max().item(), ok))
        row["ok"] = row["ok"] and ok
        row["max_abs_err"] = max(row["max_abs_err"], mx)
    del y, y_ref, ref, parts
    if timed:
        def step(fn, ts, g):
            torch.autograd.backward(fn(*ts), g)
        row["ms"] = cuda_ms(lambda: step(case.fn, leaves, gy), case.reps)
        with fp32_reference():
            ref = [t.detach().float().requires_grad_() for t in case.inputs]
            row["plain_ms"] = cuda_ms(
                lambda: step(case.plain, ref, gy.float()), case.reps)
    return row


def grad_line(case: GradCase, row: dict) -> str:
    s = f"{case.name} forward and backward {case.label}:"
    for part, mx, mxb, mean, meanb, top, _ in row["parts"]:
        s += (f" {part} max_abs_err={mx:.3e} (bound {mxb:.3e}) "
              f"mean_abs_err={mean:.3e} (bound {meanb:.3e}, |ref| max "
              f"{top:.3e});")
    if "ms" in row:
        s += (f" forward+backward ms={row['ms']:.4f} plain_ms="
              f"{row['plain_ms']:.4f}")
    return s + (" ok" if row["ok"] else " FAIL")
