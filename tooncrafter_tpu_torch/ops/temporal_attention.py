"""The self-attention sub-blocks of the UNet's temporal transformer block
on the card (``csrc/temporal_attention.cu``): both stages (``_fused_tpair_call``,
replacing the TPU kernel tooncrafter_tpu/ops/temporal_attention.py::
_fused_tpair_call, #9) or one (``_fused_tattn_call``, #10), and their plain
version; the per-pixel attention core alone (``temporal_attention_ptc`` over
``_ptc_kernel_call``, #11, ``csrc/temporal_ptc.cu``); and the JAX package's
coverage rules that pick among them (``use_pair_kernel``,
``use_fused_kernel``, ``use_kernel``), with ``TC_TATTN_PAIR`` read once at
import into ``_PAIR`` as it reads it.

    y   = x + to_out1(attn_T(qkv1(LN1(x))))
    out = y + to_out2(attn_T(qkv2(LN2(y))))

attn_T is softmax attention over the T frames of each pixel, per head.
x is (B, T, P, C), the UNet's own layout; the TPU kernel took (B, P, T, C)
and paid a transpose on each side. Each stage is (ln_w, ln_b, wq, wk, wv,
wo, bo) with torch's Linear layout: wq, wk, wv, wo (C, C), bo (C,); ln_w,
ln_b fp32.

Under tensor parallelism (``parallel/tensor.py``) a temporal block takes
the single stage at a rank's share of the heads, ``partial=True``: wq, wk,
wv (inner, C) hold its heads' rows and wo (C, inner) their columns, the
q|k|v GEMM runs at N = 3 inner and the out-GEMM at K = inner, which writes
its fp32 accumulator with no bias, residual or rounding; the caller sums it
over the model group and finishes it as the whole stage's epilogue does
(``fused_ff.finish``). The pair cannot run so: its stage 2 reads stage 1's
finished output.

Under autograd (grad enabled and an input requiring grad) the wrapper runs
``_TPairFunction``: its forward is the kernel (the plain version on the
CPU), its backward differentiates the unfused formula ``_unfused_tpair`` in
the compute dtype, as the JAX package's custom_vjp differentiates
``_xla_fused_tattn`` (tooncrafter_tpu/ops/temporal_attention.py:437-449).
Under CUDA autocast the operands are cast to its dtype first (the
LayerNorms' parameters stay fp32).

Rounding, as the TPU kernel (``_attn_stage``): the LayerNorm runs in fp32
(E[x^2] - mean^2 clamped at 0) and rounds to the compute dtype; q, k and v
round after fp32 products; logits and softmax in fp32, the probabilities
round before the product with v, whose result (o) rounds; the out-GEMM
accumulates in fp32 and rounds; + bo and + x each round. Stage 1's output
is stage 2's input, in the compute dtype.

On the card a stage runs three kernels: the LayerNorm into z (the FF's
kernel), a persistent wgmma q|k|v GEMM over 128-token tiles of whole pixels
with the attention in its epilogue into o, and the FF's out-GEMM with the
bias and residual; z and o are the tensors the TPU kernel rounds to bf16,
so they pass through device memory in bf16 and no number changes. ``plan``
picks the tiles and grids and the scratch shape; the wrapper allocates z
and o with ``torch.empty`` on the caller's stream, stage 2 reuses them and
runs on the output in place. One call counts one launch of the TPU
kernel's name, whatever number of CUDA kernels it runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops.norms import layer_norm_ex2

LAUNCHES: Dict[str, int] = {"_fused_tpair_call": 0, "_fused_tattn_call": 0,
                             "_ptc_kernel_call": 0}
_PAIR = os.environ.get("TC_TATTN_PAIR", "1") == "1"

# the kernels' limits (csrc/temporal_attention.cu): 64-wide heads, T
# dividing 16 (whole pixels in each warp's 16 rows of a 64-token tile); C up
# to 1280, the UNet's widest level and the widest the card checks hold the
# kernels to
HEAD_DIM = 64
_MAX_C = 1280
_TILE = 128  # tokens a tile of the q|k|v GEMM


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the JAX package's coverage rules (temporal_attention.py:51-70, 195-218,
# 348-376), copied as rules: they pick the kernel at each site; the CUDA
# kernels' own limits (``covers``) only refuse a shape
# ---------------------------------------------------------------------------

def _pick_ptile(p: int, inner: int, t: int,
                budget: int = 6 * 1024 * 1024) -> int:
    for blk in (512, 256, 160, 128, 64, 32, 16, 8):
        if p % blk == 0 and t * blk * inner * 2 <= budget:
            return blk
    return 0


def use_kernel(t: int, p: int, d: int, *, mask=None, rel_k=None,
               rel_v=None, inner: int = 0) -> bool:
    """Coverage of the T-attention core (#11)."""
    return (mask is None and rel_k is None and rel_v is None
            and t <= 32 and d in (64, 128) and p >= 128
            and _pick_ptile(p, inner or d, t) >= 64)


def _fused_vmem(pt: int, t: int, c: int, inner: int, stages: int = 1) -> int:
    tok = pt * t
    io = 4 * tok * c * 2
    w = stages * (c * 3 * inner + inner * c) * 2
    z = tok * c * 2
    qkv = tok * 3 * inner * 2
    o = tok * inner * 2
    acc = tok * c * 4
    blk = 128 if (t <= 128 and 128 % t == 0) else t
    logits = tok * blk * 4 * 2
    return io + w + z + qkv + o + acc + logits


def _pick_ptile_fused(p: int, t: int, c: int, inner: int,
                      budget: int = 64 * 1024 * 1024,
                      stages: int = 1) -> int:
    pref = {(2560, 320): 160, (640, 640): 64}.get((p, c))
    if pref and p % pref == 0 \
            and _fused_vmem(pref, t, c, inner, stages) <= budget:
        return pref
    for blk in (512, 256, 160, 128, 80, 64, 40, 32, 16, 8):
        if p % blk == 0 and _fused_vmem(blk, t, c, inner, stages) <= budget:
            return blk
    return 0


def use_fused_kernel(t: int, p: int, d: int, c: int, inner: int) -> bool:
    """Coverage of the single sub-block kernel (#10)."""
    return (t <= 32 and d in (64, 128) and p >= 32
            and c % 64 == 0 and inner % 64 == 0
            and _pick_ptile_fused(p, t, c, inner) >= 32)


def use_pair_kernel(t: int, p: int, d: int, c: int, inner: int) -> bool:
    """Coverage of the pair kernel (#9), off under TC_TATTN_PAIR=0."""
    return (_PAIR and t <= 32 and d in (64, 128) and p >= 32
            and c % 64 == 0 and inner % 64 == 0
            and _pick_ptile_fused(p, t, c, inner, stages=2) >= 32)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _plain_stage(x, stage, heads: int, scale: float, eps: float, cdt,
                 partial: bool = False):
    """x + to_out(attn_T(qkv(LN(x)))) on (B, T, P, C); ``partial``: the
    out-projection's fp32 accumulator alone (bo unused), at wq, wk, wv
    (inner, C) and wo (C, inner) of ``heads`` heads."""
    ln_w, ln_b, wq, wk, wv, wo, bo = stage
    bsz, t, p, c = x.shape
    z = layer_norm_ex2(x, ln_w, ln_b, eps, cdt).float()

    def heads_of(w):  # -> (B, P, heads, T, d)
        y = torch.matmul(z, w.float().t()).to(cdt).float()
        return y.reshape(bsz, t, p, heads, -1).permute(0, 2, 3, 1, 4)

    q, k, v = heads_of(wq), heads_of(wk), heads_of(wv)
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
    o = torch.matmul(probs.to(cdt).float(), v).to(cdt).float()
    o = o.permute(0, 3, 1, 2, 4).reshape(bsz, t, p, -1)
    acc = torch.matmul(o, wo.float().t())
    if partial:
        return acc
    return x + (acc.to(x.dtype) + bo.to(x.dtype))


def _plain_tpair(x, stage1, stage2, heads: int, scale: float, eps: float,
                 cdt: Optional[torch.dtype] = None):
    """The kernel's function and rounding points: intermediates round to
    ``cdt`` (x's dtype unless given), the outputs of the adds to x's dtype.
    Given fp32 operands and cdt=bf16 it is the kernel with its intermediate
    roundings and an fp32 output, the reference of the card's check."""
    cdt = x.dtype if cdt is None else cdt
    y = _plain_stage(x, stage1, heads, scale, eps, cdt)
    y = y.to(cdt).to(x.dtype)  # stage 1's output is stage 2's bf16 input
    return _plain_stage(y, stage2, heads, scale, eps, cdt)


def _unfused_stage(x, stage, heads: int, scale: float, eps: float,
                   partial: bool = False):
    """x + to_out(attn_T(qkv(LN(x)))) on (B, T, P, C) in x's dtype (the
    compute dtype): products in that dtype, LayerNorm statistics, logits
    and softmax in fp32, the probabilities rounded; ``partial``: the
    out-projection alone, without bo and x."""
    ln_w, ln_b, wq, wk, wv, wo, bo = stage
    bsz, t, p, c = x.shape
    z = layer_norm_ex2(x, ln_w, ln_b, eps, x.dtype)

    def heads_of(w):  # -> (B, P, heads, T, d)
        y = torch.nn.functional.linear(z, w)
        return y.reshape(bsz, t, p, heads, -1).permute(0, 2, 3, 1, 4)

    q, k, v = heads_of(wq), heads_of(wk), heads_of(wv)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, -1).to(x.dtype)
    o = torch.matmul(probs, v).permute(0, 3, 1, 2, 4).reshape(bsz, t, p, -1)
    if partial:
        return torch.nn.functional.linear(o, wo)
    return x + torch.nn.functional.linear(o, wo, bo)


def _unfused_tpair(x, stage1, stage2, heads: int, scale: float, eps: float):
    """Both stages unfused; the backward differentiates this."""
    y = _unfused_stage(x, stage1, heads, scale, eps)
    return _unfused_stage(y, stage2, heads, scale, eps)


class _TPairFunction(torch.autograd.Function):
    """The kernel forward with the unfused formula's gradient; the tensors
    are x, then stage 1's seven, then stage 2's."""

    @staticmethod
    def forward(ctx, heads, scale, eps, x, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.cfg = (heads, scale, eps)
        return _dispatch(x, weights[:7], weights[7:], heads, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        ops = ctx.saved_tensors
        want = ctx.needs_input_grad[3:]
        with torch.enable_grad(), torch.autocast("cuda", enabled=False):
            leaves = [t.detach().requires_grad_(w) for t, w in zip(ops, want)]
            y = _unfused_tpair(leaves[0], leaves[1:8], leaves[8:], *ctx.cfg)
            wrt = [t for t, w in zip(leaves, want) if w]
            got = iter(torch.autograd.grad(y, wrt, gy.to(y.dtype)))
        return (None, None, None, *(next(got) if w else None for w in want))


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("temporal_attention", ("temporal_attention.cu",))
_LIB: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """A stage's three kernels (the pair runs them twice): the LayerNorm
    into ``z``; the q|k|v GEMM with the attention in its epilogue into
    ``o``, over ``qkv.tiles`` tiles of 128 tokens (``pixels`` whole pixels
    of T frames; 64 a consumer warpgroup) by one head's q | k | v (192
    columns), head tiles fastest, walked by ``qkv.grid`` persistent blocks;
    the out-GEMM with the bias and residual, tiled as the FF's
    (``fused_ff.plan``) for N = B T P and Cout = C. ``scratch`` is the
    shape of z and ``o`` that of o (inner = heads * 64 columns), each bf16,
    reused by stage 2."""
    scratch: Tuple[int, int, int, int]
    o: Tuple[int, int, int, int]
    pixels: int
    qkv: ff.GemmPlan
    out: ff.GemmPlan


@functools.lru_cache(maxsize=None)
def plan(bsz: int, t: int, p: int, c: int, inner: Optional[int] = None,
         sms: int = _launch.H100_SMS) -> Plan:
    """The kernels' tiles, grids and scratch for x (B, T, P, C) and heads
    of ``inner`` columns in all (C unless given: the whole block; a rank's
    share under tensor parallelism). Raises ValueError outside their
    envelope: T dividing 16, C and inner positive multiples of 64, B T P <
    2^31; TMA zero-fills the pixels past P of a sample's last tile, and its
    stores leave them out. Cached: a request calls it thousands of times at
    a few shapes."""
    inner = c if inner is None else inner
    if (min(bsz, t, p, c, inner) <= 0 or 16 % t or c % HEAD_DIM
            or inner % HEAD_DIM or bsz * t * p >= 2 ** 31):
        raise ValueError(f"temporal attention kernels: need T dividing 16, "
                         f"C and inner multiples of {HEAD_DIM} and B T P < "
                         f"2^31; got B={bsz}, T={t}, P={p}, C={c}, "
                         f"inner={inner}")
    pixels = _TILE // t
    tiles = bsz * -(-p // pixels) * (inner // HEAD_DIM)
    n = bsz * t * p
    return Plan(scratch=(bsz, t, p, c), o=(bsz, t, p, inner), pixels=pixels,
                qkv=ff.GemmPlan(_TILE, 3 * HEAD_DIM, tiles, min(tiles, sms)),
                out=ff.plan(n, c, inner, c, False, sms).out)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_temporal_attn_pair.argtypes = ([vp] * 18 + [i] * 4 + [f, f]
                                          + [i] * 4 + [vp])
    lib.tc_temporal_attn_pair.restype = ctypes.c_int
    lib.tc_temporal_attn_single.argtypes = ([vp] * 11 + [i] * 6 + [f, f]
                                            + [i] * 4 + [vp])
    lib.tc_temporal_attn_single.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def covers(t: int, d: int, c: int, inner: Optional[int] = None) -> bool:
    """Shapes the CUDA kernels take: T frames dividing 16, 64-wide heads,
    C a multiple of 64 up to 1280, and ``inner`` (heads * 64; C unless
    given) up to 1280."""
    inner = c if inner is None else inner
    return (t >= 1 and 16 % t == 0 and d == HEAD_DIM and c % HEAD_DIM == 0
            and inner % HEAD_DIM == 0 and 0 < c <= _MAX_C
            and 0 < inner <= _MAX_C)


def _launch_stages(x, stages, heads: int, scale: float, eps: float,
                   partial: bool = False):
    """Both stages (the pair) or one on the card, into a new tensor (one
    stage with ``partial``: the fp32 accumulator, bo unused)."""
    bsz, t, p, c = x.shape
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    inner = stages[0][2].shape[0]
    if (not covers(t, inner // heads, c, inner) or inner % heads
            or (partial and len(stages) != 1)
            or (len(stages) == 2 and inner != c)):
        raise ValueError(f"temporal attention kernels: need T dividing 16, "
                         f"heads of {HEAD_DIM} and C, inner <= {_MAX_C} "
                         f"(the pair at inner = C); got T={t}, C={c}, "
                         f"inner={inner}, heads={heads}")
    _launch.check("x", x, (bsz, t, p, c), bf, dev)
    ptrs = []
    for i, stage in enumerate(stages, 1):
        for name, ten, shape, dt in zip(
                ("ln_w", "ln_b", "wq", "wk", "wv", "wo", "bo"), stage,
                ((c,), (c,), (inner, c), (inner, c), (inner, c), (c, inner),
                 (c,)),
                (f32, f32, bf, bf, bf, bf, bf)):
            if name == "bo" and partial:
                ptrs.append(None)
                continue
            _launch.check(f"stage {i} {name}", ten, shape, dt, dev)
            ptrs.append(ten.data_ptr())
    out = torch.empty((bsz, t, p, c), dtype=f32 if partial else bf,
                      device=dev)
    if x.numel():
        pl = plan(bsz, t, p, c, inner, _launch.sm_count(dev))
        z = torch.empty(pl.scratch, dtype=bf, device=dev)
        o = torch.empty(pl.o, dtype=bf, device=dev)
        lib = _library()
        shape = (bsz, t, p, c)
        if len(stages) == 2:
            call = lib.tc_temporal_attn_pair
        else:
            call = lib.tc_temporal_attn_single
            shape += (inner, int(partial))
        err = call(x.data_ptr(), *ptrs, z.data_ptr(), o.data_ptr(),
                   out.data_ptr(), *shape, float(scale), float(eps),
                   pl.qkv.grid, pl.out.rows, pl.out.width, pl.out.grid,
                   _launch.stream(x))
        _launch.raise_on_error(err, f"temporal attention, {len(stages)} "
                                    f"stage(s) (B={bsz}, T={t}, P={p}, "
                                    f"C={c})")
    return out


def _launch_tpair(x, stage1, stage2, heads: int, scale: float, eps: float):
    return _launch_stages(x, (stage1, stage2), heads, scale, eps)


def _fused_tpair_call(x, stage1: Sequence[torch.Tensor],
                      stage2: Sequence[torch.Tensor], heads: int,
                      scale: float, eps: float = 1e-5):
    """The wrapper named after the TPU kernel it replaces. x: (B, T, P, C);
    CPU tensors take the plain version, CUDA tensors the kernels."""
    cdt = _launch.compute_dtype(x)
    x = x.to(cdt)
    stage1, stage2 = ((s[0], s[1], *(w.to(cdt) for w in s[2:]))
                      for s in (stage1, stage2))
    if _launch.needs_grad(x, *stage1, *stage2):
        return _TPairFunction.apply(heads, scale, eps, x, *stage1, *stage2)
    return _dispatch(x, stage1, stage2, heads, scale, eps)


def _dispatch(x, stage1, stage2, heads: int, scale: float, eps: float):
    """The plain version for CPU tensors, the kernels for CUDA tensors."""
    if _launch.on_cpu("temporal attention pair", x, *stage1, *stage2):
        return _plain_tpair(x, stage1, stage2, heads, scale, eps)
    out = _launch_tpair(x, stage1, stage2, heads, scale, eps)
    LAUNCHES["_fused_tpair_call"] += 1
    return out


# ---------------------------------------------------------------------------
# one sub-block (#10): the pair's kernels run for one stage
# ---------------------------------------------------------------------------

class _TAttnFunction(torch.autograd.Function):
    """The kernel forward with the unfused formula's gradient
    (``_fused_tattn_bwd``, temporal_attention.py:486-495)."""

    @staticmethod
    def forward(ctx, heads, scale, eps, partial, x, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.flags = (heads, scale, eps, partial)
        return _dispatch_single(x, weights, heads, scale, eps, partial)

    @staticmethod
    def backward(ctx, gy):
        return _launch.recompute_grads(
            ctx, (gy,), lambda x, *w_and_flags: _unfused_stage(
                x, w_and_flags[:7], *w_and_flags[7:]), 4)


def _launch_single(x, stage, heads: int, scale: float, eps: float,
                   partial: bool = False):
    return _launch_stages(x, (stage,), heads, scale, eps, partial)


def _fused_tattn_call(x, stage: Sequence[torch.Tensor], heads: int,
                      scale: float, eps: float = 1e-5,
                      partial: bool = False):
    """x + to_out(attn_T(qkv(LN(x)))) on x (B, T, P, C); ``stage`` is
    (ln_w, ln_b, wq, wk, wv, wo, bo) as a stage of the pair, wq, wk, wv
    (inner, C) and wo (C, inner) for ``heads`` heads of inner / heads.
    ``partial``: the out-projection's fp32 accumulator (B, T, P, C) alone,
    bo unused (it may be None). The wrapper named after the TPU kernel; CPU
    tensors take the plain version, CUDA tensors the kernels."""
    cdt = _launch.compute_dtype(x)
    x = x.to(cdt)
    stage = (stage[0], stage[1], *(None if w is None else w.to(cdt)
                                   for w in stage[2:]))
    if partial:
        stage = stage[:6] + (None,)
    if _launch.needs_grad(x, *stage):
        return _TAttnFunction.apply(heads, scale, eps, partial, x, *stage)
    return _dispatch_single(x, stage, heads, scale, eps, partial)


def _dispatch_single(x, stage, heads: int, scale: float, eps: float,
                     partial: bool = False):
    if _launch.on_cpu("temporal attention", x, *stage):
        return _plain_stage(x, stage, heads, scale, eps, x.dtype, partial)
    out = _launch_single(x, stage, heads, scale, eps, partial)
    LAUNCHES["_fused_tattn_call"] += 1
    return out


# ---------------------------------------------------------------------------
# the T-attention core (#11) on (B, T, P, heads * d), read at its strides
# ---------------------------------------------------------------------------

PTC_LIBRARY = ("temporal_ptc", ("temporal_ptc.cu",))
_PTC_LIB: Optional[ctypes.CDLL] = None
_PTC_MAX_T = 32
_PTC_GROUPS = 2       # consumer groups taking a block's units in turns
_PTC_MAX_STAGES = 8
_SMEM = 227 * 1024    # the dynamic shared memory a block may ask for
_ROW = 128            # bytes of a tile row: 64 bf16 channels


@dataclasses.dataclass(frozen=True)
class PtcPlan:
    """The T-attention kernel's tiling (``csrc/temporal_ptc.cu``): boxes
    of ``t_box`` frames (rows r of a tile: frame r % t_box of pixel r /
    t_box; frames t >= T arrive as zeros), ``rows`` a consumer warp (16, or
    32 where t_box = 32), ``warps`` consumer warps a group (two groups take
    a block's units in turns), so ``pixels`` pixels a tile and ``ptiles`` a
    sample; ``units`` = B ptiles heads work units of (b, pixel tile, head),
    heads fastest, each a ring stage of q, k and v (``stage_bytes``);
    ``stages`` of them in flight, ``smem`` bytes a block, ``grid``
    persistent blocks, unit u on block u % grid."""
    t_box: int
    rows: int
    warps: int
    pixels: int
    ptiles: int
    units: int
    stage_bytes: int
    stages: int
    smem: int
    grid: int

    def unit(self, u: int, heads: int) -> Tuple[int, int, int]:
        """(b, first pixel, head) of unit u."""
        r = u // heads
        return r // self.ptiles, (r % self.ptiles) * self.pixels, u % heads


def _ptc_smem(d: int, rows: int, warps: int, stages: int) -> int:
    boxes = d // 64
    stage = 3 * boxes * warps * rows * _ROW
    staging = _PTC_GROUPS * warps * boxes * rows * _ROW
    return stages * stage + staging + 2 * stages * 8 + 1024


@functools.lru_cache(maxsize=None)
def ptc_plan(b: int, t: int, p: int, inner: int, heads: int,
             sms: int = _launch.H100_SMS) -> PtcPlan:
    """The T-attention kernel's plan for q, k, v (B, T, P, heads * d).
    Raises ValueError outside its envelope: T <= 32, d 64 or 128, fewer
    than 2^31 units."""
    d = inner // heads if heads > 0 else 0
    if (min(b, t, p, heads) <= 0 or t > _PTC_MAX_T or inner % heads
            or d not in (64, 128) or b > 65535):
        raise ValueError(f"T-attention kernel: needs T <= {_PTC_MAX_T} and "
                         f"heads of 64 or 128; got B={b}, T={t}, P={p}, "
                         f"inner={inner}, heads={heads}")
    t_box = t if 16 % t == 0 else (16 if t <= 16 else 32)
    rows = 32 if t_box == 32 else 16
    warps = 2 if (rows == 32 and d == 128) else 4
    pixels = warps * rows // t_box
    ptiles = -(-p // pixels)
    units = b * ptiles * heads
    if units >= 2 ** 31:
        raise ValueError(f"T-attention kernel: {units} work units")
    stage = 3 * (d // 64) * warps * rows * _ROW
    stages = min(_PTC_MAX_STAGES,
                 (_SMEM - _ptc_smem(d, rows, warps, 0)) // (stage + 16))
    return PtcPlan(t_box=t_box, rows=rows, warps=warps, pixels=pixels,
                   ptiles=ptiles, units=units, stage_bytes=stage,
                   stages=stages, smem=_ptc_smem(d, rows, warps, stages),
                   grid=min(units, sms))


def _ptc_library() -> ctypes.CDLL:
    global _PTC_LIB
    if _PTC_LIB is None:
        lib = _build.load_library(*PTC_LIBRARY)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tc_temporal_ptc.argtypes = [vp] * 5 + [i] * 5 + [f] + [i] * 4 \
            + [vp]
        lib.tc_temporal_ptc.restype = ctypes.c_int
        _PTC_LIB = lib
    return _PTC_LIB


def _xla_ptc(q, k, v, heads: int, scale: float,
             cdt: Optional[torch.dtype] = None):
    """The T-attention core's formula on (B, T, P, heads * d) in the inputs'
    dtype: fp32 logits and softmax, the probabilities rounded to ``cdt``
    (v's dtype unless given), the product with v in fp32 rounded once to
    v's dtype (the JAX package's ``_xla_ptc`` and its kernel's rounding)."""
    cdt = v.dtype if cdt is None else cdt
    b, t, p, inner = q.shape

    def split(z):  # -> (B, P, heads, T, d)
        return z.reshape(b, t, p, heads, -1).permute(0, 2, 3, 1, 4)

    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, -1).to(cdt)
    o = torch.matmul(probs.float(), vh.float()).to(v.dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, p, inner)


class _PTCFunction(torch.autograd.Function):
    """The kernel forward with ``_xla_ptc``'s gradient (``_ptc_bwd``,
    temporal_attention.py:141-152)."""

    @staticmethod
    def forward(ctx, heads, scale, q, k, v):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (heads, scale)
        return _dispatch_ptc(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, go):
        want = ctx.needs_input_grad[2:]
        with torch.enable_grad(), torch.autocast("cuda", enabled=False):
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, want)]
            y = _xla_ptc(*leaves, *ctx.cfg)
            wrt = [t for t, w in zip(leaves, want) if w]
            got = iter(torch.autograd.grad(y, wrt, go.to(y.dtype)))
        return (None, None, *(next(got) if w else None for w in want))


def _launch_ptc(q, k, v, heads: int, scale: float):
    b, t, p, inner = q.shape
    d = inner // heads
    if t > _PTC_MAX_T or d not in (64, 128) or inner % heads:
        raise ValueError(f"T-attention kernel: needs T <= {_PTC_MAX_T} and "
                         f"heads of 64 or 128; got T={t}, inner={inner}, "
                         f"heads={heads}")
    strides = []
    for name, z in (("q", q), ("k", k), ("v", v)):
        if z.dtype != torch.bfloat16 or z.device != q.device:
            raise TypeError(f"T-attention kernel: {name} must be bf16 on "
                            f"{q.device}, got {z.dtype} on {z.device}")
        if tuple(z.shape) != (b, t, p, inner):
            raise ValueError(f"T-attention kernel: {name} has shape "
                             f"{tuple(z.shape)}, expected {(b, t, p, inner)}")
        if (z.stride(-1) != 1 or any(s % 8 for s in z.stride()[:3])
                or z.data_ptr() % 16):
            raise ValueError(f"T-attention kernel: {name} needs a contiguous "
                             f"last axis, strides in multiples of 8 and a "
                             f"16-byte aligned pointer; got strides "
                             f"{z.stride()}")
        strides += list(z.stride()[:3])
    out = torch.empty((b, t, p, inner), dtype=torch.bfloat16, device=q.device)
    if out.numel():
        pl = ptc_plan(b, t, p, inner, heads, _launch.sm_count(q.device))
        arr = (ctypes.c_longlong * 9)(*strides)
        err = _ptc_library().tc_temporal_ptc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(arr), b, t, p, heads, d, float(scale),
            pl.t_box, pl.warps, pl.stages, pl.grid, _launch.stream(q))
        _launch.raise_on_error(err, f"T-attention (B={b}, T={t}, P={p}, "
                                    f"inner={inner})")
    return out


def _ptc_kernel_call(q, k, v, heads: int, scale: float):
    """Per-pixel attention over T on q, k, v (B, T, P, heads * d), each at
    its own strides; the wrapper named after the TPU kernel. CPU tensors
    take the plain version, CUDA tensors the kernel."""
    cdt = _launch.compute_dtype(q)
    q, k, v = q.to(cdt), k.to(cdt), v.to(cdt)
    if _launch.needs_grad(q, k, v):
        return _PTCFunction.apply(heads, scale, q, k, v)
    return _dispatch_ptc(q, k, v, heads, scale)


def _dispatch_ptc(q, k, v, heads: int, scale: float):
    if _launch.on_cpu("T-attention", q, k, v):
        return _xla_ptc(q, k, v, heads, scale)
    out = _launch_ptc(q, k, v, heads, scale)
    LAUNCHES["_ptc_kernel_call"] += 1
    return out


def temporal_attention_ptc(q, k, v, *, heads: int, scale: float):
    """The JAX package's ``temporal_attention_ptc`` on the port's (B, T, P,
    heads * d) layout: the kernel forward, ``_xla_ptc``'s backward."""
    return _ptc_kernel_call(q, k, v, heads, scale)
