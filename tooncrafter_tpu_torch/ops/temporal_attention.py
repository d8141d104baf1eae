"""Both self-attention sub-blocks of the UNet's temporal transformer block
in one CUDA kernel (``csrc/temporal_attention.cu``, replacing the TPU
kernel tooncrafter_tpu/ops/temporal_attention.py::_fused_tpair_call), and
its plain version:

    y   = x + to_out1(attn_T(qkv1(LN1(x))))
    out = y + to_out2(attn_T(qkv2(LN2(y))))

attn_T is softmax attention over the T frames of each pixel, per head.
x is (B, T, P, C), the UNet's own layout; the TPU kernel took (B, P, T, C)
and paid a transpose on each side. Each stage is (ln_w, ln_b, wq, wk, wv,
wo, bo) with torch's Linear layout: wq, wk, wv, wo (C, C), bo (C,); ln_w,
ln_b fp32.

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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops.norms import layer_norm_ex2

LAUNCHES: Dict[str, int] = {"_fused_tpair_call": 0}

# the kernel's limits (csrc/temporal_attention.cu): 64-wide heads, at most
# 1280 channels (z and o of a 32-token tile in shared memory), T dividing 16
# (whole pixels in each m16 row tile)
HEAD_DIM = 64
_MAX_C = 1280


def reset_launch_counts() -> None:
    LAUNCHES["_fused_tpair_call"] = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _plain_stage(x, stage, heads: int, scale: float, eps: float, cdt):
    """x + to_out(attn_T(qkv(LN(x)))) on (B, T, P, C)."""
    ln_w, ln_b, wq, wk, wv, wo, bo = stage
    bsz, t, p, c = x.shape
    z = layer_norm_ex2(x, ln_w, ln_b, eps, cdt).float()

    def heads_of(w):  # -> (B, P, heads, T, d)
        y = torch.matmul(z, w.float().t()).to(cdt).float()
        return y.reshape(bsz, t, p, heads, -1).permute(0, 2, 3, 1, 4)

    q, k, v = heads_of(wq), heads_of(wk), heads_of(wv)
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
    o = torch.matmul(probs.to(cdt).float(), v).to(cdt).float()
    o = o.permute(0, 3, 1, 2, 4).reshape(bsz, t, p, c)
    y = torch.matmul(o, wo.float().t()).to(x.dtype) + bo.to(x.dtype)
    return x + y


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


def _unfused_stage(x, stage, heads: int, scale: float, eps: float):
    """x + to_out(attn_T(qkv(LN(x)))) on (B, T, P, C) in x's dtype (the
    compute dtype): products in that dtype, LayerNorm statistics, logits
    and softmax in fp32, the probabilities rounded."""
    ln_w, ln_b, wq, wk, wv, wo, bo = stage
    bsz, t, p, c = x.shape
    z = layer_norm_ex2(x, ln_w, ln_b, eps, x.dtype)

    def heads_of(w):  # -> (B, P, heads, T, d)
        y = torch.nn.functional.linear(z, w)
        return y.reshape(bsz, t, p, heads, -1).permute(0, 2, 3, 1, 4)

    q, k, v = heads_of(wq), heads_of(wk), heads_of(wv)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, -1).to(x.dtype)
    o = torch.matmul(probs, v).permute(0, 3, 1, 2, 4).reshape(bsz, t, p, c)
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_temporal_attn_pair.argtypes = [vp] * 16 + [i] * 4 + [f, f, vp]
    lib.tc_temporal_attn_pair.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def covers(t: int, d: int, c: int) -> bool:
    """Shapes the CUDA kernel takes: T frames dividing 16, 64-wide heads,
    C = heads * 64 <= 1280."""
    return (t >= 1 and 16 % t == 0 and d == HEAD_DIM and c % HEAD_DIM == 0
            and c <= _MAX_C)


def _launch_tpair(x, stage1, stage2, heads: int, scale: float, eps: float):
    bsz, t, p, c = x.shape
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    if not covers(t, c // heads, c) or c % heads:
        raise ValueError(f"temporal attention pair kernel: needs T dividing "
                         f"16, heads of {HEAD_DIM} and C <= {_MAX_C}; got "
                         f"T={t}, C={c}, heads={heads}")
    _launch.check("x", x, (bsz, t, p, c), bf, dev)
    ptrs = []
    for i, stage in enumerate((stage1, stage2), 1):
        for name, ten, shape, dt in zip(
                ("ln_w", "ln_b", "wq", "wk", "wv", "wo", "bo"), stage,
                ((c,), (c,), (c, c), (c, c), (c, c), (c, c), (c,)),
                (f32, f32, bf, bf, bf, bf, bf)):
            _launch.check(f"stage {i} {name}", ten, shape, dt, dev)
            ptrs.append(ten.data_ptr())
    out = torch.empty_like(x)
    if x.numel():
        err = _library().tc_temporal_attn_pair(
            x.data_ptr(), *ptrs, out.data_ptr(), bsz, t, p, c, float(scale),
            float(eps), _launch.stream(x))
        _launch.raise_on_error(err, f"temporal attention pair (B={bsz}, "
                                    f"T={t}, P={p}, C={c})")
    return out


def _fused_tpair_call(x, stage1: Sequence[torch.Tensor],
                      stage2: Sequence[torch.Tensor], heads: int,
                      scale: float, eps: float = 1e-5):
    """The wrapper named after the TPU kernel it replaces. x: (B, T, P, C);
    CPU tensors take the plain version, CUDA tensors the kernel."""
    cdt = _launch.compute_dtype(x)
    x = x.to(cdt)
    stage1, stage2 = ((s[0], s[1], *(w.to(cdt) for w in s[2:]))
                      for s in (stage1, stage2))
    if _launch.needs_grad(x, *stage1, *stage2):
        return _TPairFunction.apply(heads, scale, eps, x, *stage1, *stage2)
    return _dispatch(x, stage1, stage2, heads, scale, eps)


def _dispatch(x, stage1, stage2, heads: int, scale: float, eps: float):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if _launch.on_cpu("temporal attention pair", x, *stage1, *stage2):
        return _plain_tpair(x, stage1, stage2, heads, scale, eps)
    out = _launch_tpair(x, stage1, stage2, heads, scale, eps)
    LAUNCHES["_fused_tpair_call"] += 1
    return out
