"""Fused GEGLU feed-forward: [LayerNorm] -> proj -> gate -> out-GEMM
[+ residual] in one CUDA kernel (``csrc/fused_ff.cu``), its plain version,
and the JAX package's dispatch rule that names each launch.

    y = (h * gelu(g)) @ w2^T + b2 [+ x],   [h | g] = LN?(x) @ w1^T + b1

Weights keep torch's Linear layout: w1 (2D, C) with the h rows first and
the gate rows second (GEGLU's ``chunk(2)``), b1 (2D,), w2 (Cout, D), b2
(Cout,); ln_w, ln_b (C,) fp32. The JAX package's ``fused_geglu_ff`` takes
the transposes.

Rounding, as the TPU kernel (tooncrafter_tpu/ops/fused_ff.py:39-46,
:246-247): the LayerNorm runs in fp32 and rounds to the compute dtype; the
projections accumulate in fp32; bias and gate run in fp32 with the exact
erf; only the gated product m rounds to the compute dtype; the out-GEMM
accumulates in fp32 and rounds; then + b2 and + x, each rounded, in the
compute dtype. The TPU kernel's gate uses a degree-15 erf polynomial
(|err| <= 8.1e-5, ``_erf_f32``); the port uses the exact erf (``erff``).

Under autograd (grad enabled and an input requiring grad) the wrapper runs
``_FusedFFFunction``: its forward is the kernel (the plain version on the
CPU), its backward differentiates the unfused formula ``_unfused_ff`` in the
compute dtype, as the JAX package's custom_vjp differentiates ``_xla_ff``
and ``_xla_ln`` (tooncrafter_tpu/ops/fused_ff.py:414-422). Under CUDA
autocast the operands are cast to its dtype first (the LayerNorm's
parameters stay fp32), so fp32 master weights get fp32 gradients.

The TPU package has two kernels, ``_pallas_ff`` (weights resident in VMEM,
C <= 640) and ``_pallas_ff_streamed`` (weight chunks streamed, C = 1280),
split only by the TPU's VMEM. They compute one function, so one set of
CUDA kernels serves both; ``_mode`` (the TPU package's rule, copied)
decides which name counts a launch: "streamed" where the TPU would stream,
the resident name everywhere else. One call counts one launch, whatever
number of CUDA kernels it runs.

Tensor parallelism (``parallel/tensor.py``) calls it with ``partial=True``
on a rank's share of D: w1 holds its value rows and its gate rows, w2 its
columns. The out-GEMM then writes its fp32 accumulator as it is, with no
bias, no residual and no rounding (the kernels' partial epilogue), and
``finish`` applies the bias and the residual once, after the partials are
summed over the model group:

    y = bf16(bf16(sum_r acc_r) + b2) + x

which rounds where the whole call rounds, so a sharded call differs from
it only in the order of the fp32 sums.

On the card a call runs three kernels (``csrc/fused_ff.cu``): the LayerNorm
into z, the projection with the gate into m, the out-GEMM with the bias and
residual into y; z and m are the tensors the TPU kernel rounds to bf16, so
they pass through device memory in bf16 and no number changes. ``plan``
picks the two GEMMs' tiles and persistent grids and the scratch shapes; the
wrapper allocates z and m with ``torch.empty`` on the caller's stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops.norms import layer_norm_ex2

LAUNCHES: Dict[str, int] = {"_pallas_ff": 0, "_pallas_ff_streamed": 0}

def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the TPU package's dispatch rule (tooncrafter_tpu/ops/fused_ff.py:75-137),
# kept to name each launch; its budgets are the TPU's VMEM
# ---------------------------------------------------------------------------

_CHUNK = 640


def _vmem_estimate(tn: int, c: int, d: int, dk: int) -> int:
    weights = c * 2 * d * 2 + d * c * 2
    io = 2 * (tn * c * 2) * 2
    chunk = 2 * tn * dk * 4 + tn * dk * 2
    acc = tn * c * 4
    return weights + io + chunk + acc


def _pick_tile(n: int, c: int, d: int,
               budget: int = 26 * 1024 * 1024) -> int:
    dk = min(d, _CHUNK)
    if d % dk:
        return 0
    order = {320: (256, 512, 128), 640: (512, 256, 128)}.get(
        c, (512, 256, 128))
    for tn in order:
        if n % tn == 0 and _vmem_estimate(tn, c, d, dk) <= budget:
            return tn
    return 0


def _vmem_estimate_streamed(tn: int, c: int, d: int, dk: int) -> int:
    wchunks = (2 * c * dk * 2 + dk * c * 2) * 2
    io = tn * c * 2 * 2
    chunk = 2 * tn * dk * 4 + tn * dk * 2
    acc = tn * c * 4
    return wchunks + io + chunk + acc


def _pick_tile_streamed(n: int, c: int, d: int,
                        budget: int = 72 * 1024 * 1024):
    for tn in (2560, 2048, 1280, 1024, 512):
        if n % tn:
            continue
        for dk in (1280, 640, 512, 256, 128):
            if d % dk:
                continue
            if _vmem_estimate_streamed(tn, c, d, dk) <= budget:
                return tn, dk
    return 0, 0


def _mode(n: int, c: int, d: int, cout: int) -> Optional[str]:
    if not (c % 128 in (0, 64) and cout % 128 in (0, 64) and d % 128 == 0):
        return None
    if _pick_tile(n, max(c, cout), d) > 0:
        return "resident"
    if _pick_tile_streamed(n, max(c, cout), d)[0] > 0:
        return "streamed"
    return None


def kernel_name(n: int, c: int, d: int, cout: int) -> str:
    return ("_pallas_ff_streamed" if _mode(n, c, d, cout) == "streamed"
            else "_pallas_ff")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _plain_ff(x2, w1, b1, w2, b2, ln_w, ln_b, eps: float,
              residual: bool, cdt: Optional[torch.dtype] = None,
              partial: bool = False):
    """x2: (N, C) -> (N, Cout), with the kernel's rounding points: the LN
    output and the gated product m round to ``cdt`` (x2's dtype unless
    given), the out-GEMM and the adds of b2 and x to x2's dtype. Given
    fp32 operands and cdt=bf16 it is the kernel with its intermediate
    roundings and an fp32 output, the reference of the card's check.
    ``partial``: the out-GEMM's fp32 accumulator, nothing added or
    rounded (b2 and ``residual`` unused)."""
    cdt = x2.dtype if cdt is None else cdt
    z = (layer_norm_ex2(x2, ln_w, ln_b, eps, cdt) if ln_w is not None
         else x2)
    a = torch.matmul(z.float(), w1.float().t()) + b1.float()
    h, g = a.chunk(2, dim=-1)
    m = (h * torch.nn.functional.gelu(g)).to(cdt)
    acc = torch.matmul(m.float(), w2.float().t())
    if partial:
        return acc
    y = acc.to(x2.dtype) + b2
    return y + x2 if residual else y


def finish(acc, bias, x):
    """y = bf16(bf16(acc) + bias) + x in x's compute dtype, each add
    rounded: the whole out-GEMM epilogue applied to ``acc``, the partial
    accumulators summed over the model group (fp32, (..., C)), as the
    unsharded kernel applies it to its own accumulator."""
    cdt = _launch.compute_dtype(x)
    return (acc.to(cdt) + bias.to(cdt)) + x.to(cdt)


def _unfused_ff(x2, w1, b1, w2, b2, ln_w, ln_b, eps: float, residual: bool,
                partial: bool = False):
    """The unfused formula in x2's dtype (the compute dtype): products in
    that dtype, LayerNorm statistics, bias-free gate and GELU in fp32, the
    gated product rounded. The backward differentiates it; ``partial``:
    the out-GEMM alone, without b2 and the residual."""
    z = (layer_norm_ex2(x2, ln_w, ln_b, eps, x2.dtype) if ln_w is not None
         else x2)
    h, g = torch.nn.functional.linear(z, w1, b1).chunk(2, dim=-1)
    m = (h.float() * torch.nn.functional.gelu(g.float())).to(x2.dtype)
    if partial:
        return torch.nn.functional.linear(m, w2)
    y = torch.nn.functional.linear(m, w2, b2)
    return y + x2 if residual else y


class _FusedFFFunction(torch.autograd.Function):
    """The kernel forward with the unfused formula's gradient."""

    @staticmethod
    def forward(ctx, eps, residual, partial, name_d, x2, w1, b1, w2, b2,
                ln_w, ln_b):
        ops = (x2, w1, b1, w2, b2, ln_w, ln_b)
        ctx.save_for_backward(*ops)
        ctx.flags = (eps, residual, partial)
        return _dispatch(*ops, eps, residual, partial, name_d)

    @staticmethod
    def backward(ctx, gy):
        return _launch.recompute_grads(ctx, (gy,), _unfused_ff, 4)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("fused_ff", ("fused_ff.cu",))
_LIB: Optional[ctypes.CDLL] = None

H100_SMS = _launch.H100_SMS


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One GEMM's tiling: ``rows`` tokens by ``width`` accumulator columns a
    warpgroup tile (the projection: 64 columns of h and the 64 gate columns
    at the same index; the out-GEMM: ``width`` output columns), ``tiles``
    such tiles, walked by ``grid`` persistent blocks of two warpgroups."""
    rows: int
    width: int
    tiles: int
    grid: int


@dataclasses.dataclass(frozen=True)
class Plan:
    z: Optional[Tuple[int, int]]  # the LayerNorm's output, bf16, if any
    m: Tuple[int, int]            # the gated product, bf16
    proj: GemmPlan
    out: GemmPlan


def _gemm_plan(n: int, width: int, col_tiles: int, sms: int) -> GemmPlan:
    """128-row tiles unless they give fewer tiles than SMs, then 64."""
    for rows in (128, 64):
        tiles = -(-n // rows) * col_tiles
        if tiles >= sms:
            break
    return GemmPlan(rows, width, tiles, min(tiles, sms))


def plan(n: int, c: int, d: int, cout: int, ln: bool,
         sms: int = H100_SMS) -> Plan:
    """The kernels' tiles, grids and scratch for an (n, c) input, D = d,
    Cout = cout, with or without the LayerNorm. Raises ValueError outside
    the kernels' envelope: C % 32 == 0 (the LayerNorm's 16-byte rows), D %
    64 == 0 (the projection's 64-column tiles of h and of g), Cout % 8 ==
    0; TMA fills the ragged edges of N, C and Cout."""
    if n < 0 or c <= 0 or d <= 0 or cout <= 0 or c % 32 or d % 64 or cout % 8:
        raise ValueError(f"fused FF kernels: need C % 32 == 0, D % 64 == 0 "
                         f"and Cout % 8 == 0; got N={n}, C={c}, D={d}, "
                         f"Cout={cout}")
    width = 160 if cout % 160 == 0 else 128
    return Plan(z=(n, c) if ln else None, m=(n, d),
                proj=_gemm_plan(n, 128, d // 64, sms),
                out=_gemm_plan(n, width, -(-cout // width), sms))


def scratch(p: Plan, device) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """z (when there is a LayerNorm) and m, uninitialised, in bf16."""
    z = (None if p.z is None
         else torch.empty(p.z, dtype=torch.bfloat16, device=device))
    return z, torch.empty(p.m, dtype=torch.bfloat16, device=device)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tc_fused_ff.argtypes = ([vp] * 10 + [i] * 4 + [ctypes.c_float]
                                + [i] * 7 + [vp])
    lib.tc_fused_ff.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def _launch_ff(x2, w1, b1, w2, b2, ln_w, ln_b, eps: float, residual: bool,
               partial: bool = False):
    n, c = x2.shape
    d = w1.shape[0] // 2
    cout = w2.shape[0]
    dev = x2.device
    bf = torch.bfloat16
    _launch.check("x", x2, (n, c), bf, dev)
    _launch.check("w1", w1, (2 * d, c), bf, dev)
    _launch.check("b1", b1, (2 * d,), bf, dev)
    _launch.check("w2", w2, (cout, d), bf, dev)
    if not partial:
        _launch.check("b2", b2, (cout,), bf, dev)
    elif residual:
        raise ValueError("fused FF: a partial call adds no residual")
    if ln_w is not None:
        _launch.check("ln_w", ln_w, (c,), torch.float32, dev)
        _launch.check("ln_b", ln_b, (c,), torch.float32, dev)
    if residual and cout != c:
        raise ValueError("fused FF: the residual needs Cout == C")
    p = plan(n, c, d, cout, ln_w is not None,
             _launch.sm_count(dev))
    out = torch.empty((n, cout), dtype=torch.float32 if partial else bf,
                      device=dev)
    if n:
        z, m = scratch(p, dev)
        err = _library().tc_fused_ff(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            _launch.ptr(None if partial else b2), _launch.ptr(ln_w),
            _launch.ptr(ln_b), _launch.ptr(z), m.data_ptr(), out.data_ptr(),
            n, c, d, cout, float(eps), int(residual), int(partial),
            p.proj.rows, p.proj.grid, p.out.rows, p.out.width, p.out.grid,
            _launch.stream(x2))
        _launch.raise_on_error(err, f"fused FF (N={n}, C={c}, D={d})")
    return out


def fused_geglu_ff(x, w1, b1, w2, b2, ln_w=None, ln_b=None,
                   ln_eps: float = 1e-5, residual: bool = False,
                   partial: bool = False, name_d: Optional[int] = None):
    """x: (..., C) -> (..., Cout). CPU tensors take the plain version; CUDA
    tensors launch the kernels, counted under the TPU kernel's name.
    ``partial``: the out-GEMM's fp32 accumulator (..., Cout), without b2
    (which may be None) and the residual, for ``finish`` after the sum over
    the model group; ``name_d``: the whole call's D, which names the
    launch (a rank's share of D runs the kernels the whole call runs)."""
    if residual and (ln_w is None or partial):
        raise ValueError("residual=True needs the LayerNorm prologue and a "
                         "whole call")
    c = x.shape[-1]
    cout = w2.shape[0]
    cdt = _launch.compute_dtype(x)
    x2, w1, b1, w2 = (t.to(cdt) for t in (x.reshape(-1, c), w1, b1, w2))
    b2 = None if partial else b2.to(cdt)
    ops = (x2, w1, b1, w2, b2, ln_w, ln_b)
    if _launch.needs_grad(*ops):
        y = _FusedFFFunction.apply(ln_eps, residual, partial, name_d, *ops)
    else:
        y = _dispatch(*ops, ln_eps, residual, partial, name_d)
    return y.reshape(x.shape[:-1] + (cout,))


def _dispatch(x2, w1, b1, w2, b2, ln_w, ln_b, eps: float, residual: bool,
              partial: bool = False, name_d: Optional[int] = None):
    """The plain version for CPU tensors, the kernels for CUDA tensors."""
    if _launch.on_cpu("fused FF", x2, w1, b1, w2, b2, ln_w, ln_b):
        return _plain_ff(x2, w1, b1, w2, b2, ln_w, ln_b, eps, residual,
                         partial=partial)
    y = _launch_ff(x2, w1, b1, w2, b2, ln_w, ln_b, eps, residual, partial)
    LAUNCHES[kernel_name(x2.shape[0], x2.shape[1], name_d or w2.shape[1],
                         w2.shape[0])] += 1
    return y
