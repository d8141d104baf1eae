"""One-pass GroupNorm (+SiLU) per sample (tooncrafter_tpu/ops/fused_norms.py):
its CUDA kernel (``csrc/group_norm_silu.cu``, replacing the TPU kernel
``_pallas_gn``: one launch, a thread block cluster a sample that exchanges
its sums through distributed shared memory; ``plan`` cuts the sample), its
plain version and the dispatch rule.

``TOONCRAFTER_FUSED_GN=1`` (read once, at import, as the JAX package reads
it) sends ``group_norm_silu`` to the kernel wherever one sample's activation
takes at most ``_MAX_VMEM_SAMPLE_BYTES`` in the compute dtype; otherwise, and
with the switch off, it is ``ops.norms.group_norm`` (+ SiLU), what the port
ran before. ``ops.norms.GroupNorm`` calls it where the JAX package's
``GroupNormAct`` has no chained statistics.

The kernel's rounding is not ``group_norm`` + SiLU's: the sums are of x and
of the square x * x in x's dtype (bf16 on the card), taken in fp32; the
variance is E[x^2] - mean^2 clamped at 0; the affine folds into per-channel
(A, B); y = x A + B and its SiLU run in fp32 and round once.
``_plain_gn`` states exactly that. Under autograd the wrapper runs
``_GroupNormFunction``: its forward is the kernel (the plain version on the
CPU), its backward differentiates ``group_norm`` + SiLU, as the JAX
package's custom_vjp differentiates ``_xla_impl``
(tooncrafter_tpu/ops/fused_norms.py:134-142).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, NamedTuple, Optional

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops.norms import group_norm
from tooncrafter_tpu_torch.ops.row_sums import (BAR_BYTES, MAX_SLOTS,
                                                RING_SLOTS, SMEM_BLOCK,
                                                blocks_an_sm, row_step,
                                                stage_rows)

LAUNCHES: Dict[str, int] = {"_pallas_gn": 0}

_MAX_VMEM_SAMPLE_BYTES = 4 * 1024 * 1024  # one sample, compute dtype
_FUSED_GN = os.environ.get("TOONCRAFTER_FUSED_GN") == "1"
_MAX_C = 4096  # the widest rows the plan is made for: 512 16-byte columns

CLUSTER_SIZES = (1, 2, 4, 8, 16)  # csrc/group_norm_silu.cu; 16 non-portable
MAX_THREADS = 1024
MIN_ROWS = 20      # rows a block, at least, where the cluster size allows
# clusters of k blocks the H100 holds at once at one block an SM (its
# cudaOccupancyMaxActiveClusters: ``utils/breakdown.py --kernel gn``
# prints it for each plan); a 16-block cluster takes 16 SMs of one GPC,
# and only 112 of the 132 SMs make up such groups
CLUSTERS_AT_ONE_AN_SM = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def reset_launch_counts() -> None:
    LAUNCHES["_pallas_gn"] = 0


def sample_bytes(x: torch.Tensor) -> int:
    """One sample's bytes in the dtype the norm computes in."""
    return x[0].numel() * _launch.compute_dtype(x).itemsize


def use_kernel(x: torch.Tensor) -> bool:
    """The JAX package's rule (fused_norms.py:121-125): the switch is on and
    one sample fits the TPU kernel's VMEM budget."""
    return _FUSED_GN and sample_bytes(x) <= _MAX_VMEM_SAMPLE_BYTES


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _plain_gn(x, scale, bias, num_groups: int, eps: float, silu: bool,
              cdt: Optional[torch.dtype] = None):
    """The kernel's function and rounding on (N, *spatial, C): the square
    rounds to ``cdt`` (x's dtype unless given), everything else in fp32,
    one rounding to x's dtype at the end."""
    n, c = x.shape[0], x.shape[-1]
    flat = x.reshape(n, -1, c)
    xf = flat.float()
    s1 = xf.sum(1)
    xc = flat.to(x.dtype if cdt is None else cdt)
    s2 = (xc * xc).float().sum(1)
    cnt = flat.shape[1] * (c // num_groups)
    mean = s1.reshape(n, num_groups, -1).sum(-1) / cnt
    var = (s2.reshape(n, num_groups, -1).sum(-1) / cnt
           - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(c // num_groups, 1) * scale.float()
    b = bias.float() - mean.repeat_interleave(c // num_groups, 1) * a
    y = xf * a[:, None] + b[:, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


class _GroupNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, silu)
        return _dispatch(x, scale, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, gy):
        ops = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad(), torch.autocast("cuda", enabled=False):
            leaves = [t.detach().requires_grad_(w) for t, w in zip(ops, want)]
            y = group_norm(*leaves, *ctx.cfg)
            wrt = [t for t, w in zip(leaves, want) if w]
            got = iter(torch.autograd.grad(y, wrt, gy.to(y.dtype)))
        return (*(next(got) if w else None for w in want), None, None, None)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("group_norm_silu", ("group_norm_silu.cu",))
_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_group_norm_silu.argtypes = [vp] * 4 + [i] * 9 + [f, i, vp]
    lib.tc_group_norm_silu.restype = ctypes.c_int
    lib.tc_gn_clusters.argtypes = [i] * 4
    lib.tc_gn_clusters.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def smem_bytes(c: int, groups: int, rstep: int, data: int) -> int:
    """A block's shared memory (csrc/group_norm_silu.cu's Layout): the
    mbarriers, the group partials, the channel sums, the row offsets'
    fold, then ``data`` bytes of slice or ring at a 128-byte boundary."""
    head = BAR_BYTES + -(-8 * groups // 16) * 16 + 8 * c
    return -(-(head + 4 * max(rstep, 2) * c) // 128) * 128 + data


class GnPlan(NamedTuple):
    k: int            # blocks a sample: one cluster
    rows: int         # rows a block (the last block's may be fewer)
    threads: int      # a block's: 16-byte columns x row offsets
    rstep: int
    stage_rows: int   # rows a stage
    slots: int        # stages held in shared memory
    resident: bool    # the whole slice held (else streamed twice)
    smem: int         # bytes a block
    per_sm: int       # blocks an SM could hold


@functools.lru_cache(maxsize=None)
def plan(n: int, hw: int, c: int, groups: int = 32) -> GnPlan:
    """#16's launch for a (n, hw, c) bf16 input: k blocks (one cluster) a
    sample, ``rows`` rows each, every block's rows non-empty. The rules,
    from timing every (k, branch, row offsets) on the H100 (PERF.md):
    - k: the largest cluster size that leaves each block MIN_ROWS rows, but
      at least 4 where the rows allow: small slices cost a cluster more
      than they save;
    - twice the row offsets (threads) where the grid is under two blocks
      an SM: its few blocks then work faster;
    - the slice resident in shared memory where blocks fit two to an SM,
      or where the batch is one wave at one an SM (CLUSTERS_AT_ONE_AN_SM);
      else streamed twice through a ring of RING_SLOTS stages, the second
      read from L2 (the L2 branch): a wave of resident slices at one
      block an SM leaves the card's memory idle while it computes."""
    cv = c // 8
    row = 2 * c
    ks = [k for k in CLUSTER_SIZES if (k - 1) * -(-hw // k) < hw]
    k = max([k for k in ks if -(-hw // k) >= MIN_ROWS] + [max(
        k for k in ks if k <= 4)])
    rows = -(-hw // k)
    rstep = row_step(cv)
    if n * k < 2 * _launch.H100_SMS and 2 * cv * rstep <= MAX_THREADS:
        rstep *= 2
    threads = cv * rstep
    srows = stage_rows(rstep, row)
    smem = smem_bytes(c, groups, rstep, rows * row)
    slots = -(-rows // srows)
    per_sm = blocks_an_sm(smem, threads)
    if (smem <= SMEM_BLOCK and slots <= MAX_SLOTS
            and (per_sm >= 2 or n <= CLUSTERS_AT_ONE_AN_SM[k])):
        return GnPlan(k, rows, threads, rstep, srows, slots, True, smem,
                      per_sm)
    smem = smem_bytes(c, groups, rstep, RING_SLOTS * srows * row)
    return GnPlan(k, rows, threads, rstep, srows, RING_SLOTS, False, smem,
                  blocks_an_sm(smem, threads))


def _launch_gn(x, scale, bias, num_groups: int, eps: float, silu: bool):
    n, c = x.shape[0], x.shape[-1]
    hw = x[0].numel() // c if n else 0
    dev, f32 = x.device, torch.float32
    _launch.check("x", x, x.shape, torch.bfloat16, dev)
    _launch.check("scale", scale, (c,), f32, dev)
    _launch.check("bias", bias, (c,), f32, dev)
    if c % 8 or c % num_groups or c > _MAX_C:
        raise ValueError(f"GroupNorm kernel: needs C % 8 == 0, C % groups "
                         f"== 0 and C <= {_MAX_C}; got C={c}, groups="
                         f"{num_groups}")
    out = torch.empty_like(x)
    if not x.numel():
        return out
    p = plan(n, hw, c, num_groups)
    err = _library().tc_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
        hw, c, num_groups, p.k, p.rows, p.rstep, p.stage_rows, p.slots,
        float(eps), int(silu), _launch.stream(x))
    _launch.raise_on_error(err, f"GroupNorm (N={n}, HW={hw}, C={c})")
    return out


def _pallas_gn(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
               silu: bool = True):
    """The wrapper named after the TPU kernel it replaces; x (N, *spatial,
    C). CPU tensors take the plain version, CUDA tensors the kernel (in CUDA
    autocast's dtype while it is on)."""
    x = x.to(_launch.compute_dtype(x)).contiguous()
    scale, bias = scale.float(), bias.float()
    if _launch.needs_grad(x, scale, bias):
        return _GroupNormFunction.apply(x, scale, bias, num_groups, eps, silu)
    return _dispatch(x, scale, bias, num_groups, eps, silu)


def _dispatch(x, scale, bias, num_groups: int, eps: float, silu: bool):
    if _launch.on_cpu("GroupNorm", x, scale, bias):
        return _plain_gn(x, scale, bias, num_groups, eps, silu)
    out = _launch_gn(x, scale, bias, num_groups, eps, silu)
    LAUNCHES["_pallas_gn"] += 1
    return out


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True, shift: Optional[torch.Tensor] = None):
    """silu(group_norm(x + shift)) (or the norm alone) with fp32 statistics
    on (N, *spatial, C): the kernel where ``use_kernel`` holds, else
    ``ops.norms.group_norm``. ``shift`` (N, C): the unfused ResBlock's time
    embedding, which the JAX package adds in x's dtype before its norm
    (h + e); ``group_norm`` adds it in fp32, as the port did before."""
    if not use_kernel(x):
        return group_norm(x, scale, bias, num_groups, eps, silu, shift)
    if shift is not None:
        x = x + shift.to(x.dtype).reshape(
            (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))
    return _pallas_gn(x, scale, bias, num_groups, eps, silu)
