"""Dual cross-attention, text + image branch, for the UNet's attn2
(tooncrafter_tpu/ops/cross_attention.py): the CUDA kernel
``csrc/dual_cross_attention.cu`` (replacing the TPU kernel
``_dual_kernel_call``), its plain version, the autograd Function and the
JAX package's dispatch rule.

    out = attn(q, kt, vt) + s_ip * attn(q, ki, vi)

over token-major (B, S, H*64) projections. The kernel's rounding, as the
TPU kernel's: scores and softmax in fp32 (the scale folded into exp2), p
rounded to q's dtype before the PV product while the normalizer l sums the
unrounded p, and ONE rounding to q's dtype after the combine. ``_plain_dual``
states exactly that.

``TC_DUAL_CROSS_PALLAS=1`` (read once, at import, into
``_DUAL_CROSS_PALLAS``, as the JAX package reads it) sends
``dual_cross_attention`` to the kernel on CUDA tensors inside the JAX
envelope (``use_kernel``); otherwise it runs the port's counterpart of
``_xla_dual``: two ``ops.attention.attention`` calls and a combine in q's
dtype. No model calls it: the UNet's attn2 keeps its two attentions, as the
JAX package's does (it parks the kernel: XLA's two fusions won on v5e).
Under autograd ``_DualFunction`` runs the kernel forward and differentiates
the two-attention formula in q, kt, vt, ki, vi and s_ip, as the JAX
custom_vjp does (cross_attention.py:177-183).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple, Union

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops.attention import attention

_DUAL_CROSS_PALLAS = os.environ.get("TC_DUAL_CROSS_PALLAS") == "1"
_LOG2E = 1.4426950408889634
HEAD_DIM = 64

LAUNCHES: Dict[str, int] = {"_dual_kernel_call": 0}

Scalar = Union[float, torch.Tensor]


def reset_launch_counts() -> None:
    LAUNCHES["_dual_kernel_call"] = 0


# ---------------------------------------------------------------------------
# the JAX package's envelope (sized for TPU VMEM), unchanged
# ---------------------------------------------------------------------------

def _pick_blk(sq: int) -> int:
    for bq in (512, 320, 256, 160, 128):
        if sq % bq == 0:
            return bq
    return 0


def use_kernel(sq: int, lt: int, li: int, c: int, heads: int,
               cuda: bool) -> bool:
    """The JAX rule (cross_attention.py:66-77): d = 64 heads, both KV sets
    at most 1024 tokens, a query block dividing Sq, and the switch on;
    ``cuda`` stands for its "on a TPU"."""
    if c % heads or c // heads != HEAD_DIM:
        return False
    if lt > 1024 or li > 1024 or _pick_blk(sq) == 0:
        return False
    return cuda and _DUAL_CROSS_PALLAS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _attend(qh, kh, vh, scale: float, cdt: torch.dtype):
    """One branch before the combine, fp32 (BH, Sq, D): softmax(q k^T) v
    with p rounded to ``cdt`` for the product and l over the unrounded p."""
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2)) * (scale
                                                                * _LOG2E)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    acc = torch.matmul(p.to(cdt).float(), vh.float())
    return acc / p.sum(-1, keepdim=True)


def _scalar(s_ip: Scalar, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s_ip, dtype=torch.float32,
                           device=like.device).reshape(())


def _plain_dual(q, kt, vt, ki, vi, s_ip: Scalar, heads: int, scale: float,
                cdt: Optional[torch.dtype] = None):
    """The kernel's function and rounding: the two branches and their
    combine in fp32, p rounded to ``cdt`` (q's dtype unless given), one
    rounding to q's dtype at the end."""
    b, sq, c = q.shape
    d = c // heads
    cdt = q.dtype if cdt is None else cdt

    def fold(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2).reshape(
            b * heads, t.shape[1], d)
    qh = fold(q)
    out = (_attend(qh, fold(kt), fold(vt), scale, cdt)
           + _scalar(s_ip, q) * _attend(qh, fold(ki), fold(vi), scale, cdt))
    return out.reshape(b, heads, sq, d).transpose(1, 2).reshape(
        b, sq, c).to(q.dtype)


def _xla_dual(q, kt, vt, ki, vi, s_ip: Scalar, heads: int, scale: float):
    """The JAX package's unfused route: two attentions, each rounded to its
    dtype, combined in q's dtype."""
    out = attention(q, kt, vt, heads=heads, scale=scale)
    out_ip = attention(q, ki, vi, heads=heads, scale=scale)
    if isinstance(s_ip, torch.Tensor):
        s_ip = s_ip.reshape(())
    return out + s_ip * out_ip


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("dual_cross_attention", ("dual_cross_attention.cu",))
_LIB: Optional[ctypes.CDLL] = None

# the kernel's tiles (csrc/dual_cross_attention.cu)
Q_TILE = 64         # query rows a tile: four consumer warps of 16
TEXT_TILE = 80      # keys a text tile (77 tokens, padded and masked)
IMAGE_TILE = 16     # keys an image tile
_ROW = 128          # bytes of a tile row: one 64-wide head in bf16
_SMEM = 227 * 1024  # the dynamic shared memory a block may ask for
_SM_SMEM = 228 * 1024  # an SM's, 1 KB of it reserved a block
_RESIDENT_SLOT = 48 * 1024  # largest K/V slot held resident (twice)
_Q_STAGES = 4
_STREAM_SLOTS = 4
_BLOCKS_AN_SM = 2  # the kernel's __launch_bounds__ (its registers allow)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The dual kernel's work split. Each head's (b, query tile) index,
    tiles fastest (``qtiles`` 64-row tiles a (b, h), ``span`` = B qtiles),
    is cut into ``blocks`` contiguous ranges; block i takes head i % heads
    and range i // heads (``grid`` = heads blocks persistent blocks), so
    the heads of a range walk the same query rows side by side.
    ``resident``: a block loads the K/V of a (b, h) (``text_tiles`` key
    tiles of 80 rows, ``image_tiles`` of 16) into one of two slots of
    ``slot`` bytes when its range enters that (b, h); else (streamed) every
    query tile's key tiles pass through a ring of ``kvslots`` slots. Either
    way the online softmax rescales at those key tiles. q tiles stream
    through ``qstages``."""
    heads: int
    qtiles: int
    span: int
    blocks: int
    text_tiles: int
    image_tiles: int
    resident: bool
    slot: int
    kvslots: int
    qstages: int
    smem: int
    grid: int

    def block_range(self, i: int) -> Tuple[int, int, int]:
        """Block i's head and (b, tile) indices [lo, hi) of that head."""
        run = i // self.heads
        return (i % self.heads, run * self.span // self.blocks,
                (run + 1) * self.span // self.blocks)

    def units(self, i: int) -> List[Tuple[int, int, int]]:
        """Block i's units in order: (b heads + h, first query tile,
        tiles), one a (b, h) its range enters; the K/V loads of a resident
        plan."""
        h, lo, hi = self.block_range(i)
        out: List[Tuple[int, int, int]] = []
        f = lo
        while f < hi:
            b, qt = divmod(f, self.qtiles)
            n = min(hi, (b + 1) * self.qtiles) - f
            out.append((b * self.heads + h, qt, n))
            f += n
        return out


@functools.lru_cache(maxsize=None)
def plan(b: int, sq: int, c: int, lt: int, li: int,
         sms: int = _launch.H100_SMS) -> Plan:
    """The kernel's plan for q (B, Sq, C) against Lt text and Li image
    tokens. Raises ValueError outside its envelope: 64-wide heads, non-empty
    operands, B <= 65535."""
    if (min(b, sq, lt, li) < 1 or c < HEAD_DIM or c % HEAD_DIM
            or b > 65535):
        raise ValueError(f"dual cross-attention kernel: head dim "
                         f"{HEAD_DIM} only and non-empty operands; got B={b},"
                         f" Sq={sq}, C={c}, Lt={lt}, Li={li}")
    heads = c // HEAD_DIM
    qtiles = -(-sq // Q_TILE)
    tt, it = -(-lt // TEXT_TILE), -(-li // IMAGE_TILE)
    slot = 2 * (tt * TEXT_TILE + it * IMAGE_TILE) * _ROW
    resident = slot <= _RESIDENT_SLOT
    if not resident:
        slot = 2 * TEXT_TILE * _ROW
    kvslots = 2 if resident else _STREAM_SLOTS
    smem = (kvslots * slot + _Q_STAGES * Q_TILE * _ROW + 4 * 16 * _ROW
            + 2 * (_Q_STAGES + kvslots) * 8 + 1024)
    per_sm = min(_BLOCKS_AN_SM, _SM_SMEM // (smem + 1024))
    blocks = max(1, min(b * qtiles, per_sm * sms // heads))
    return Plan(heads=heads, qtiles=qtiles, span=b * qtiles, blocks=blocks,
                text_tiles=tt, image_tiles=it, resident=resident, slot=slot,
                kvslots=kvslots, qstages=_Q_STAGES, smem=smem,
                grid=heads * blocks)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.tc_dual_cross_attention.argtypes = (
        [vp] * 6 + [f, vp] + [ll] * 12 + [i] * 5 + [f] + [i] * 4 + [vp])
    lib.tc_dual_cross_attention.restype = ctypes.c_int
    lib.tc_dual_blocks_per_sm.argtypes = [i]
    lib.tc_dual_blocks_per_sm.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: needs unit stride on the channels and "
                         f"16-byte aligned rows, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def _launch_dual(q, kt, vt, ki, vi, s_ip: Scalar, heads: int, scale: float):
    b, sq, c = q.shape
    lt, li = kt.shape[1], ki.shape[1]
    if c % heads or c // heads != HEAD_DIM:
        raise ValueError(f"dual cross-attention kernel: head dim "
                         f"{HEAD_DIM} only, got C={c}, heads={heads}")
    if min(sq, lt, li, b) < 1 or b > 65535:
        raise ValueError(f"dual cross-attention kernel: empty or too large "
                         f"a batch (B={b}, Sq={sq}, Lt={lt}, Li={li})")
    dev = q.device
    for name, t, s in (("q", q, sq), ("kt", kt, lt), ("vt", vt, lt),
                       ("ki", ki, li), ("vi", vi, li)):
        _check_operand(name, t, (b, s, c), dev)
    # a tensor gate by pointer (no host sync), a Python float by value: one
    # launch either way
    si, si_value = None, 0.0
    if isinstance(s_ip, torch.Tensor):
        if s_ip.numel() != 1 or s_ip.device != dev:
            raise ValueError(f"s_ip: one value on {dev}, got shape "
                             f"{tuple(s_ip.shape)} on {s_ip.device}")
        si = s_ip.detach()
        if si.dtype != torch.float32 or not si.is_contiguous():
            si = si.float().contiguous()
    else:
        si_value = float(s_ip)
    out = torch.empty((b, sq, c), dtype=q.dtype, device=dev)
    strides = []
    for t in (q, kt, vt, ki, vi, out):
        strides += [t.stride(0), t.stride(1)]
    pl = plan(b, sq, c, lt, li, _launch.sm_count(dev))
    err = _library().tc_dual_cross_attention(
        q.data_ptr(), kt.data_ptr(), vt.data_ptr(), ki.data_ptr(),
        vi.data_ptr(), _launch.ptr(si), si_value, out.data_ptr(), *strides,
        b, heads, sq, lt, li, float(scale) * _LOG2E, int(pl.resident),
        pl.qstages, pl.kvslots, pl.grid, _launch.stream(q))
    _launch.raise_on_error(err, f"dual cross-attention (B={b}, Sq={sq}, "
                                f"C={c}, Lt={lt}, Li={li})")
    return out


def _dispatch(q, kt, vt, ki, vi, s_ip: Scalar, heads: int, scale: float):
    if _launch.on_cpu("dual cross-attention", q, kt, vt, ki, vi):
        return _plain_dual(q, kt, vt, ki, vi, s_ip, heads, scale)
    out = _launch_dual(q, kt, vt, ki, vi, s_ip, heads, scale)
    LAUNCHES["_dual_kernel_call"] += 1
    return out


class _DualFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kt, vt, ki, vi, s_ip, heads, scale):
        ctx.save_for_backward(q, kt, vt, ki, vi, s_ip)
        ctx.cfg = (heads, scale)
        return _dispatch(q, kt, vt, ki, vi, s_ip, heads, scale)

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        want = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in zip(ops, want)]
            y = _xla_dual(*leaves, *ctx.cfg)
            wrt = [t for t, w in zip(leaves, want) if w]
            got = iter(torch.autograd.grad(y, wrt, g.to(y.dtype)))
        return (*(next(got) if w else None for w in want), None, None)


def _dual_kernel_call(q, kt, vt, ki, vi, s_ip: Scalar, heads: int,
                      scale: float):
    """The wrapper named after the TPU kernel it replaces. CPU tensors take
    the plain version, CUDA tensors the kernel; under autograd
    ``_DualFunction`` (s_ip then a tensor as well)."""
    ops = (q, kt, vt, ki, vi)
    if _launch.needs_grad(*ops, s_ip if isinstance(s_ip, torch.Tensor)
                          else None):
        return _DualFunction.apply(*ops, _scalar(s_ip, q), heads, scale)
    return _dispatch(*ops, s_ip, heads, scale)


def dual_cross_attention(q, kt, vt, ki, vi, scale_ip: Scalar, heads: int,
                         scale: Optional[float] = None):
    """out = attn(q, kt, vt) + scale_ip * attn(q, ki, vi), token-major.

    q: (B, Sq, H*D); kt/vt: (B, Lt, H*D); ki/vi: (B, Li, H*D); scale_ip a
    float or a one-element tensor (the learnable gate). The kernel where
    ``use_kernel`` holds, else two attentions."""
    b, sq, c = q.shape
    sc = (c // heads) ** -0.5 if scale is None else scale
    if use_kernel(sq, kt.shape[1], ki.shape[1], c, heads,
                  _launch.is_cuda(q)):
        return _dual_kernel_call(q, kt, vt, ki, vi, scale_ip, heads, sc)
    return _xla_dual(q, kt, vt, ki, vi, scale_ip, heads, sc)
