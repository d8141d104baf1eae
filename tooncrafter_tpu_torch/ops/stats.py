"""Per-channel (s1, s2) sums over every non-batch, non-channel axis
(tooncrafter_tpu/ops/stats.py): the CUDA kernel ``csrc/channel_sums.cu``
(replacing the TPU kernel ``_pallas_sums``: one launch over the whole card
whose last block a sample folds the partials in chunk order; ``plan`` cuts
the batch), its plain version, the autograd Function and the JAX package's
dispatch rule.

s1 = sum(x) and s2 = sum(x^2) per (N, C) in fp32, with x cast to fp32
*before* it is squared (not #16's bf16 square). ``channel_sums`` takes the
kernel on CUDA tensors inside the JAX package's envelope (``_use_kernel``,
with "on a TPU" read as "on CUDA"), as the JAX function does on a TPU;
elsewhere the plain version. No model calls it: the JAX package parks the
kernel (its A/B lost to XLA's inline sums) and the port's models keep
``ops.norms.channel_sums``, which is this module's plain version, and take
the sums the stats chain needs of a block's output inline
(``ops.norms.output_sums``), as the JAX models do.

Under autograd ``_SumsFunction`` runs the same dispatch forward and the JAX
custom_vjp's backward, gx = g1 + 2 x g2 in x's dtype
(tooncrafter_tpu/ops/stats.py:117-122).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops.row_sums import (BAR_BYTES, RING_SLOTS,
                                                STAGE_BYTES, row_step,
                                                stage_rows)

LAUNCHES: Dict[str, int] = {"_pallas_sums": 0}

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_BLOCKS_AN_SM = 1      # one block an SM streams fastest on the H100 (PERF.md)
_MIN_ROWS = 64         # rows a chunk, at least
_STAGE_BYTES = 2 * STAGE_BYTES  # fewer, larger stages: one block an SM
_MAX_THREADS = 1024    # csrc/channel_sums.cu: C / (16 bytes of x) a block
# the arrival counters, zeros, per (device, stream): see ``counters``
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    LAUNCHES["_pallas_sums"] = 0


# ---------------------------------------------------------------------------
# the JAX package's envelope (sized for TPU VMEM), unchanged
# ---------------------------------------------------------------------------

def _pick_stile(s: int, c: int, budget: int = 4 * 1024 * 1024) -> int:
    for st in (4096, 2048, 1024, 512, 320, 256, 160, 128, 64, 32, 16, 8):
        if s % st == 0 and 2 * st * c * 2 <= budget:
            return st
    return 0


def _use_kernel(s: int, c: int, cuda: bool) -> bool:
    """The JAX rule (stats.py:50-52) for S positions of C channels; ``cuda``
    stands for its "on a TPU"."""
    return c % 128 in (0, 64) and s >= 256 and _pick_stile(s, c) >= 8 and cuda


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _plain_sums(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, *spatial, C) -> fp32 (s1, s2), each (N, C); x cast to fp32
    before the square."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.float()
    return xf.sum(axes), xf.square().sum(axes)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("channel_sums", ("channel_sums.cu",))
_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tc_channel_sums.argtypes = [vp] * 5 + [i] * 11 + [vp]
    lib.tc_channel_sums.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


class SumsPlan(NamedTuple):
    chunks: int       # blocks a sample
    rows: int         # rows a chunk (the last chunk's may be fewer)
    threads: int      # a block's: 16-byte columns x row offsets
    rstep: int
    stage_rows: int   # rows a ring stage
    slots: int        # ring stages in flight
    fold_rows: int    # chunks' partials a stage of the last block's fold
    fold_slots: int
    smem: int         # dynamic shared memory a block


@functools.lru_cache(maxsize=None)
def plan(n: int, s: int, c: int, itemsize: int) -> SumsPlan:
    """#18's launch for an (n, s, c) input of ``itemsize`` bytes: one wave
    of about _BLOCKS_AN_SM blocks an SM over the batch, at least _MIN_ROWS
    rows a chunk, every chunk non-empty, and no more chunks than about
    sqrt(s itemsize / 8), where a block's chunk (s / chunks rows) and the
    last block's fold (chunks partials of 8 c bytes) take equal bytes; the
    ring in stages of about _STAGE_BYTES, the fold in stages of half the
    ring's memory (the ring's depth mattered little on the H100, its
    stages' size did)."""
    cv = c * itemsize // 16
    rstep = row_step(cv)
    row = c * itemsize
    srows = stage_rows(rstep, row, _STAGE_BYTES)
    want = max(1, min(_BLOCKS_AN_SM * _launch.H100_SMS // n,
                      -(-s // _MIN_ROWS), math.isqrt(s * itemsize // 8)))
    rows = -(-s // want)
    data = RING_SLOTS * srows * row
    fold_rows = max(1, data // 2 // (8 * c))
    fold_slots = data // (8 * c * fold_rows)
    return SumsPlan(-(-s // rows), rows, cv * rstep, rstep, srows,
                    RING_SLOTS, fold_rows, fold_slots, BAR_BYTES + data)


def counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The arrival counters of launches on ``stream``: int32 zeros, at
    least n, allocated once and kept (each launch leaves them 0)."""
    key = (dev.index, stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _COUNTERS[key] = have
    return have


def _launch_sums(x):
    """x (N, S, C) contiguous on the card -> fp32 (s1, s2), each (N, C)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"channel sums: the CUDA kernel takes "
                        f"{sorted(map(str, _DTYPES))}, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"channel sums: expected (N, S, C), got shape "
                         f"{tuple(x.shape)}")
    n, s, c = x.shape
    _launch.check("x", x, x.shape, x.dtype, x.device)
    vec = 16 // x.element_size()
    if c % vec or c // vec > _MAX_THREADS or n == 0 or s == 0:
        raise ValueError(f"channel sums kernel: needs C % {vec} == 0, "
                         f"C <= {vec * _MAX_THREADS} and N, S > 0; got "
                         f"shape {tuple(x.shape)}")
    lib = _library()
    p = plan(n, s, c, x.element_size())
    part = torch.empty((n, p.chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    stream = _launch.stream(x)
    arrived = counters(x.device, stream, n)
    err = lib.tc_channel_sums(
        x.data_ptr(), part.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        arrived.data_ptr(), n, s, c, p.chunks, p.rows, p.rstep, p.stage_rows,
        p.slots, p.fold_rows, p.fold_slots, _DTYPES[x.dtype], stream)
    if err:
        arrived.zero_()
    _launch.raise_on_error(err, f"channel sums (N={n}, S={s}, C={c})")
    return out[0], out[1]


def _pallas_sums(x):
    """The wrapper named after the TPU kernel it replaces: x (N, S, C) ->
    fp32 (s1, s2). CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if _launch.on_cpu("channel sums", x):
        return _plain_sums(x)
    _launch.refuse_grad("_pallas_sums", x)
    out = _launch_sums(x)
    LAUNCHES["_pallas_sums"] += 1
    return out


def _impl(x):
    n, c = x.shape[0], x.shape[-1]
    s = x[0].numel() // c if c else 0
    if _use_kernel(s, c, _launch.is_cuda(x)):
        return _pallas_sums(x.reshape(n, s, c).contiguous())
    return _plain_sums(x)


class _SumsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _impl(x)

    @staticmethod
    def backward(ctx, g1, g2):
        x, = ctx.saved_tensors
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if g1 is not None:
            gx = gx + g1.float().reshape(shape)
        if g2 is not None:
            gx = gx + 2.0 * x.float() * g2.float().reshape(shape)
        return gx.to(x.dtype)


def channel_sums(x):
    """(N, *spatial, C) -> per-channel fp32 sums (s1, s2), each (N, C)."""
    if _launch.needs_grad(x):
        return _SumsFunction.apply(x)
    return _impl(x)
