"""Flash attention: CUDA kernel wrappers, their plain versions, the
autograd Function over them, and the dispatch rules of
tooncrafter_tpu/ops/flash_attention.py.

Four forward wrappers carry the names of the four TPU forward kernels they
replace; all of them launch the CUDA C++ forward of
``csrc/flash_attention.cu``, one kernel a head dim (64: 192 query rows a
block; 512, the VAE mid attention: 64 query rows a block, query tiles in
cluster pairs sharing each K/V tile, S computed once and O's value columns
split between two warpgroups):

  * ``_flash_mh_packed(qkv, heads, scale)``: packed (B, S, 3C) -> (B, S, C).
    q, k and v are strided views of the packed projection; nothing is copied.
  * ``_flash_mh(q, k, v, heads, scale)``: token-major (B, S, C) tensors.
  * ``_flash_bh_with_lse(q, k, v, scale)``: (BH, S, 64) -> (out, lse); the
    two-pass (online softmax) form, taken when K/V is too long for one pass.
  * ``_flash_bh_single(q, k, v, scale)``: (BH, S, D) -> (out, lse), the
    single-pass pick of the same selector, here for D = 512.

A fifth, ``_flash_mh_ones(q, k, v, heads, scale)``, is ``_flash_mh`` with
the normalizer of the TPU kernel of that name; nothing in the JAX package
dispatches to it, so no model does. It has no backward (the JAX function
has no custom_vjp) and raises under grad on the card.

Two normalizers: the TPU kernels that append a block of ones to V
(``_flash_mh_ones``, ``_flash_bh_with_lse``, ``_flash_bh_single``) get the
softmax row sum l from their matrix unit, so l sums the bf16-rounded p that
the PV product reads, and their lse is m + log(l) of that sum;
``_flash_mh`` and ``_flash_mh_packed`` sum the unrounded p. The kernel
takes the choice as its ``ones`` flag, and the plain versions follow:
``_plain_bh_ones`` (and ``_plain_mh_ones`` on it) round p to v's dtype for
the product and l, ``_plain_bh`` is the exact softmax. In fp32 the two
agree.

The backward, ``_flash_bwd_bh`` (the TPU kernel of the same name), is
``csrc/flash_attention_bwd.cu`` (head dim 64 only), three launches counted
as one: a pre-pass (D = rowsum(dout * out), lse * log2(e) and a cleared
fp32 dq accumulator, scratch from ``bwd_scratch``), one pass over the
query tiles per 128-key block with the five products (dk and dv in
registers, dq added to the accumulator in L2 by bulk reductions, so not
bit-reproducible from run to run), and a post-pass writing bf16 dq;
``_plain_bwd_passes`` states the three passes. ``_FlashFunction`` puts it
behind ``flash_attention_packed``, ``_flash_mh`` and ``flash_attention``
whenever grad is enabled and an input requires grad: its forward launches
the forward kernel with the lse and saves q, k, v, O and the lse, its
backward launches #6 (for a packed projection straight into the (B, S, 3C)
gradient). The JAX package differentiates its packed and token-major
entries through XLA and only ``flash_attention`` through its kernel; the
port sends all three to the kernel (the same gradient, without the
S x S scores). Under no_grad, or with no input requiring grad, the
wrappers launch the forward kernel as before. The lse-returning
(BH, S, D) wrappers serve the frozen VAE and raise under grad on the card.

A wrapper given CPU tensors runs its plain PyTorch version (``_plain_*``),
which states the math; given CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper. ``error_bounds`` and
``grad_error_bounds`` state how far a kernel's bf16 output may lie from its
fp32 plain version.

The shape selectors (``_pick_block``, ``_single_pass_blk``, ``_mh_blk``,
``_packed_direct_blk``) copy the TPU package's envelopes, which are sized
for TPU VMEM. On the card they only decide which shapes take a kernel and
which wrapper counts the launch: the CUDA kernel masks ragged edges and is
bounded only by its head dims (64, 512) and the grid's y extent
(batch * heads <= 65535).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch as _checks

_KERNEL_HEAD_DIMS = (64, 512)
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# rows of q processed at once by the plain version: bounds its fp32 score
# tile (the dual-ref fusion site has 163840 x 20480 scores per head at
# 320x512, 589824 x 73728 at 576x1024) to _PLAIN_SCORES scores per chunk
_PLAIN_CHUNK = 2048
_PLAIN_SCORES = 1 << 28
# the backward's plain version keeps four such tiles (s/p, dp, ds)
_PLAIN_BWD_CHUNK = 512

LAUNCHES: Dict[str, int] = {
    "_flash_mh_packed": 0,
    "_flash_mh": 0,
    "_flash_bh_with_lse": 0,
    "_flash_bh_single": 0,
    "_flash_bwd_bh": 0,
    "_flash_mh_ones": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# shape selectors (the TPU package's envelopes, unchanged; see above)
# ---------------------------------------------------------------------------

def _pick_block(s: int) -> int:
    for blk in (1280, 1024, 768, 640, 512, 384, 320, 256, 192, 160, 128):
        if s % blk == 0:
            return blk
    return 0


def _use_kernel(sq: int, sk: int, d: int) -> bool:
    """The TPU package's rule (flash_attention._use_kernel), restricted to
    the head dims the CUDA kernel is built for."""
    return (sq >= 160 and sk >= 160 and d in _KERNEL_HEAD_DIMS
            and _pick_block(sq) > 0 and _pick_block(sk) > 0)


def _single_pass_blk(sq: int, sk: int, d: int) -> int:
    if sk > 4096:
        return 0
    for bq in (1280, 1024, 768, 640, 512, 384, 320, 256, 160, 128):
        if sq % bq:
            continue
        score = bq * sk * 4 + bq * sk * 2
        kv = 3 * sk * d * 2 * 2
        io = 2 * (bq * d * 2) * 2 + bq * d * 4
        if score + kv + io <= 60 * 1024 * 1024:
            return bq
    return 0


def _mh_blk(sq: int, sk: int, c: int, heads: int) -> int:
    if sq != sk or c % heads or c // heads != 64 or sk > 9216:
        return 0
    if sk > 4096:
        if sk != 9216:
            return 0
        order = (256, 128)
    else:
        order = (512, 320, 256, 160, 128)
    for bq in order:
        if sq % bq:
            continue
        score = 2 * bq * sk * 4 + bq * sk * 2
        kv = 2 * sk * c * 2 * 2
        io = 2 * (bq * c * 2) * 2
        if score + kv + io <= 60 * 1024 * 1024:
            return bq
    return 0


def _packed_direct_blk(s: int, c: int, heads: int) -> int:
    if c % heads or c // heads != 64:
        return 0
    blk = {320: 512, 640: 640}.get(c, 0)
    return blk if blk and s % blk == 0 and s <= 4096 else 0


def use_packed_kernel(sq: int, c: int, heads: int) -> bool:
    """Does this self-attention take the packed/mh kernels?"""
    return _mh_blk(sq, sq, c, heads) > 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _plain_bh(q, k, v, scale: float, chunk: int = _PLAIN_CHUNK):
    """Exact softmax attention over (N, Sq, D) x (N, Sk, D) in fp32, in
    chunks of query rows. Returns (out in q.dtype, lse fp32 (N, Sq))."""
    chunk = max(64, min(chunk, _PLAIN_SCORES
                        // max(1, q.shape[0] * k.shape[1])))
    kt = k.float().transpose(1, 2)
    vf = v.float()
    outs, lses = [], []
    for i in range(0, q.shape[1], chunk):
        s = torch.matmul(q[:, i:i + chunk].float(), kt) * scale
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        outs.append(torch.matmul(p, vf))
        lses.append(lse)
    return torch.cat(outs, 1).to(q.dtype), torch.cat(lses, 1)


def _plain_bwd_bh(q, k, v, dout, scale: float, out=None, lse=None):
    """Gradients of softmax attention over (N, Sq, D) x (N, Sk, D) in fp32,
    in chunks of query rows: with p = exp(scale q k^T - lse) and
    D = rowsum(dout * out), dv = p^T dout, ds = p * (dout v^T - D),
    dq = scale ds k, dk = scale ds^T q. ``out`` and ``lse`` are recomputed
    when not given. Returns (dq, dk, dv) in q's dtype."""
    if out is None or lse is None:
        out, lse = _plain_bh(q, k, v, scale)
    kf, vf = k.float(), v.float()
    dmat = (dout.float() * out.float()).sum(-1)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    chunk = _PLAIN_BWD_CHUNK
    for i in range(0, q.shape[1], chunk):
        qi, doi = q[:, i:i + chunk].float(), dout[:, i:i + chunk].float()
        p = torch.exp(torch.matmul(qi, kf.transpose(1, 2)) * scale
                      - lse[:, i:i + chunk, None])
        dv += torch.matmul(p.transpose(1, 2), doi)
        ds = p * (torch.matmul(doi, vf.transpose(1, 2))
                  - dmat[:, i:i + chunk, None])
        dq[:, i:i + chunk] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(1, 2), qi) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _fold_heads(x, heads: int):
    """(B, S, H*D) -> (B*H, S, D)."""
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2).reshape(
        b * heads, s, c // heads)


def _plain_mh(q, k, v, heads: int, scale: float):
    """Token-major multi-head attention, (B, S, H*D) -> (B, Sq, H*D)."""
    b, sq, c = q.shape
    out, _ = _plain_bh(_fold_heads(q, heads), _fold_heads(k, heads),
                       _fold_heads(v, heads), scale)
    return out.reshape(b, heads, sq, c // heads).transpose(1, 2).reshape(
        b, sq, c)


def _plain_bh_ones(q, k, v, scale: float,
                   cdt: Optional[torch.dtype] = None,
                   chunk: int = _PLAIN_CHUNK, block: Optional[int] = None):
    """The ones-column kernels' function and rounding over (N, Sq, D) x
    (N, Sk, D): in the exp2 domain, p rounded to ``cdt`` (v's dtype unless
    given) for the PV product AND for the normalizer l, fp32 otherwise, in
    chunks of query rows. Returns (out in q.dtype, lse fp32 (N, Sq) =
    (m + log2 l) ln 2 of that l).

    p is rounded relative to the row max, which an online softmax only
    knows as far as it has read: with ``block`` (keys a step) each key's p
    is rounded at the running max of the blocks up to its own and rescaled
    to the final max in fp32, as a kernel with that key tile rounds it;
    without, at the max of all keys (the single-pass kernel). The two differ
    by the rounding of p: ~1e-4 in the lse at a few thousand random keys."""
    cdt = v.dtype if cdt is None else cdt
    n, sk = k.shape[:2]
    chunk = max(64, min(chunk, _PLAIN_SCORES // max(1, n * sk)))
    block = sk if block is None else block
    tiles = -(-sk // block)
    pad = tiles * block - sk
    kt = k.float().transpose(1, 2)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    outs, lses = [], []
    for i in range(0, q.shape[1], chunk):
        s = torch.matmul(q[:, i:i + chunk].float(), kt) * (scale * _LOG2E)
        s = torch.nn.functional.pad(s, (0, pad), value=-float("inf")).view(
            n, -1, tiles, block)
        run = torch.cummax(s.amax(-1), -1).values  # (n, rows, tiles)
        p = torch.exp2(s - run[..., None]).to(cdt).float()
        w = torch.exp2(run - run[..., -1:])        # to the final max
        l = (p.sum(-1) * w).sum(-1, keepdim=True)
        p = (p * w[..., None]).flatten(2)
        outs.append(torch.matmul(p, vf) / l)
        lses.append(((run[..., -1:] + torch.log2(l)) * _LN2)[..., 0])
    return torch.cat(outs, 1).to(q.dtype), torch.cat(lses, 1)


def _plain_mh_ones(q, k, v, heads: int, scale: float,
                   cdt: Optional[torch.dtype] = None,
                   chunk: int = _PLAIN_CHUNK, block: Optional[int] = None):
    """``_flash_mh_ones``'s function and rounding (``_plain_bh_ones``),
    token-major (B, S, H*D) -> (B, Sq, H*D)."""
    b, sq, c = q.shape
    out, _ = _plain_bh_ones(_fold_heads(q, heads), _fold_heads(k, heads),
                            _fold_heads(v, heads), scale, cdt, chunk, block)
    return out.reshape(b, heads, sq, c // heads).transpose(1, 2).reshape(
        b, sq, c)


# A kernel's bf16 output against its plain version run in fp32 on the same
# bf16 inputs. Rounding the output to bf16 alone costs up to half an ulp
# per element; the kernel adds the rounding of P to bf16 before the PV
# product, about 0.1% of |out|. So the largest error may be MAX_ULPS ulps of
# the largest |out|, and the mean error MEAN_FACTOR times the mean error of
# rounding the reference itself to bf16. An output scaled by 1% or a key
# tile left out exceeds them. The lse is fp32 throughout: values near 10,
# where 1e-4 is ~100 fp32 ulps and a lost key tile shifts it by >= 3e-3.
MAX_ULPS = 2
MEAN_FACTOR = 4
LSE_MAX_ABS = 1e-4


def error_bounds(ref: torch.Tensor, max_ulps: float = MAX_ULPS,
                 mean_factor: float = MEAN_FACTOR) -> Tuple[float, float]:
    """(max, mean) absolute error allowed against the fp32 output ``ref``."""
    ref = ref.float()
    top = ref.abs().max().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)  # bf16: 7-bit mantissa
    rounding = (ref.to(torch.bfloat16).float() - ref).abs().mean()
    return (max_ulps * ulp).item(), (mean_factor * rounding).item()


# The backward kernel's dq, dk and dv against ``_plain_bwd_bh`` in fp32 on
# the same bf16 q, k, v, dout, out and lse. Besides rounding each gradient
# to bf16 (the bound above), the kernel rounds p (for dv) and ds (for dq and
# dk) to bf16 before the products, as the TPU kernel does. Each rounding
# moves a term by up to 2^-9 of itself, in random directions, so the sums
# move by about as much as their own rounding: GRAD_MEAN_FACTOR allows the
# mean error 4x the mean error of rounding the reference, GRAD_MAX_ULPS 4
# bf16 ulps of its largest |value|. A gradient scaled by 1% (the mean error
# then is ~8x the rounding's) or a query tile left out of dk/dv exceeds them.
GRAD_MAX_ULPS = 4
GRAD_MEAN_FACTOR = 4


def grad_error_bounds(ref: torch.Tensor) -> Tuple[float, float]:
    """(max, mean) absolute error allowed for a backward kernel's gradient
    against the fp32 gradient ``ref``."""
    return error_bounds(ref, GRAD_MAX_ULPS, GRAD_MEAN_FACTOR)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------

LIBRARY = ("flash_attention", ("flash_attention.cu",))
BWD_LIBRARY = ("flash_attention_bwd", ("flash_attention_bwd.cu",))
_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None
_BWD_HEAD_DIM = 64


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    lib.tc_flash_fwd.argtypes = (
        [ctypes.c_int] * 2 + [vp] * 5 + [ll] * 12
        + [ctypes.c_int] * 4 + [ctypes.c_float, vp])
    lib.tc_flash_fwd.restype = ctypes.c_int
    lib.tc_flash_key_tile.argtypes = [ctypes.c_int]
    lib.tc_flash_key_tile.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load_library(*LIBRARY))
    return _LIB


def key_tile(head_dim: int) -> int:
    """Keys a tile of the forward kernel at ``head_dim``, as the kernel
    library reports it: where its running max moves, so where #3, #4 and
    #5 round p (``_plain_bh_ones``'s ``block``). Builds the library."""
    tile = _library().tc_flash_key_tile(head_dim)
    if tile <= 0:
        raise ValueError(f"no forward kernel at head_dim {head_dim}")
    return tile


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    lib.tc_flash_bwd.argtypes = (
        [ctypes.c_int] + [vp] * 12 + [ll] * 24 + [ctypes.c_int] * 4
        + [ctypes.c_float, vp])
    lib.tc_flash_bwd.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        _BWD_LIB = bind_bwd(_build.load_library(*BWD_LIBRARY))
    return _BWD_LIB


def _on_cpu(*ts: torch.Tensor) -> bool:
    return _checks.on_cpu("flash attention", *ts)


def _check_operand(name: str, t: torch.Tensor, device) -> Tuple[int, ...]:
    """Raise unless ``t`` is a kernel operand; returns its strides (batch,
    sequence, head), in elements."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    sb, ss, sh, sd = t.stride()
    if sd != 1 or sb % 8 or ss % 8 or sh % 8:
        raise ValueError(f"{name}: needs unit stride on the head dim and "
                         f"16-byte aligned rows, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    return sb, ss, sh


def _launch(q4, k4, v4, o4, lse, scale: float, ones: bool = False) -> None:
    """q4/k4/v4/o4: (B, S, H, D) bf16 views; lse: fp32 (B*H, Sq) or None.
    ``ones``: l sums the bf16-rounded p (#3, #4, #5), else the unrounded
    p (#1, #2)."""
    b, sq, h, d = q4.shape
    sk = k4.shape[1]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel build "
                         f"({_KERNEL_HEAD_DIMS})")
    if d == 512 and not ones:
        raise ValueError("the head-dim-512 kernel (#3, #4) sums the "
                         "bf16-rounded p only")
    if (k4.shape != (b, sk, h, d) or v4.shape != (b, sk, h, d)
            or o4.shape != (b, sq, h, d)):
        raise ValueError(f"shape mismatch q{tuple(q4.shape)} "
                         f"k{tuple(k4.shape)} v{tuple(v4.shape)} "
                         f"o{tuple(o4.shape)}")
    strides = []
    for name, t in (("q", q4), ("k", k4), ("v", v4), ("out", o4)):
        strides += _check_operand(name, t, q4.device)
    if lse is not None and (lse.dtype != torch.float32
                            or lse.shape != (b * h, sq)
                            or not lse.is_contiguous()
                            or lse.device != q4.device):
        raise ValueError("lse must be a contiguous fp32 (B*H, Sq) tensor "
                         "on the same device")
    lib = _library()
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    err = lib.tc_flash_fwd(
        d, int(ones), q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        o4.data_ptr(), None if lse is None else lse.data_ptr(), *strides,
        b, h, sq, sk, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA "
                           f"error {err} (q{tuple(q4.shape)}, "
                           f"k{tuple(k4.shape)})")


# the backward's query tile and key block (csrc/flash_attention_bwd.cu)
_BWD_QTILE = 64
_BWD_KBLOCK = 128


def bwd_scratch(bh: int, sq: int, device) -> Dict[str, torch.Tensor]:
    """The backward kernel's fp32 scratch, its pre-pass fills all of it:
    the dq accumulator (``dq_acc``: (BH, sq_pad, 64), each 64-row tile in
    ``dq_tile_order``), D and lse * log2(e) (``dsum``, ``lse2``: (BH,
    sq_pad)), sq_pad = Sq rounded up to whole query tiles; one allocation
    (each piece starts a whole number of 256-byte query tiles in)."""
    sq_pad = -(-sq // _BWD_QTILE) * _BWD_QTILE
    n = bh * sq_pad
    buf = torch.empty(n * (_BWD_HEAD_DIM + 2), dtype=torch.float32,
                      device=device)
    return {"dq_acc": buf[:n * _BWD_HEAD_DIM].view(bh, sq_pad, _BWD_HEAD_DIM),
            "dsum": buf[n * _BWD_HEAD_DIM:-n].view(bh, sq_pad),
            "lse2": buf[-n:].view(bh, sq_pad)}


def dq_tile_order() -> torch.Tensor:
    """(64, 64) int64: where element (row, column) of a dq tile lies in the
    accumulator's 4096 floats. The main pass's warpgroup 0 holds row
    16w + g + 8r, column 8j + 2t + e (its wgmma fragment) as element e of
    pair 2j + r of thread 32w + 4g + t, and stores pair k of thread i at
    floats 2 (128 k + i) + (0, 1)."""
    row = torch.arange(64)[:, None]
    col = torch.arange(64)[None, :]
    w, g, r = row // 16, row % 8, (row // 8) % 2
    j, t, e = col // 8, (col % 8) // 2, col % 2
    return 2 * (128 * (2 * j + r) + 32 * w + 4 * g + t) + e


def _plain_bwd_prep(out, dout, lse):
    """The pre-pass: (dsum, lse2) over (N, Sq, 64) out and dout and the
    (N, Sq) lse, padded to whole query tiles with 0 and +inf (p = 0 there)."""
    n, sq = lse.shape
    pad = -(-sq // _BWD_QTILE) * _BWD_QTILE - sq
    dsum = (dout.float() * out.float()).sum(-1)
    lse2 = lse.float() * _LOG2E
    return (torch.nn.functional.pad(dsum, (0, pad)),
            torch.nn.functional.pad(lse2, (0, pad), value=float("inf")))


def _plain_bwd_post(dq_acc, scale: float, sq: int):
    """The post-pass: (N, sq_pad, 64) accumulator in ``dq_tile_order`` ->
    scale * dq (N, Sq, 64) in fp32."""
    n, sq_pad, d = dq_acc.shape
    tiles = dq_acc.reshape(n, sq_pad // _BWD_QTILE, _BWD_QTILE * d)
    dq = tiles[..., dq_tile_order().flatten().to(dq_acc.device)]
    return (dq.reshape(n, sq_pad, d) * scale)[:, :sq]


def _plain_bwd_passes(q, k, v, dout, scale: float, out, lse):
    """The backward kernel's three passes in fp32 on (N, S, 64) operands:
    the pre-pass, one step of the main pass per (128-key block, 64-row
    query tile) adding dS K into the accumulator in ``dq_tile_order``, and
    the post-pass. Returns (dq, dk, dv) in fp32, the function of
    ``_plain_bwd_bh`` (the kernel rounds p and ds to bf16 besides)."""
    n, sq, d = q.shape
    sk = k.shape[1]
    dsum, lse2 = _plain_bwd_prep(out, dout, lse)
    sq_pad = dsum.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, sq_pad // _BWD_QTILE, _BWD_QTILE * d), **f32)
    order = dq_tile_order().flatten().to(q.device)
    pad = (0, 0, 0, sq_pad - sq)
    qf = torch.nn.functional.pad(q.float(), pad)
    dof = torch.nn.functional.pad(dout.float(), pad)
    dk = torch.zeros((n, sk, d), **f32)
    dv = torch.zeros((n, sk, d), **f32)
    for n0 in range(0, sk, _BWD_KBLOCK):
        keys = slice(n0, n0 + _BWD_KBLOCK)
        kb, vb = k[:, keys].float(), v[:, keys].float()
        for i in range(sq_pad // _BWD_QTILE):
            rows = slice(i * _BWD_QTILE, (i + 1) * _BWD_QTILE)
            qi, doi = qf[:, rows], dof[:, rows]
            p = torch.exp2(torch.matmul(qi, kb.transpose(1, 2))
                           * (scale * _LOG2E) - lse2[:, rows, None])
            ds = p * (torch.matmul(doi, vb.transpose(1, 2))
                      - dsum[:, rows, None])
            dv[:, keys] += torch.matmul(p.transpose(1, 2), doi)
            dk[:, keys] += torch.matmul(ds.transpose(1, 2), qi)
            acc[:, i, order] += torch.matmul(ds, kb).flatten(1)
    dq = _plain_bwd_post(acc.reshape(n, sq_pad, d), scale, sq)
    return dq, dk * scale, dv


def _launch_bwd(q4, k4, v4, o4, do4, dq4, dk4, dv4, lse, scale: float) -> None:
    """The backward kernel's three passes (one launch count) on
    (B, S, H, 64) bf16 views; lse: fp32 (B*H, Sq) from the forward. Writes
    dq4, dk4 and dv4."""
    b, sq, h, d = q4.shape
    sk = k4.shape[1]
    if d != _BWD_HEAD_DIM:
        raise ValueError(f"the flash-attention backward kernel is built for "
                         f"head dim {_BWD_HEAD_DIM} only, got {d}")
    strides = []
    for name, t, s in (("q", q4, sq), ("k", k4, sk), ("v", v4, sk),
                       ("out", o4, sq), ("dout", do4, sq), ("dq", dq4, sq),
                       ("dk", dk4, sk), ("dv", dv4, sk)):
        if t.shape != (b, s, h, d):
            raise ValueError(f"{name}: expected shape {(b, s, h, d)}, got "
                             f"{tuple(t.shape)}")
        strides += _check_operand(name, t, q4.device)
    if (lse.dtype != torch.float32 or lse.shape != (b * h, sq)
            or not lse.is_contiguous() or lse.device != q4.device):
        raise ValueError("lse must be a contiguous fp32 (B*H, Sq) tensor on "
                         "the same device")
    lib = _bwd_library()
    scratch = bwd_scratch(b * h, sq, q4.device)
    err = lib.tc_flash_bwd(
        d, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        do4.data_ptr(), lse.data_ptr(), scratch["dsum"].data_ptr(),
        scratch["lse2"].data_ptr(), scratch["dq_acc"].data_ptr(),
        dq4.data_ptr(), dk4.data_ptr(), dv4.data_ptr(), *strides, b, h, sq,
        sk, float(scale), torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed "
                           f"with CUDA error {err} (q{tuple(q4.shape)}, "
                           f"k{tuple(k4.shape)})")
    LAUNCHES["_flash_bwd_bh"] += 1


def _flash_bwd_bh(q, k, v, dout, out, lse, scale: float):
    """The backward wrapper named after the TPU kernel: (BH, S, 64) q, k,
    v, dout and out with the forward's fp32 lse (BH, Sq) -> (dq, dk, dv)."""
    if _on_cpu(q, k, v, dout, out, lse):
        return _plain_bwd_bh(q, k, v, dout, scale, out, lse)
    grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in (q, k, v)]
    _launch_bwd(*(t.unsqueeze(2) for t in (q, k, v, out, dout, *grads)),
                lse, scale)
    return tuple(grads)


def flash_bwd_packed(qkv, out, lse, dout, heads: int, scale: float):
    """The backward kernel on a packed (B, S, 3C) projection: its output
    (B, S, C), lse (B*H, S) and dout (B, S, C) -> the (B, S, 3C) gradient,
    dq, dk and dv written in place at the projection's strides."""
    dqkv = torch.empty_like(qkv)
    _launch_bwd(*_packed_views(qkv, heads), out.unflatten(-1, (heads, -1)),
                dout.unflatten(-1, (heads, -1)),
                *_packed_views(dqkv, heads), lse, scale)
    return dqkv


def _packed_views(qkv, heads: int):
    """(B, S, 3C) -> q, k, v as (B, S, H, D) views."""
    return qkv.unflatten(-1, (3, heads, -1)).unbind(-3)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _plain_fwd4(q4, k4, v4, scale: float, ones: bool = False):
    """(B, S, H, D) -> (out (B, Sq, H, D), lse (B*H, Sq)), plain; ``ones``:
    the rounded-p normalizer (``_plain_bh_ones``)."""
    b, sq, h, d = q4.shape

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)
    out, lse = (_plain_bh_ones if ones else _plain_bh)(
        fold(q4), fold(k4), fold(v4), scale)
    return out.reshape(b, h, sq, d).transpose(1, 2), lse


class _FlashFunction(torch.autograd.Function):
    """Attention with its backward kernel. ``tensors`` is one packed
    (B, S, 3C) projection, three token-major (B, S, C) tensors (both with
    ``heads``; the output is (B, Sq, C)), or three (B, S, H, D) tensors
    (``heads`` None; the output is (B, Sq, H, D)). Under autocast the
    operands are cast to bf16, the kernels' type; the gradients come back
    in each input's dtype. ``name`` counts the forward launch. The
    (B, S, H, D) form is the TPU package's ``flash_attention``, whose
    forward and backward run ``_flash_bh_with_lse``: the rounded-p
    normalizer and its lse; the other two take the unrounded sum."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, scale, name, heads, *tensors):
        if len(tensors) == 1:
            q4, k4, v4 = _packed_views(tensors[0], heads)
        elif heads is None:
            q4, k4, v4 = tensors
        else:
            q4, k4, v4 = (t.unflatten(-1, (heads, -1)) for t in tensors)
        b, sq, h, d = q4.shape
        ones = heads is None
        if _on_cpu(*tensors):
            out4, lse = _plain_fwd4(q4, k4, v4, scale, ones)
        else:
            if d != _BWD_HEAD_DIM:
                raise ValueError(
                    f"flash attention under autograd on the card needs head "
                    f"dim {_BWD_HEAD_DIM} (the backward kernel's); got {d}")
            out4 = torch.empty((b, sq, h, d), dtype=q4.dtype,
                               device=q4.device)
            lse = torch.empty((b * h, sq), dtype=torch.float32,
                              device=q4.device)
            _launch(q4, k4, v4, out4, lse, scale, ones)
            LAUNCHES[name] += 1
        ctx.save_for_backward(*tensors, out4, lse)
        ctx.scale, ctx.heads = scale, heads
        return out4 if heads is None else out4.flatten(2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gout):
        *tensors, out4, lse = ctx.saved_tensors
        scale, heads = ctx.scale, ctx.heads
        do4 = gout.to(out4.dtype).reshape(out4.shape)
        if len(tensors) == 1:
            qkv = tensors[0]
            views = _packed_views(qkv, heads)
        elif heads is None:
            views = tensors
        else:
            views = tuple(t.unflatten(-1, (heads, -1)) for t in tensors)
        b, sq, h, d = views[0].shape
        if _on_cpu(*tensors):
            def fold(t):
                return t.transpose(1, 2).reshape(b * h, t.shape[1], d)
            grads = _plain_bwd_bh(*(fold(t) for t in views), fold(do4),
                                  scale, fold(out4), lse)
            grads = [g.reshape(b, h, -1, d).transpose(1, 2) for g in grads]
            if len(tensors) == 1:
                grads = [torch.cat([g.flatten(2) for g in grads], -1)]
            elif heads is not None:
                grads = [g.flatten(2) for g in grads]
        elif len(tensors) == 1:
            grads = [flash_bwd_packed(qkv, out4.flatten(2), lse,
                                      do4.contiguous().flatten(2), heads,
                                      scale)]
        else:
            grads = [torch.empty((b, t.shape[1], h, d), dtype=t.dtype,
                                 device=t.device) for t in views]
            _launch_bwd(*views, out4, do4.contiguous(), *grads, lse, scale)
            if heads is not None:
                grads = [g.flatten(2) for g in grads]
        return (None, None, None, *grads)


# ---------------------------------------------------------------------------
# the four forward wrappers
# ---------------------------------------------------------------------------

def _flash_mh_packed(qkv, heads: int, scale: float):
    """Packed-QKV self-attention: (B, S, 3C) -> (B, S, C)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    if _checks.needs_grad(qkv):
        return _FlashFunction.apply(scale, "_flash_mh_packed", heads, qkv)
    if _on_cpu(qkv):
        return _plain_mh(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                         heads, scale)
    d = c // heads
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    _launch(qkv[..., :c].unflatten(-1, (heads, d)),
            qkv[..., c:2 * c].unflatten(-1, (heads, d)),
            qkv[..., 2 * c:].unflatten(-1, (heads, d)),
            out.unflatten(-1, (heads, d)), None, scale)
    LAUNCHES["_flash_mh_packed"] += 1
    return out


def _flash_mh(q, k, v, heads: int, scale: float):
    """Token-major multi-head attention: (B, S, C) -> (B, Sq, C)."""
    if _checks.needs_grad(q, k, v):
        return _FlashFunction.apply(scale, "_flash_mh", heads, q, k, v)
    if _on_cpu(q, k, v):
        return _plain_mh(q, k, v, heads, scale)
    b, sq, c = q.shape
    d = c // heads
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    _launch(q.unflatten(-1, (heads, d)), k.unflatten(-1, (heads, d)),
            v.unflatten(-1, (heads, d)), out.unflatten(-1, (heads, d)),
            None, scale)
    LAUNCHES["_flash_mh"] += 1
    return out


def _flash_mh_ones(q, k, v, heads: int, scale: float):
    """Token-major multi-head attention with l = sum of bf16(p): (B, S, C)
    -> (B, Sq, C)."""
    if _on_cpu(q, k, v):
        return _plain_mh_ones(q, k, v, heads, scale)
    _checks.refuse_grad("_flash_mh_ones", q, k, v)
    b, sq, c = q.shape
    d = c // heads
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    _launch(q.unflatten(-1, (heads, d)), k.unflatten(-1, (heads, d)),
            v.unflatten(-1, (heads, d)), out.unflatten(-1, (heads, d)),
            None, scale, ones=True)
    LAUNCHES["_flash_mh_ones"] += 1
    return out


def _bh_launch(q4, k4, v4, scale: float, name: str, with_lse: bool = True):
    """q4/k4/v4: (B, S, H, D) views -> (out (B, Sq, H, D), lse (B*H, Sq) or
    None), counted under ``name``: #3 or #4, the rounded-p normalizer."""
    b, sq, h, d = q4.shape
    out = torch.empty((b, sq, h, d), dtype=q4.dtype, device=q4.device)
    lse = (torch.empty((b * h, sq), dtype=torch.float32, device=q4.device)
           if with_lse else None)
    _launch(q4, k4, v4, out, lse, scale, ones=True)
    LAUNCHES[name] += 1
    return out, lse


def _bh_kernel_name(sq: int, sk: int, d: int) -> str:
    """The TPU package's choice between its single-pass and two-pass
    (``_flash_bh_with_lse``) kernels."""
    return ("_flash_bh_single" if _single_pass_blk(sq, sk, d)
            else "_flash_bh_with_lse")


def _flash_bh_single(q, k, v, scale: float) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Single-pass forward with logsumexp: (BH, S, D) -> (out, lse (BH, Sq))."""
    if _on_cpu(q, k, v):
        return _plain_bh_ones(q, k, v, scale)
    _checks.refuse_grad("_flash_bh_single", q, k, v)
    out, lse = _bh_launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                          scale, "_flash_bh_single")
    return out.squeeze(2), lse


def _flash_bh_with_lse(q, k, v, scale: float) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Forward with logsumexp over (BH, S, D); single pass when K/V fits
    (the TPU package's ``_single_pass_blk``), online softmax otherwise."""
    bh, sq, d = q.shape
    name = _bh_kernel_name(sq, k.shape[1], d)
    if name == "_flash_bh_single":
        return _flash_bh_single(q, k, v, scale)
    if _on_cpu(q, k, v):
        return _plain_bh_ones(q, k, v, scale)
    _checks.refuse_grad(name, q, k, v)
    out, lse = _bh_launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                          scale, name)
    return out.squeeze(2), lse


# ---------------------------------------------------------------------------
# entry points (the TPU package's public names)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale: Optional[float] = None):
    """q, k, v: (B, S, H, D) -> (B, Sq, H, D), through the per-(B*H)
    kernels. On the card the (B, S, H, D) views are read and the output
    written in place; the lse is not made."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    if _checks.needs_grad(q, k, v):
        return _FlashFunction.apply(scale, _bh_kernel_name(sq, sk, d), None,
                                    q, k, v)
    if _on_cpu(q, k, v):
        fold = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], d)
        out, _ = _plain_bh_ones(fold(q), fold(k), fold(v), scale)
        return out.reshape(b, h, sq, d).transpose(1, 2)
    out, _ = _bh_launch(q, k, v, scale, _bh_kernel_name(sq, sk, d),
                        with_lse=False)
    return out


def flash_attention_packed(qkv, heads: int, scale: Optional[float] = None,
                           whole_c: Optional[int] = None):
    """Self-attention over a packed (B, S, 3*H*D) projection, for shapes
    inside ``use_packed_kernel``'s envelope (callers route the rest through
    ``ops.attention.attention``). ``whole_c``: under tensor parallelism
    the whole block's H*D, of which ``qkv`` holds a rank's heads; the whole
    call's route (``_flash_mh_packed`` or ``_flash_mh``, one kernel under
    two names) names the launch."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    sc = (c // heads) ** -0.5 if scale is None else scale
    rc = c if whole_c is None else whole_c
    if _packed_direct_blk(s, rc, rc // (c // heads)):
        return _flash_mh_packed(qkv, heads, sc)
    if not _mh_blk(s, s, c, heads):
        raise ValueError(f"packed attention outside the kernel envelope: "
                         f"S={s}, C={c}, heads={heads}")
    if _checks.needs_grad(qkv):
        # one gradient for the projection, written in place by the kernel
        return _FlashFunction.apply(sc, "_flash_mh", heads, qkv)
    return _flash_mh(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                     heads, sc)
