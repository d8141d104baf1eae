"""The temporal attention kernels' plan and their token gather, on the CPU:
``ops/temporal_attention.plan`` pinned at every shape the card checks, and
a torch emulation of the q|k|v GEMM's 4-D TMA gather (z viewed as (C, T, P,
B), boxes of {64 channels, T frames, 128 / T pixels, 1}) and of its o
store (each consumer warpgroup's 64 rows, boxes of 64 / T pixels), through
the tile order of ``csrc/temporal_attention.cu`` (``QkvOp::tile``): every
token is read and every (token, head) written exactly once, each warp's 16
rows are whole pixels (the epilogue's attention is warp-local, its mask
``i / T == j / T``), and rows past P are the only padding.
"""

import pytest
import torch

from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

# (B, T, P, C): (pixels a tile, q|k|v tiles, its grid, out-GEMM rows, width,
# tiles, grid) on the H100's 132 SMs, at every shape phase 2 checks #9 and
# #10 at (``kernel_check.TPAIR_512``, ``TPAIR_1024``, ``TATTN_512``) and the
# card tests' ragged pixel counts and short clips
PLANS = {
    (2, 16, 2560, 320): (8, 3200, 132, 128, 160, 1280, 132),
    (2, 16, 2560, 512): (8, 5120, 132, 128, 128, 2560, 132),
    (2, 16, 640, 640): (8, 1600, 132, 128, 160, 640, 132),
    (2, 16, 160, 1280): (8, 800, 132, 128, 160, 320, 132),
    (2, 16, 40, 1280): (8, 200, 132, 64, 160, 160, 132),
    (2, 16, 9216, 320): (8, 11520, 132, 128, 160, 4608, 132),
    (2, 16, 2304, 640): (8, 5760, 132, 128, 160, 2304, 132),
    (2, 16, 576, 1280): (8, 2880, 132, 128, 160, 1152, 132),
    (2, 16, 144, 1280): (8, 720, 132, 128, 160, 288, 132),
    (2, 16, 9216, 512): (8, 18432, 132, 128, 128, 9216, 132),
    (2, 16, 37, 320): (8, 50, 50, 64, 160, 38, 38),
    (2, 4, 21, 512): (32, 16, 16, 64, 128, 12, 12),
    (2, 16, 3, 1280): (8, 40, 40, 64, 160, 16, 16),
    (2, 8, 5, 64): (16, 2, 2, 64, 128, 2, 2),
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_tiles_grids_and_scratch(shape):
    """128-token tiles of 128 / T whole pixels by one head's q | k | v, on
    at most one block an SM; the out-GEMM tiled as the FF's at N = B T P and
    Cout = C (128 rows unless that gives fewer tiles than SMs, 160 columns
    where C allows); the scratch z and o each (B, T, P, C)."""
    bsz, t, p, c = shape
    pl = ta.plan(*shape)
    assert (pl.pixels, pl.qkv.tiles, pl.qkv.grid, pl.out.rows, pl.out.width,
            pl.out.tiles, pl.out.grid) == PLANS[shape]
    assert pl.scratch == shape
    assert (pl.qkv.rows, pl.qkv.width) == (128, 192)
    assert pl.qkv.tiles == bsz * -(-p // (128 // t)) * (c // 64)
    assert pl.out == ta.ff.plan(bsz * t * p, c, c, c, False).out


def test_plans_cover_every_checked_shape():
    checked = {(2, 16, p, c) for _, p, c in
               kc.TPAIR_512 + kc.TPAIR_1024 + kc.TATTN_512}
    assert checked <= set(PLANS)
    assert {p for _, p, _ in kc.TPAIR_1024} == {9216, 2304, 576, 144}


def test_plan_refuses_what_the_kernels_do_not_take():
    for shape in ((2, 5, 40, 320), (2, 32, 40, 320), (2, 16, 40, 96),
                  (2, 16, 0, 320), (0, 16, 40, 320)):
        with pytest.raises(ValueError, match="temporal attention kernels"):
            ta.plan(*shape)


def _tiles(pl, heads):
    """Every tile as ``QkvOp::tile`` decodes it: (sample, first pixel,
    head), head tiles fastest."""
    i = torch.arange(pl.qkv.tiles)
    r = i // heads
    ptiles = -(-pl.scratch[2] // pl.pixels)
    return r // ptiles, (r % ptiles) * pl.pixels, i % heads


def _box_rows(bsz, t, p, b, px0, pixels):
    """The T pixels rows of {64, T, pixels, 1} boxes at (0, 0, px0, b) of z
    viewed as (C, T, P, B), one box a tile, in shared-memory order
    (innermost first: frame, then pixel): each row's token index in (B, T,
    P), -1 where TMA fills zeros (pixels past P)."""
    ids = torch.arange(bsz * t * p).reshape(bsz, t, p)
    padded = torch.cat([ids, torch.full((bsz, t, 128), -1,
                                        dtype=ids.dtype)], 2)
    j = torch.arange(pixels)
    box = padded[b[:, None, None], torch.arange(t)[None, :, None],
                 (px0[:, None] + j)[:, None, :]]  # (tiles, T, pixels)
    # row r: frame r % T of pixel r / T
    return box.transpose(1, 2).reshape(len(b), -1)


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_gather_reads_every_token_once_in_whole_pixels(shape):
    bsz, t, p, c = shape
    pl = ta.plan(*shape)
    heads = c // 64
    b, px0, h = _tiles(pl, heads)
    rows = _box_rows(bsz, t, p, b, px0, pl.pixels)  # (tiles, 128)
    real = rows >= 0
    # padding: exactly the rows of pixels past P
    pix = px0[:, None] + torch.arange(128) // t
    assert torch.equal(real, pix < p)
    assert torch.equal(torch.where(real, rows // p % t, -1),
                       torch.where(real, torch.arange(128) % t, -1))
    assert torch.equal(torch.where(real, rows % p, -1),
                       torch.where(real, pix, -1))
    # each warp's 16 rows are whole pixels: rows i, j of a warp share a
    # pixel exactly when i / T == j / T, the epilogue's mask
    wp = pix.reshape(-1, 8, 16)
    local = torch.arange(16) // t
    assert torch.equal(wp[..., :, None] == wp[..., None, :],
                       (local[:, None] == local[None, :]).expand(
                           wp.shape[0], 8, 16, 16))
    # the head-0 tiles read every token once; the o stores (each
    # warpgroup's 64 rows from pixel px0 + w 64 / T, boxes of 64 / T
    # pixels, the head's 64 columns, rows past P clipped) write every
    # (token, head) once
    read = torch.zeros(bsz * t * p, dtype=torch.long)
    h0 = (h == 0)[:, None] & real
    read.index_add_(0, rows[h0], torch.ones_like(rows[h0]))
    assert torch.equal(read, torch.ones_like(read))
    written = torch.zeros(bsz * t * p * heads, dtype=torch.long)
    for w in range(2):
        half = _box_rows(bsz, t, p, b, px0 + w * pl.pixels // 2,
                         pl.pixels // 2).reshape(-1, 64)
        assert torch.equal(half, rows[:, 64 * w:64 * w + 64])
        slot = half * heads + h[:, None]
        written.index_add_(0, slot[half >= 0],
                           torch.ones_like(slot[half >= 0]))
    assert torch.equal(written, torch.ones_like(written))


def test_breakdown_bounds_of_the_three_kernels():
    """``utils/breakdown``'s #9 bounds: the LayerNorms by their bytes; the
    q|k|v GEMMs by their operations (~480 a byte at C = 320, the card's
    ratio ~295); the out-GEMMs by their bytes at C = 320 and 640 (C / 3
    operations a byte), by their operations at C = 1280; their sum above
    the call's bound."""
    from tooncrafter_tpu_torch.utils import breakdown as bd

    for label, p, c in kc.TPAIR_512 + kc.TPAIR_1024:
        n = 2 * 16 * p
        got = bd.tpair_bounds(2, 16, p, c)
        assert got["ln"] == pytest.approx(
            2 * (4.0 * n * c + 8.0 * c) / kc.PEAK_BYTES_PER_S * 1e3)
        assert got["qkv"] == pytest.approx(
            2 * (6.0 * n * c * c + 64.0 * n * c) / kc.PEAK_BF16_FLOPS * 1e3)
        by_ops = got["out"] == pytest.approx(
            2 * 2.0 * n * c * c / kc.PEAK_BF16_FLOPS * 1e3)
        assert by_ops == (c > 640), label
        call = kc.bound(kc.tpair_flops(n, 16, c), kc.tpair_bytes(n, c))[0]
        assert sum(got.values()) > call
