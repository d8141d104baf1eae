"""The plans of the T-attention core (#11, ``ops/temporal_attention.ptc_plan``)
and the dual cross-attention (#17, ``ops/cross_attention.plan``), on the
CPU, and torch emulations of the two kernels' layouts held against the
plain versions and the JAX package's Pallas kernels in interpret mode.

  * ``ptc_plan`` at every ``PTC_512`` shape and the card tests' shapes:
    frames a box (T where T divides 16, else 16 or 32), every (b, pixel,
    head) in exactly one work unit, the ring within shared memory;
  * ``plan`` at every ``ATTN2_512`` shape: K/V held resident, every (b, h,
    query tile) in one block's range once, K/V loaded only where a block's
    range enters another (b, h), the heads of a range on consecutive
    blocks; at the card tests' (64, 100, 32) and (37, 1, 1) and a long
    context (the streamed branch);
  * both refuse what their kernels do not take;
  * #11's tile layout emulated (pixel-major rows, zero rows at t >= T and
    past P, a softmax per pixel masked to its real frames, each warp's
    rows alone) at T = 3, 8, 16 and 32, and #17's key tiles emulated (the
    online softmax rescaling at every 80-key text and 16-key image tile).

Bounds: in fp32 the emulations differ from the plain versions and the
interpret-mode kernels only in summation order: 1e-5 of max |out| for #11
(as tests/test_torch_switched_kernels.py), 3e-5 for #17 (as
tests/test_torch_cross_attention.py: exp2 against exp in the Pallas
kernel). In bf16 both sides round p and the output at the same points: one
bf16 ulp of max |out| (2^-7) where the orders straddle a rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import cross_attention as jca
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu_torch.ops import cross_attention as ca
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

SMEM = 227 * 1024

# the card tests' #11 shapes (tests/test_torch_cuda_kernels.py), B = 2:
# (T, P, inner, heads)
PTC_CARD = ((16, 37, 320, 5), (8, 21, 256, 2), (32, 5, 128, 2),
            (3, 9, 192, 3), (4, 640, 320, 5), (3, 640, 320, 5),
            (20, 160, 640, 5))


def _ptc_rows():
    return ([(2, t, p, inner, heads) for _, t, p, inner, heads in kc.PTC_512]
            + [(2, *row) for row in PTC_CARD])


# ---------------------------------------------------------------------------
# #11: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,p,inner,heads", _ptc_rows())
def test_ptc_plan_covers_every_pixel_and_head_once(b, t, p, inner, heads):
    pl = ta.ptc_plan(b, t, p, inner, heads)
    d = inner // heads
    assert pl.t_box == (t if 16 % t == 0 else (16 if t <= 16 else 32))
    assert pl.rows == (32 if pl.t_box == 32 else 16)
    assert pl.rows % pl.t_box == 0  # a warp holds whole pixels
    assert pl.pixels * pl.t_box == pl.warps * pl.rows
    assert 2 <= pl.stages <= 8 and pl.smem <= SMEM
    assert pl.stage_bytes == 3 * (d // 64) * pl.warps * pl.rows * 128
    assert pl.grid == min(pl.units, 132)
    seen = np.zeros((b, p, heads), np.int64)
    for u in range(pl.units):
        bi, px0, h = pl.unit(u, heads)
        seen[bi, px0:px0 + pl.pixels, h] += 1
        # heads fastest: the units of one pixel tile run side by side
        if u % heads:
            assert pl.unit(u - 1, heads)[:2] == (bi, px0)
    assert (seen == 1).all()


def test_ptc_plan_at_the_path_shapes():
    """The 512 shapes: 4 pixels of 16 frames a tile at d = 64 (8 stages),
    8 of 8 frames at d = 128 (4 stages)."""
    got = {label: ta.ptc_plan(2, t, p, inner, heads)
           for label, t, p, inner, heads in kc.PTC_512}
    assert (got["ds1"].pixels, got["ds1"].stages, got["ds1"].units) \
        == (4, 8, 6400)
    assert (got["ds4"].pixels, got["ds4"].units) == (4, 1600)
    assert (got["T=8 d=128"].t_box, got["T=8 d=128"].pixels,
            got["T=8 d=128"].stages) == (8, 8, 4)


@pytest.mark.parametrize("t,inner,heads", [(33, 320, 5), (16, 64, 2),
                                           (16, 512, 2), (16, 320, 3)])
def test_ptc_plan_refuses_outside_the_kernel(t, inner, heads):
    with pytest.raises(ValueError):
        ta.ptc_plan(2, t, 64, inner, heads)
    z = torch.zeros(2, t, 64, inner, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the wrapper, before any launch
        ta._launch_ptc(z, z, z, heads, 0.125)


# ---------------------------------------------------------------------------
# #11: the tile layout, emulated
# ---------------------------------------------------------------------------

def emulate_ptc(q, k, v, heads: int, scale: float, pl, cdt=None,
                same_pixel: bool = True, real_frame: bool = True):
    """#11 as the kernel lays it out: per work unit, tiles of pixel-major
    rows (frame r % t_box of pixel r / t_box, zeros past T and P), each
    consumer warp's rows alone: logits over its own rows' keys masked to
    the query's pixel and real frames (either mask may be dropped), fp32
    softmax, p rounded to ``cdt``, o rounded to v's dtype; stored back
    clipped to T and P."""
    cdt = v.dtype if cdt is None else cdt
    b, t, p, inner = q.shape
    d, tb = inner // heads, pl.t_box
    span = pl.ptiles * pl.pixels

    def tiles(z):  # (B, span, t_box, inner), zero rows past T and P
        out = z.new_zeros(b, span, tb, inner)
        out[:, :p, :t] = z.transpose(1, 2)
        return out

    qt, kt, vt = tiles(q), tiles(k), tiles(v)
    out = torch.full((b, span, tb, inner), float("nan"), dtype=v.dtype)
    r = torch.arange(pl.rows)
    keep = torch.ones(pl.rows, pl.rows, dtype=torch.bool)
    if same_pixel:
        keep &= r[:, None] // tb == r[None, :] // tb
    if real_frame:
        keep &= r[None, :] % tb < t
    for u in range(pl.units):
        bi, px0, h = pl.unit(u, heads)
        cols = slice(h * d, (h + 1) * d)
        px = slice(px0, px0 + pl.pixels)
        rows = [z[bi, px, :, cols].reshape(-1, d) for z in (qt, kt, vt)]
        o = torch.empty(pl.pixels * tb, d, dtype=v.dtype)
        for w in range(pl.warps):
            ws = slice(w * pl.rows, (w + 1) * pl.rows)
            qw, kw, vw = (z[ws].float() for z in rows)
            logits = (qw @ kw.T * scale).masked_fill(~keep, float("-inf"))
            probs = torch.softmax(logits, -1).to(cdt).float()
            o[ws] = (probs @ vw).to(v.dtype)
        out[bi, px, :, cols] = o.reshape(pl.pixels, tb, d)
    return out[:, :p, :t].transpose(1, 2)


def _ptc_inputs(t, p, inner, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(2, t, p, 3 * inner)).astype(np.float32)
    return qkv, torch.from_numpy(qkv).to(dtype).chunk(3, dim=-1)


def _jax_ptc(qkv, inner, heads, scale, dtype):
    jq, jk, jv = (jnp.asarray(qkv[..., i * inner:(i + 1) * inner]
                              ).transpose(0, 2, 1, 3).astype(dtype)
                  for i in range(3))
    out = jta._ptc_kernel_call(jq, jk, jv, heads=heads, scale=scale)
    return np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("t,d", [(3, 64), (8, 64), (16, 64), (32, 64),
                                 (8, 128)])
def test_ptc_emulation_matches_plain_and_interpret_kernel(monkeypatch, t,
                                                          d):
    monkeypatch.setattr(jta, "_INTERPRET", True)
    heads, p = 2, 24  # 24 pixels: a ragged last tile at every t_box
    inner = heads * d
    qkv, (q, k, v) = _ptc_inputs(t, p, inner, seed=t + d)
    pl = ta.ptc_plan(2, t, p, inner, heads)
    got = emulate_ptc(q, k, v, heads, d ** -0.5, pl).numpy()
    assert np.isfinite(got).all()
    tol = 1e-5 * np.abs(got).max()
    np.testing.assert_allclose(
        got, ta._xla_ptc(q, k, v, heads, d ** -0.5).numpy(), rtol=0,
        atol=tol)
    np.testing.assert_allclose(
        got, _jax_ptc(qkv, inner, heads, d ** -0.5, jnp.float32), rtol=0,
        atol=tol)


def test_ptc_emulation_bf16_matches_the_interpret_kernel(monkeypatch):
    monkeypatch.setattr(jta, "_INTERPRET", True)
    t, p, heads, d = 3, 16, 2, 64
    qkv, (q, k, v) = _ptc_inputs(t, p, heads * d, 9, torch.bfloat16)
    qkv = torch.from_numpy(qkv).bfloat16().float().numpy()
    got = emulate_ptc(q, k, v, heads, 0.125,
                      ta.ptc_plan(2, t, p, heads * d, heads))
    want = _jax_ptc(qkv, heads * d, heads, 0.125, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("t,drop", [(8, "same_pixel"), (4, "same_pixel"),
                                    (3, "real_frame"), (20, "real_frame")])
def test_ptc_emulation_needs_each_mask(t, drop):
    """Dropping a mask moves the output where it can show (the neighbour
    pixel where 16 / T pixels share a warp's rows, the zero frames where
    T does not divide 16): what the card's broken builds of #11 drop."""
    _, (q, k, v) = _ptc_inputs(t, 16, 128, seed=1)
    pl = ta.ptc_plan(2, t, 16, 128, 2)
    want = ta._xla_ptc(q, k, v, 2, 0.125)
    got = emulate_ptc(q, k, v, 2, 0.125, pl, **{drop: False})
    assert (got - want).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# #17: the plan
# ---------------------------------------------------------------------------

def _blocks_cover_once(pl: ca.Plan, b: int, heads: int):
    """Every (b, h, query tile) in exactly one block's range, walked in
    order; each block's units one a (b, h), so its K/V loads happen only
    where its range enters another (b, h); the heads of a range run on
    consecutive blocks over the same (b, tile) indices."""
    assert pl.heads == heads and pl.span == b * pl.qtiles
    assert pl.grid == heads * pl.blocks
    seen = np.zeros(b * heads * pl.qtiles, np.int64)
    loads = 0
    for i in range(pl.grid):
        h, lo, hi = pl.block_range(i)
        assert lo < hi and h == i % heads
        assert pl.block_range(i - h)[1:] == (lo, hi)
        units = pl.units(i)
        bhs = [u[0] for u in units]
        assert bhs == sorted(set(bhs)) and all(bh % heads == h for bh in bhs)
        f = lo
        for bh, qt, n in units:
            assert (bh // heads) * pl.qtiles + qt == f
            assert 0 < n <= pl.qtiles - qt
            seen[bh * pl.qtiles + qt:bh * pl.qtiles + qt + n] += 1
            f += n
        assert f == hi
        loads += len(units)
    assert (seen == 1).all()
    return loads


@pytest.mark.parametrize("label,sq,c", kc.ATTN2_512)
def test_dual_plan_at_the_path_shapes(label, sq, c):
    b, heads = 32, c // 64
    pl = ca.plan(b, sq, c, 77, 16)
    assert pl.resident and (pl.text_tiles, pl.image_tiles) == (1, 1)
    assert pl.slot == 2 * (80 + 16) * 128 and pl.kvslots == 2
    assert pl.smem <= SMEM and 2 * (pl.smem + 1024) <= 228 * 1024
    assert pl.grid == heads * (264 // heads) and pl.qtiles == -(-sq // 64)
    loads = _blocks_cover_once(pl, b, heads)
    # K/V read about once a (b, h) and a block: far fewer than the tiles
    assert b * heads <= loads <= b * heads + pl.grid < b * heads * pl.qtiles
    # every block range spans more than one (b, h) somewhere (the card's
    # test of a build that keeps the first K/V shows at every shape)
    assert max(len(pl.units(i)) for i in range(pl.grid)) >= 2


@pytest.mark.parametrize("b,sq,c,lt,li,resident,tiles", [
    (2, 64, 192, 100, 32, True, (2, 2)),
    (2, 37, 192, 1, 1, True, (1, 1)),
    (2, 130, 192, 300, 40, False, (4, 3)),
    (2, 512, 128, 1024, 1024, False, (13, 64)),
])
def test_dual_plan_at_the_card_test_shapes(b, sq, c, lt, li, resident,
                                           tiles):
    pl = ca.plan(b, sq, c, lt, li)
    assert pl.resident == resident
    assert (pl.text_tiles, pl.image_tiles) == tiles
    assert pl.text_tiles * 80 >= lt and pl.image_tiles * 16 >= li
    assert pl.slot == (2 * (tiles[0] * 80 + tiles[1] * 16) * 128 if resident
                       else 2 * 80 * 128)
    assert pl.kvslots == (2 if resident else 4) and pl.smem <= SMEM
    _blocks_cover_once(pl, b, c // 64)


@pytest.mark.parametrize("c,heads", [(96, 1), (256, 2), (0, 1)])
def test_dual_plan_refuses_heads_other_than_64(c, heads):
    if c % 64 or c == 0:
        with pytest.raises(ValueError):
            ca.plan(2, 64, c, 77, 16)
    z = torch.zeros(2, 64, c, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the wrapper, before any launch
        ca._launch_dual(z, z, z, z, z, 0.5, heads, 0.125)


# ---------------------------------------------------------------------------
# #17: the key tiles, emulated
# ---------------------------------------------------------------------------

def emulate_dual(q, kt, vt, ki, vi, s_ip: float, heads: int, scale: float,
                 pl: ca.Plan, cdt=None):
    """#17 as the kernel computes a branch: key tiles of 80 text and 16
    image keys (zero rows past the context, masked), an online softmax in
    the exp2 domain rescaling at each tile, p rounded to ``cdt`` for the
    PV product, l over the unrounded p; acc / l in fp32, the combine in
    fp32, one rounding to q's dtype."""
    cdt = q.dtype if cdt is None else cdt
    b, sq, c = q.shape
    d = c // heads
    s2 = scale * ca._LOG2E

    def fold(z):  # (B H, S, d) fp32
        return z.float().reshape(b, z.shape[1], heads, d).transpose(
            1, 2).reshape(b * heads, z.shape[1], d)

    def branch(kk, vv, tile, ntiles):
        qh, kh, vh = fold(q), fold(kk), fold(vv)
        n = kh.shape[1]
        m = torch.full((b * heads, sq, 1), float("-inf"))
        l = torch.zeros(b * heads, sq, 1)
        acc = torch.zeros(b * heads, sq, d)
        for j in range(ntiles):
            ks = torch.zeros(b * heads, tile, d)
            vs = torch.zeros(b * heads, tile, d)
            rows = slice(j * tile, min(n, (j + 1) * tile))
            ks[:, :rows.stop - rows.start] = kh[:, rows]
            vs[:, :rows.stop - rows.start] = vh[:, rows]
            s = qh @ ks.transpose(1, 2) * s2
            s[..., rows.stop - rows.start:] = float("-inf")
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            mu = torch.where(mx == float("-inf"), 0.0, mx)
            corr = torch.exp2(m - mu)
            p = torch.exp2(s - mu)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(cdt).float() @ vs
            m = mx
        return acc / l

    out = (branch(kt, vt, ca.TEXT_TILE, pl.text_tiles)
           + s_ip * branch(ki, vi, ca.IMAGE_TILE, pl.image_tiles))
    return out.reshape(b, heads, sq, d).transpose(1, 2).reshape(
        b, sq, c).to(q.dtype)


def _dual_mats(seed, sq, lt, li, c, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32)
            for n in (sq, lt, lt, li, li)]


def _jax_dual(mats, s_ip, heads, dtype):
    c = mats[0].shape[-1]
    old = jca._INTERPRET
    jca._INTERPRET = True
    try:
        out = jca._dual_kernel_call(
            *(jnp.asarray(m).astype(dtype) for m in mats),
            jnp.full((1, 1), s_ip, jnp.float32), heads, (c // heads) ** -0.5,
            jca._pick_blk(mats[0].shape[1]))
    finally:
        jca._INTERPRET = old
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("lt,li", [(200, 40), (77, 16), (1, 1)])
def test_dual_emulation_matches_plain_and_interpret_kernel(lt, li):
    """The streamed branch's shapes (3 text and 3 image tiles: two
    rescales a branch) and the resident ones."""
    sq, c, heads = 128, 128, 2
    mats = _dual_mats(lt + li, sq, lt, li, c)
    ts = [torch.from_numpy(m) for m in mats]
    pl = ca.plan(2, sq, c, lt, li)
    assert pl.resident == (lt < 200)
    got = emulate_dual(*ts, 0.73, heads, 0.125, pl).numpy()
    np.testing.assert_allclose(
        got, ca._plain_dual(*ts, 0.73, heads, 0.125).numpy(), rtol=0,
        atol=3e-5)
    np.testing.assert_allclose(got, _jax_dual(mats, 0.73, heads,
                                              jnp.float32), rtol=0,
                               atol=3e-5)


def test_dual_emulation_bf16_matches_the_interpret_kernel():
    sq, c, heads, lt, li = 128, 128, 2, 200, 40
    mats = [torch.from_numpy(m).bfloat16()
            for m in _dual_mats(3, sq, lt, li, c)]
    got = emulate_dual(*mats, 0.73, heads, 0.125,
                       ca.plan(2, sq, c, lt, li)).float().numpy()
    want = _jax_dual([m.float().numpy() for m in mats], 0.73, heads,
                     jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
