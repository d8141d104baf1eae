"""The port's fused temporal (3,1,1) conv (plain version, CPU) against the
JAX package's Pallas kernel ``_pallas_tconv`` in interpret mode: C = 64,
the folded GroupNorm affine + SiLU prologue, ``out_scale``, the residual
and the per-frame stats.

Bounds: in fp32 the two compute the same products and differ only in
summation order, 1e-5 of max |y| (sums: 1e-5 of the sum of |y| or y^2). In
bf16 both round z once after the fp32 SiLU and y once at the end; a
rounding that flips between the two orders moves an element by one bf16
ulp, so 1 ulp of max |y| anywhere and 1% of the elements off at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import temporal_conv as jtc
from tooncrafter_tpu.ops.norms import gn_affine as jax_gn_affine
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import temporal_conv as tc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

B, T, H, W, C = 2, 4, 8, 8, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    return dict(x=f(B, T, H, W, C, sc=2.0, off=0.5),
                w=f(3, C, C, sc=(3 * C) ** -0.5), b=f(C, sc=0.1),
                gw=f(C, sc=0.2, off=1.0), gb=f(C, sc=0.1),
                res=f(B, T, H, W, C), scale=np.float32(0.3))


def _jax(p, dtype):
    x = jnp.asarray(p["x"]).astype(dtype)
    aff = jax_gn_affine(x, jnp.asarray(p["gw"]), jnp.asarray(p["gb"]),
                        32, 1e-5)
    y, s1, s2 = jtc.temporal_conv3(
        x, jnp.asarray(p["w"]).astype(dtype),
        jnp.asarray(p["b"]).astype(dtype), affine=aff, silu=True,
        residual=jnp.asarray(p["res"]).astype(dtype),
        out_scale=jnp.asarray(p["scale"]), return_stats=True)
    return [np.asarray(v, np.float32) for v in (y, s1, s2)]


def _port(p, dtype):
    x = torch.from_numpy(p["x"]).to(dtype)
    aff = norms.gn_affine(x, torch.from_numpy(p["gw"]),
                          torch.from_numpy(p["gb"]), 32, 1e-5)
    # JAX (3, Cin, Cout) -> nn.Conv3d (Cout, Cin, 3, 1, 1)
    weight = torch.from_numpy(p["w"]).permute(2, 1, 0)[..., None, None]
    y, s1, s2 = tc.temporal_conv3(
        x, weight.to(dtype), torch.from_numpy(p["b"]).to(dtype), aff,
        silu=True, residual=torch.from_numpy(p["res"]).to(dtype),
        out_scale=torch.tensor(p["scale"]), return_stats=True)
    return [v.float().numpy() for v in (y, s1, s2)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jtc, "_INTERPRET", True)
    assert jtc._use_kernel(T, H * W, C, C)


def test_plain_matches_the_interpret_kernel_fp32(interpret):
    p = _inputs(0)
    (y, s1, s2), (ry, r1, r2) = _port(p, torch.float32), _jax(p, jnp.float32)
    assert y.shape == ry.shape and s1.shape == r1.shape == (B, T, C)
    np.testing.assert_allclose(y, ry, rtol=0, atol=1e-5 * np.abs(ry).max())
    np.testing.assert_allclose(s1, r1, rtol=0,
                               atol=1e-5 * np.abs(ry).sum((2, 3)).max())
    np.testing.assert_allclose(s2, r2, rtol=0, atol=1e-5 * r2.max())


def test_plain_matches_the_interpret_kernel_bf16(interpret):
    """The cast point: z = silu(x * A + B) in fp32, rounded once to bf16
    (not the spatial conv's round-before-SiLU)."""
    p = _inputs(1)
    (y, s1, s2), (ry, r1, r2) = _port(p, torch.bfloat16), _jax(
        p, jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ry).max())) - 7)
    diff = np.abs(y - ry)
    assert diff.max() <= ulp, diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    # the sums are of each side's own rounded output
    np.testing.assert_allclose(s1, y.sum((2, 3)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2, (y * y).sum((2, 3)), rtol=1e-5)


def test_zero_padding_is_of_z_not_x():
    """At t = -1 and t = T the conv sees zeros of z = silu(x A + B), not
    the prologue applied to a zero x (silu(B) != 0)."""
    x = torch.zeros(1, 3, 1, 1, 32)
    a = torch.ones(1, 32)
    b = torch.full((1, 32), 2.0)          # z = silu(2) everywhere inside
    weight = torch.zeros(32, 32, 3, 1, 1)
    weight[:, :, 0] = weight[:, :, 2] = 1.0 / 32
    y = tc.temporal_conv3(x, weight, torch.zeros(32), (a, b), silu=True)
    z = torch.nn.functional.silu(torch.tensor(2.0))
    # frame 0 sees only frame 1 through tap 2; frame 1 both neighbours
    torch.testing.assert_close(y[0, :, 0, 0, 0], torch.stack([z, 2 * z, z]))


def test_module_fused_matches_its_plain_forward():
    """TemporalConv3.fused(x, affine) == forward(silu(gn(x))) with the
    residual and scale in the epilogue."""
    torch.manual_seed(0)
    conv = tc.TemporalConv3(64, 64)
    gn = norms.GroupNorm(64, 1e-5, act=True)
    x = torch.randn(2, 5, 3, 4, 64)
    res = torch.randn(2, 5, 3, 4, 64)
    s = torch.tensor(0.7)
    with torch.no_grad():
        got, s1, s2 = conv.fused(x, gn.folded(x), residual=res, out_scale=s,
                                 return_stats=True)
        want = conv(gn(x), residual=res, out_scale=s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, want.sum((2, 3)), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s2, want.square().sum((2, 3)), rtol=1e-5,
                               atol=1e-4)


# (B, T, P, Cin, Cout): (rows, width, tiles, grid, slots) of ``tc.plan`` on
# the H100's 132 SMs, at every shape a 320x512 or 576x1024 request
# launches #12 at (``kernel_check.TCONV_512``, ``TCONV_1024``)
PLANS = {
    (2, 16, 2560, 320, 320): (128, 160, 1280, 132, 20),
    (2, 16, 640, 640, 640): (128, 160, 640, 132, 5),
    (2, 16, 160, 1280, 1280): (128, 160, 320, 132, 2),
    (2, 16, 40, 1280, 1280): (64, 160, 160, 132, 2),
    (1, 16, 163840, 128, 128): (128, 128, 20480, 132, 1280),
    (1, 16, 40960, 256, 256): (128, 128, 10240, 132, 320),
    (1, 16, 10240, 512, 512): (128, 128, 5120, 132, 80),
    (1, 16, 2560, 512, 512): (128, 128, 1280, 132, 20),
    (2, 16, 9216, 320, 320): (128, 160, 4608, 132, 72),
    (2, 16, 2304, 640, 640): (128, 160, 2304, 132, 18),
    (2, 16, 576, 1280, 1280): (128, 160, 1152, 132, 5),
    (2, 16, 144, 1280, 1280): (128, 160, 288, 132, 2),
    (1, 16, 589824, 128, 128): (128, 128, 73728, 132, 4608),
    (1, 16, 147456, 256, 256): (128, 128, 36864, 132, 1152),
    (1, 16, 36864, 512, 512): (128, 128, 18432, 132, 288),
    (1, 16, 9216, 512, 512): (128, 128, 4608, 132, 72),
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_tiles_grid_and_scratch(shape):
    """128-row tiles unless they give fewer tiles than SMs (ds8: 80), then
    64; 160 output channels where Cout allows; the framed z (B, T + 2, P,
    Cin); the sums' slots: the most row tiles one frame touches."""
    bsz, t, p, cin, cout = shape
    pl = tc.plan(*shape)
    assert (pl.rows, pl.width, pl.tiles, pl.grid, pl.sums[2]) == PLANS[shape]
    assert pl.z == (bsz, t + 2, p, cin)
    assert pl.sums == (bsz, t, PLANS[shape][-1], cout)
    assert pl.tiles == bsz * -(-(t * p) // pl.rows) * -(-cout // pl.width)


def test_plans_cover_every_kernel_check_shape():
    """The shapes and epilogues phase 2 checks #12 at (``kernel_check``)
    are those the models launch it with (the launch tables of the
    selector tests, which hold them to the models), and each shape has its
    pinned plan here."""
    from test_torch_selectors_1024 import TCONV_BY_SHAPE_1024
    from test_torch_selectors_switched import TCONV_BY_SHAPE_512
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    shapes = set()
    for rows, table in ((kc.TCONV_512, TCONV_BY_SHAPE_512),
                        (kc.TCONV_1024, TCONV_BY_SHAPE_1024)):
        checked = [(b, t, p, c, res, scale, stats)
                   for _, (b, t, p, c), res, scale, stats in rows]
        launched = {(bsz, 16) + key for part, bsz in (("unet", 2),
                                                      ("vae", 1))
                    for key in table[part]}
        assert len(checked) == len(set(checked))
        assert set(checked) == launched
        shapes |= {k[:4] + k[3:4] for k in checked}
    assert shapes == set(PLANS)


def _kernel_sums_writes(t, p, rows, slots):
    """Which (frame, slot) each row tile of one sample writes in the
    kernel's epilogue (csrc/temporal_conv.cu ``frame_sums``): its sums of
    each frame it holds rows of at slot tile - first(frame), and, in the
    tile that holds a frame's last row, zeros in the slots past its own."""
    writes = []
    for mt in range(-(-(t * p) // rows)):
        m0 = mt * rows
        n = min(rows, t * p - m0)
        f, r = m0 // p, 0
        while r < n:
            fend = (f + 1) * p - m0
            slot = mt - f * p // rows
            writes.append((f, slot))
            if fend <= n:
                writes += [(f, s) for s in range(slot + 1, slots)]
            r, f = min(n, fend), f + 1
    return writes


@pytest.mark.parametrize("t,p", [(16, 2560), (16, 40), (16, 160), (3, 37),
                                 (3, 1), (5, 33), (16, 144), (2, 64),
                                 (4, 96)])
def test_every_sums_slot_is_written_exactly_once(t, p):
    """The caller sums (B, T, slots, Cout) over the slots of an
    uninitialised buffer: every (frame, slot) must be written by exactly
    one tile, at any P (frames that straddle tiles, tiles that hold many
    frames, a ragged last tile)."""
    pl = tc.plan(1, t, p, 64, 64)
    writes = _kernel_sums_writes(t, p, pl.rows, pl.sums[2])
    assert sorted(writes) == [(f, s) for f in range(t)
                              for s in range(pl.sums[2])]


def test_plan_refuses_what_the_kernels_do_not_take():
    for shape in ((2, 16, 40, 36, 64), (2, 16, 40, 64, 36),
                  (2, 16, 40, 16384, 64), (3000, 20, 40, 64, 64),
                  (2, 0, 40, 64, 64)):
        with pytest.raises(ValueError, match="temporal conv kernels"):
            tc.plan(*shape)


def test_breakdown_bounds_of_the_two_kernels():
    """``utils/breakdown``'s #12 bounds: the z pass by its bytes (x read,
    the framed z written); the GEMM by its operations, but by its bytes
    (the framed z read once, y written, the residual read) at the
    decoder's level 0 (C = 128) and in the residual calls at C = 256 and
    320 (294 operations a byte at C = 320, the card's ratio 295); their
    sum above the call's bound."""
    from tooncrafter_tpu_torch.utils import breakdown as bd
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    for label, (b, t, p, c), res, _, stats in kc.TCONV_512 + kc.TCONV_1024:
        got = bd.tconv_bounds(b, t, p, c, res, stats)
        framed = 2.0 * b * (t + 2) * p * c
        assert got["zpass"] == pytest.approx(
            (2.0 * b * t * p * c + framed + 8.0 * b * c)
            / kc.PEAK_BYTES_PER_S * 1e3)
        by_ops = got["gemm"] == pytest.approx(
            kc.tconv_flops(b, t, p, c) / kc.PEAK_BF16_FLOPS * 1e3)
        assert by_ops == (c > 128 and not (res and c <= 320)), label
        call = kc.bound(kc.tconv_flops(b, t, p, c),
                        kc.tconv_bytes(b, t, p, c, res, stats))[0]
        assert got["zpass"] + got["gemm"] > call
