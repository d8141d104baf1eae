"""The port's fused GroupNorm-affine + SiLU + 3x3 conv (plain version, CPU)
against the JAX package's Pallas kernel ``winograd_gn_silu_conv3x3`` in
interpret mode (a ``_TABLE`` entry patched in for the test shape), with the
residual and the stats epilogue; the "ref" cast point in bf16; and the
folded GroupNorm affine with a shift.

Bounds: in fp32 the Winograd kernel is held to 1e-4 of the direct formula
by the JAX package's own test (tests/test_winograd.py), and the port is a
direct conv, so 1e-4 of max |y| (sums: 1e-4 of the sum of |y| or y^2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tooncrafter_tpu.ops import norms as jnorms
from tooncrafter_tpu.ops import winograd as wg
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import spatial_conv as sc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

N, H, W, CIN, COUT = 2, 8, 8, 128, 128


def _inputs(seed, cin=CIN, cout=COUT):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc_=1.0, off=0.0: (rng.normal(size=s) * sc_
                                      + off).astype(np.float32)
    return dict(x=f(N, H, W, cin, sc_=2.0, off=0.5),
                gw=f(cin, sc_=0.2, off=1.0), gb=f(cin, sc_=0.1),
                k=f(3, 3, cin, cout, sc_=(9 * cin) ** -0.5),
                bias=f(cout, sc_=0.1), res=f(N, H, W, cout))


@pytest.fixture
def winograd(monkeypatch):
    monkeypatch.setitem(wg._TABLE, (H, W, CIN, COUT), (2, 0, True, 0))
    monkeypatch.setattr(wg, "_INTERPRET", True)


def _jax(p, dtype):
    x = jnp.asarray(p["x"]).astype(dtype)
    a, b = jnorms.gn_affine(x, jnp.asarray(p["gw"]), jnp.asarray(p["gb"]),
                            32, 1e-5)
    y, s1, s2 = wg.winograd_gn_silu_conv3x3(
        x, a, b, jnp.asarray(p["k"]).astype(dtype),
        jnp.asarray(p["bias"]).astype(dtype),
        jnp.asarray(p["res"]).astype(dtype), True, True)
    return [np.asarray(v, np.float32) for v in (y, s1, s2)]


def _port(p, dtype):
    x = torch.from_numpy(p["x"]).to(dtype)
    a, b = norms.gn_affine(x, torch.from_numpy(p["gw"]),
                           torch.from_numpy(p["gb"]), 32, 1e-5)
    # HWIO -> nn.Conv2d's (O, I, kh, kw)
    weight = torch.from_numpy(p["k"]).permute(3, 2, 0, 1).to(dtype)
    y, s1, s2 = sc.winograd_gn_silu_conv3x3(
        x, a, b, weight, torch.from_numpy(p["bias"]).to(dtype),
        torch.from_numpy(p["res"]).to(dtype), silu=True, stats=True)
    return [v.float().numpy() for v in (y, s1, s2)], (x, a, b, weight)


def test_plain_matches_the_interpret_kernel_fp32(winograd):
    p = _inputs(0)
    (y, s1, s2), _ = _port(p, torch.float32)
    ry, r1, r2 = _jax(p, jnp.float32)
    assert y.shape == ry.shape and s1.shape == r1.shape == (N, COUT)
    np.testing.assert_allclose(y, ry, rtol=0, atol=1e-4 * np.abs(ry).max())
    np.testing.assert_allclose(s1, r1, rtol=0,
                               atol=1e-4 * np.abs(ry).sum((1, 2)).max())
    np.testing.assert_allclose(s2, r2, rtol=0, atol=1e-4 * r2.max())


def test_ref_cast_point_in_bf16(winograd):
    """bf16: x * A + B in fp32 rounds to bf16, SiLU runs in fp32 on the
    rounded value and rounds once more: the Winograd kernel's prologue.
    Then the whole conv against the kernel with fp32 transforms (which
    keeps z unrounded): |dy| <= 2^-8 (|w| * (|u| + |z|)) for z's rounding
    (and a rare flip of u's), plus 2^-8 |y| for the two outputs' own
    roundings."""
    p = _inputs(1)
    (y, _, _), (x, a, b, weight) = _port(p, torch.bfloat16)
    z = sc._prologue(x, a, b, True, torch.bfloat16)
    u = x.float() * a[:, None, None] + b[:, None, None]
    want = np.asarray(wg._make_prologue(jnp.bfloat16, True)(
        jnp.asarray(u.numpy())).astype(jnp.bfloat16), np.float32)
    diff = np.abs(z.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff <= ulp).all() and (diff > 0).mean() <= 1e-3
    # rounding before the SiLU is not the same as after it
    assert (z != F.silu(u).to(torch.bfloat16)).any()

    ry, _, _ = _jax(p, jnp.bfloat16)
    w_abs = weight.float().abs()
    spread = F.conv2d((u.abs() + F.silu(u).abs()).permute(0, 3, 1, 2),
                      w_abs, padding=1).permute(0, 2, 3, 1).numpy()
    bound = 2.0 ** -8 * (spread + np.abs(ry)) + 1e-6
    assert (np.abs(y - ry) <= bound).all(), np.abs(y - ry).max()


def test_halo_is_the_zero_of_z():
    """Outside the image the conv reads z = 0, not silu(B)."""
    x = torch.zeros(1, 3, 3, 32)
    a, b = torch.ones(1, 32), torch.full((1, 32), 2.0)
    weight = torch.full((8, 32, 3, 3), 1.0 / 32)
    y = sc.winograd_gn_silu_conv3x3(x, a, b, weight, torch.zeros(8))
    z = F.silu(torch.tensor(2.0))
    taps = torch.tensor([[4.0, 6.0, 4.0], [6.0, 9.0, 6.0], [4.0, 6.0, 4.0]])
    torch.testing.assert_close(y[0, :, :, 0], taps * z)


def test_gn_affine_with_shift_matches_group_norm_of_the_shifted_input():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 5, 64)).astype(np.float32) * 3 + 1
    e = rng.normal(size=(2, 64)).astype(np.float32)
    gw = (1 + 0.2 * rng.normal(size=64)).astype(np.float32)
    gb = (0.1 * rng.normal(size=64)).astype(np.float32)
    xt = torch.from_numpy(x)
    s1, s2 = norms.channel_sums(xt)
    a, b = norms.gn_affine_from_stats(s1, s2, 20, torch.from_numpy(gw),
                                      torch.from_numpy(gb), 32, 1e-5,
                                      shift=torch.from_numpy(e))
    got = (xt * a[:, None, None] + b[:, None, None]).numpy()
    want = np.asarray(jnorms.group_norm(jnp.asarray(x + e[:, None, None]),
                                        jnp.asarray(gw), jnp.asarray(gb),
                                        32, 1e-5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 4)
    ja, jb = jnorms.gn_affine_from_stats(
        jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()), 20,
        jnp.asarray(gw), jnp.asarray(gb), 32, 1e-5, shift=jnp.asarray(e))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    # and the port's own shifted group_norm
    torch.testing.assert_close(
        torch.from_numpy(got), norms.group_norm(
            xt, torch.from_numpy(gw), torch.from_numpy(gb), 32, 1e-5,
            shift=torch.from_numpy(e)), rtol=0, atol=4e-5)
