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
