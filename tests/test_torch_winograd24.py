"""The port's ``winograd24_gn_silu_conv3x3`` (on CPU tensors: its plain
version) against the JAX package's F(2x4) Winograd kernel
``winograd24_gn_silu_conv3x3`` in interpret mode, an entry of its allowlist
``_TABLE24`` patched in at a small shape as tests/test_winograd.py does;
and where the port counts a launch under that name.

Bounds. fp32: 2e-4 of max |y| (the sums: of the sum of |y|, of the largest
sum of y^2), the bar the JAX package holds the F(2x4) kernel to against the
direct formula. bf16: the port rounds z at the "ref" cast point and y once,
so it lies within half a bf16 ulp (<= 2^-8 |y|) of the fp32 formula on the
same rounded operands; the F(2x4) kernel also rounds its transformed
weights to bf16, which the JAX package measured at 0.99% of the output
scale at the 36x64x640 shape (ops/winograd.py:361-365). So the two may
differ by 2^-8 |y| + 1% of max |y| anywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import norms as jnorms
from tooncrafter_tpu.ops import winograd as wg
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import spatial_conv as sc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

N, H, W, CIN, COUT = 2, 8, 8, 128, 128
F24 = "winograd24_gn_silu_conv3x3"


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc_=1.0, off=0.0: (rng.normal(size=s) * sc_
                                      + off).astype(np.float32)
    return dict(x=f(N, H, W, CIN, sc_=2.0, off=0.5),
                gw=f(CIN, sc_=0.2, off=1.0), gb=f(CIN, sc_=0.1),
                k=f(3, 3, CIN, COUT, sc_=(9 * CIN) ** -0.5),
                bias=f(COUT, sc_=0.1), res=f(N, H, W, COUT))


@pytest.fixture
def f24(monkeypatch):
    monkeypatch.setitem(wg._TABLE24, (H, W, CIN, COUT), (2, 0, True, 0))
    monkeypatch.setattr(wg, "_INTERPRET", True)


def _jax(p, dtype, silu, stats, use_res):
    x = jnp.asarray(p["x"]).astype(dtype)
    a, b = jnorms.gn_affine(x, jnp.asarray(p["gw"]), jnp.asarray(p["gb"]),
                            32, 1e-5)
    out = wg.winograd24_gn_silu_conv3x3(
        x, a, b, jnp.asarray(p["k"]).astype(dtype),
        jnp.asarray(p["bias"]).astype(dtype),
        jnp.asarray(p["res"]).astype(dtype) if use_res else None, silu, stats)
    return [np.asarray(v, np.float32) for v in (out if stats else (out,))]


def _port(p, dtype, silu, stats, use_res):
    x = torch.from_numpy(p["x"]).to(dtype)
    a, b = norms.gn_affine(x, torch.from_numpy(p["gw"]),
                           torch.from_numpy(p["gb"]), 32, 1e-5)
    # HWIO -> nn.Conv2d's (O, I, kh, kw)
    weight = torch.from_numpy(p["k"]).permute(3, 2, 0, 1).to(dtype)
    bias = torch.from_numpy(p["bias"]).to(dtype)
    res = torch.from_numpy(p["res"]).to(dtype) if use_res else None
    out = sc.winograd24_gn_silu_conv3x3(x, a, b, weight, bias, res,
                                        silu=silu, stats=stats)
    truth = sc._plain_conv3x3(x.float(), a, b, weight.float(), bias.float(),
                              None if res is None else res.float(), silu,
                              False, cdt=dtype)
    return ([v.float().numpy() for v in (out if stats else (out,))],
            truth.numpy())


@pytest.mark.parametrize("silu,stats,use_res", [(True, True, True),
                                                (False, True, False),
                                                (True, False, False)],
                         ids=["silu-stats-residual", "no-silu-stats",
                              "silu"])
def test_plain_matches_the_f24_interpret_kernel_fp32(f24, silu, stats,
                                                     use_res):
    p = _inputs(0)
    got, _ = _port(p, torch.float32, silu, stats, use_res)
    want = _jax(p, jnp.float32, silu, stats, use_res)
    assert len(got) == len(want) == (3 if stats else 1)
    y, ry = got[0], want[0]
    assert y.shape == ry.shape == (N, H, W, COUT)
    np.testing.assert_allclose(y, ry, rtol=0, atol=2e-4 * np.abs(ry).max())
    if stats:
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=2e-4 * np.abs(ry).sum((1, 2)).max())
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=2e-4 * want[2].max())


def test_bf16_within_the_f24_rounding(f24):
    p = _inputs(1)
    (y,), truth = _port(p, torch.bfloat16, True, False, True)
    (ry,) = _jax(p, jnp.bfloat16, True, False, True)
    top = np.abs(truth).max()
    # the port: its last rounding only
    assert (np.abs(y - truth) <= 2.0 ** -8 * np.abs(truth) + 1e-6).all()
    # the F(2x4) kernel: that rounding and its transformed weights'
    bound = 2.0 ** -8 * np.abs(truth) + 0.01 * top
    assert (np.abs(y - ry) <= bound).all(), np.abs(y - ry).max()
    # it is a different rounding, not the same computation
    assert np.abs(y - ry).max() > 0


def test_names_f24_exactly_at_the_table_key(monkeypatch):
    monkeypatch.setattr(wg, "_WINOGRAD", True)
    monkeypatch.setattr(wg, "_WINOGRAD24", True)
    assert sc._TABLE24 == set(wg._TABLE24)
    shapes = [(36, 64, 640, 640), (36, 64, 320, 640), (36, 64, 1920, 640),
              (36, 64, 1280, 640), (36, 64, 960, 640), (72, 128, 320, 320),
              (18, 32, 1280, 1280), (9, 16, 1280, 1280), (20, 32, 640, 640),
              (10, 16, 1280, 1280), (40, 64, 320, 320)]
    for shape in shapes:
        f24_jax = bool(wg.table_entry24(*shape))
        assert sc.table_entry24(*shape) == f24_jax, shape
        assert (sc.conv_kernel_name(*shape) == F24) == f24_jax, shape
    assert sc.conv_kernel_name(36, 64, 640, 640) == F24
    # keys the 2-row / 4-column tiling gates refuse are never F(2x4)
    for key in [(10, 18, 128, 128), (9, 16, 128, 128), (36, 66, 640, 640)]:
        monkeypatch.setitem(wg._TABLE24, key, (1, 0, False, 0))
        monkeypatch.setattr(sc, "_TABLE24", sc._TABLE24 | {key})
        assert wg.table_entry24(*key) is None
        assert not sc.table_entry24(*key)
        assert sc.conv_kernel_name(*key) == "winograd_gn_silu_conv3x3"

