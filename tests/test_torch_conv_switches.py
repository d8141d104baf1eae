"""The JAX package's four conv switches in the port (``ops/spatial_conv``'s
module globals ``_WINOGRAD``, ``_WINOGRAD24``, ``_PROLOGUE_DTYPE``,
``_STATS_SQ_BF16``) against tooncrafter_tpu on the CPU.

* Under each setting (with ``TC_SPATIAL_CONV_PALLAS`` off and on), the
  kernel the port's dispatch names at every table shape (and two shapes off
  the tables) is the one the JAX ``_impl`` takes with its globals set the
  same way (its kernels stubbed to report their names; "on a TPU" via
  ``_dispatch.on_tpu`` and ``winograd._INTERPRET``); the UNet's
  ``gn_silu_conv3x3`` runs the kernel under that name, F(2x2)'s where the
  JAX package runs XLA, and the plain route under the "bf16" prologue.
* The plain route's prologue against the JAX ``_apply_prologue`` in bf16,
  within 1 bf16 ulp; its conv output and sums against the JAX
  ``_xla_impl`` at tests/test_torch_spatial_conv.py's bars (fp32: 1e-4 of
  max |y|, 1e-4 of the sum of |y| or y^2), and in bf16 within the two
  sides' roundings.
* #13's wrapper's plain version at the fp32 cast point against the JAX
  Winograd kernel in interpret mode under TC_PROLOGUE_DTYPE=f32.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu.ops import winograd as wg
from tooncrafter_tpu_torch.ops import spatial_conv as sc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

F22, F24, IM2COL = ("winograd_gn_silu_conv3x3", "winograd24_gn_silu_conv3x3",
                    "_pallas_fused_conv")
# every key of both tables, a 40x64 level (no table; #15's rule admits it)
# and an 8x12 one (neither)
SHAPES = sorted(set(sc._TABLE) | set(sc._TABLE24)) + [
    (40, 64, 320, 320), (8, 12, 1280, 1280)]
# (TC_WINOGRAD, TC_WINOGRAD24, TC_PROLOGUE_DTYPE, TC_STATS_SQ_BF16)
SETTINGS = [(True, True, "ref", False), (False, True, "ref", False),
            (True, False, "ref", False), (True, True, "f32", False),
            (True, True, "bf16", False), (True, True, "ref", True)]


def _set(mp, setting, pallas):
    winograd, winograd24, prologue, sq = setting
    for mod in (sc, jsc):
        mp.setattr(mod, "_PROLOGUE_DTYPE", prologue)
        mp.setattr(mod, "_STATS_SQ_BF16", sq)
        mp.setattr(mod, "_SPATIAL_CONV_PALLAS", pallas)
    for mod in (sc, wg):
        mp.setattr(mod, "_WINOGRAD", winograd)
        mp.setattr(mod, "_WINOGRAD24", winograd24)


def _jax_choice(mp, shape):
    """The kernel the JAX ``_impl`` takes at (H, W, Cin, Cout), or None."""
    mp.setattr(_dispatch, "on_tpu", lambda: True)
    mp.setattr(wg, "_INTERPRET", True)
    for mod, name in ((wg, F22), (wg, F24), (jsc, IM2COL)):
        mp.setattr(mod, name, lambda *a, n=name: n)
    mp.setattr(jsc, "_xla_impl", lambda *a: None)
    h, w, cin, cout = shape
    x = jnp.zeros((1, h, w, cin), jnp.bfloat16)
    a = jnp.ones((1, cin), jnp.float32)
    k = jnp.zeros((3, 3, cin, cout), jnp.bfloat16)
    return jsc._impl(x, a, a, k, jnp.zeros((cout,), jnp.bfloat16), None,
                     True, False)


@pytest.mark.parametrize("setting,pallas",
                         itertools.product(SETTINGS, (False, True)))
def test_dispatch_names_what_jax_takes(monkeypatch, setting, pallas):
    _set(monkeypatch, setting, pallas)
    prologue = setting[2]
    for shape in SHAPES:
        want = _jax_choice(monkeypatch, shape)
        assert sc.tpu_kernel(*shape) == want, (shape, setting, pallas)
        unet = want or (None if prologue == "bf16" else F22)
        assert sc.conv_kernel_name(*shape) == unet, shape
        rf = unet is not None and sc.round_first(unet)
        assert rf == (prologue == "ref" and unet != IM2COL), unet
    if setting == SETTINGS[0]:
        # the defaults: F(2x4) at its key, F(2x2) at the others
        assert sc.tpu_kernel(36, 64, 640, 640) == F24
    if not setting[0]:
        assert not any(sc.tpu_kernel(*s) in (F22, F24) for s in SHAPES)


def test_gn_silu_conv3x3_takes_the_plain_route_under_bf16(monkeypatch):
    """Under the "bf16" prologue a conv no kernel takes runs the JAX XLA
    form with the bf16 prologue; a kernel's name still launches the kernel
    (#15 under TC_SPATIAL_CONV_PALLAS=1)."""
    routes = []
    plain, dispatch = sc._xla_conv3x3, sc._dispatch
    monkeypatch.setattr(sc, "_xla_conv3x3", lambda *a: routes.append(
        "plain") or plain(*a))
    monkeypatch.setattr(sc, "_dispatch", lambda name, *a: routes.append(
        name) or dispatch(name, *a))
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    x = torch.randn(2, 8, 8, 64)
    aff = (torch.ones(2, 64), torch.zeros(2, 64))
    for setting, pallas, want in ((SETTINGS[0], False, F22),
                                  (SETTINGS[4], False, "plain"),
                                  (SETTINGS[4], True, IM2COL)):
        with monkeypatch.context() as mp:
            _set(mp, setting, pallas)
            with torch.no_grad():
                sc.gn_silu_conv3x3(x, aff, conv)
        assert routes.pop() == want


def _operands(seed, dtype, n=2, h=6, w=7, cin=64, cout=32):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0, off=0.0: (rng.normal(size=s) * k + off).astype(
        np.float32)
    return dict(x=f(n, h, w, cin, k=2.0, off=0.5), a=f(n, cin, k=0.3, off=1),
                b=f(n, cin, k=0.5), k=f(3, 3, cin, cout, k=(9 * cin) ** -0.5),
                bias=f(cout, k=0.1), res=f(n, h, w, cout))


def test_bf16_prologue_within_one_ulp_of_jax(monkeypatch):
    _set(monkeypatch, SETTINGS[4], False)
    p = _operands(0, None)
    x = torch.from_numpy(p["x"]).to(torch.bfloat16)
    got = sc._apply_prologue(x, torch.from_numpy(p["a"]),
                             torch.from_numpy(p["b"]), True, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jsc._apply_prologue(
        jnp.asarray(p["x"]).astype(jnp.bfloat16), jnp.asarray(p["a"]),
        jnp.asarray(p["b"]), True), np.float32)
    diff = np.abs(got.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff <= ulp).all()
    # (A, B) folded to bf16 is not the fp32 affine rounded once
    u = (x.float() * torch.from_numpy(p["a"])[:, None, None]
         + torch.from_numpy(p["b"])[:, None, None])
    assert (got != F.silu(u).to(torch.bfloat16)).any()


def _xla_pair(p, dtype, jdtype):
    args = dict(x=torch.from_numpy(p["x"]).to(dtype),
                a=torch.from_numpy(p["a"]), b=torch.from_numpy(p["b"]),
                weight=torch.from_numpy(p["k"]).permute(3, 2, 0, 1).to(dtype),
                bias=torch.from_numpy(p["bias"]).to(dtype),
                res=torch.from_numpy(p["res"]).to(dtype))
    got = sc._xla_conv3x3(*args.values(), True, True)
    want = jsc._xla_impl(*(jnp.asarray(p[k]).astype(jdtype)
                           if k not in ("a", "b") else jnp.asarray(p[k])
                           for k in ("x", "a", "b", "k", "bias", "res")),
                         silu=True, stats=True)
    return ([v.float().numpy() for v in got],
            [np.asarray(v, np.float32) for v in want])


@pytest.mark.parametrize("setting", SETTINGS[2:], ids=lambda s: "-".join(
    map(str, s)))
def test_plain_route_matches_jax_xla_impl(monkeypatch, setting):
    _set(monkeypatch, setting, False)
    p = _operands(1, None)
    (y, s1, s2), (ry, r1, r2) = _xla_pair(p, torch.float32, jnp.float32)
    np.testing.assert_allclose(y, ry, rtol=0, atol=1e-4 * np.abs(ry).max())
    np.testing.assert_allclose(s1, r1, rtol=0,
                               atol=1e-4 * np.abs(ry).sum((1, 2)).max())
    np.testing.assert_allclose(s2, r2, rtol=0, atol=1e-4 * r2.max())
    # bf16: the same cast points on both sides; y differs by the two convs'
    # own roundings (a few bf16 ulps of |y|), the sums by as much of their
    # scale, the squares by one bf16 rounding each under TC_STATS_SQ_BF16
    (y, s1, s2), (ry, r1, r2) = _xla_pair(p, torch.bfloat16, jnp.bfloat16)
    np.testing.assert_allclose(y, ry, rtol=0, atol=2.0 ** -6 * np.abs(
        ry).max())
    np.testing.assert_allclose(s1, r1, rtol=0,
                               atol=2.0 ** -6 * np.abs(ry).sum((1, 2)).max())
    np.testing.assert_allclose(s2, r2, rtol=2.0 ** -5)


def test_stats_square_in_bf16_rounds_each_square(monkeypatch):
    y = torch.tensor([[[[1.0 + 2.0 ** -7]]]], dtype=torch.bfloat16)
    w = torch.ones(1, 1, 3, 3, dtype=torch.bfloat16)
    args = (y, None, None, w, torch.zeros(1, dtype=torch.bfloat16), None,
            False, True)
    monkeypatch.setattr(sc, "_STATS_SQ_BF16", False)
    exact = sc._xla_conv3x3(*args)[2]
    monkeypatch.setattr(sc, "_STATS_SQ_BF16", True)
    rounded = sc._xla_conv3x3(*args)[2]
    assert exact.item() == (1.0 + 2.0 ** -7) ** 2
    assert rounded.item() == float(torch.tensor(
        exact.item()).to(torch.bfloat16))


def test_f32_cast_point_matches_the_interpret_winograd_kernel(monkeypatch):
    """TC_PROLOGUE_DTYPE=f32: #13's wrapper (its plain version) rounds z
    once, after the SiLU in fp32, as the JAX Winograd kernel's prologue does
    under "f32" (which keeps z in fp32 for its transforms): |dy| <=
    2^-8 (|w| * |z|) for z's rounding plus 2^-8 |y| for the outputs'."""
    h, w, c = 8, 8, 128
    monkeypatch.setitem(wg._TABLE, (h, w, c, c), (2, 0, True, 0))
    monkeypatch.setattr(wg, "_INTERPRET", True)
    _set(monkeypatch, SETTINGS[3], False)
    p = _operands(2, None, 2, h, w, c, c)
    x = torch.from_numpy(p["x"]).to(torch.bfloat16)
    a, b = torch.from_numpy(p["a"]), torch.from_numpy(p["b"])
    weight = torch.from_numpy(p["k"]).permute(3, 2, 0, 1).to(torch.bfloat16)
    bias = torch.from_numpy(p["bias"]).to(torch.bfloat16)
    res = torch.from_numpy(p["res"]).to(torch.bfloat16)
    y, s1, s2 = sc.winograd_gn_silu_conv3x3(x, a, b, weight, bias, res,
                                            silu=True, stats=True)
    u = x.float() * a[:, None, None] + b[:, None, None]
    z = sc._prologue(x, a, b, True, torch.bfloat16, round_first=False)
    assert torch.equal(z, F.silu(u).to(torch.bfloat16))
    assert (z != sc._prologue(x, a, b, True, torch.bfloat16)).any()
    jy, j1, j2 = (np.asarray(v, np.float32) for v in
                  wg.winograd_gn_silu_conv3x3(
                      jnp.asarray(p["x"]).astype(jnp.bfloat16),
                      jnp.asarray(p["a"]), jnp.asarray(p["b"]),
                      jnp.asarray(p["k"]).astype(jnp.bfloat16),
                      jnp.asarray(p["bias"]).astype(jnp.bfloat16),
                      jnp.asarray(p["res"]).astype(jnp.bfloat16), True, True))
    spread = F.conv2d(F.silu(u).abs().permute(0, 3, 1, 2),
                      weight.float().abs(), padding=1).permute(0, 2, 3, 1)
    bound = 2.0 ** -8 * (spread.numpy() + np.abs(jy)) + 1e-6
    assert (np.abs(y.float().numpy() - jy) <= bound).all()
    np.testing.assert_allclose(s1.numpy(), j1, rtol=0,
                               atol=2.0 ** -8 * np.abs(jy).sum((1, 2)).max())
    np.testing.assert_allclose(s2.numpy(), j2, rtol=2.0 ** -7)

