"""The plain versions of the kernels behind the JAX package's opt-in
switches against its Pallas kernels in interpret mode, on the CPU:

  * #10, one temporal self-attention sub-block (``_fused_tattn_call``),
    against the TPU kernel ``_fused_tattn_call``, not against the pair (in
    interpret mode the pair differs from two single stages at ~29 % of the
    elements, by at most 2 ulps);
  * #11, the T-attention core (``_ptc_kernel_call``), at T = 16 and T = 8,
    d = 64 and 128, on (B, T, P, inner) views of one packed projection;
  * #15, the im2col GN+SiLU+3x3 conv (``_pallas_fused_conv``), with and
    without the residual and the sums;
  * the coverage rules against the JAX package's, and a temporal block's
    routes (the pair, #10 twice, #11 inside its LayerNorm and projections)
    against its plain chain.

Bounds: in fp32 the two sides differ only in summation order: 1e-5 of max
|out| (#10, #11) and 2e-5 (#15, nine taps of up to 128 channels). In bf16
both round at the same points, so only a rounding that flips between the
two summation orders separates them, and the later products carry it: 2
bf16 ulps of max |out| anywhere (2^-6 of it) and at most 2 % of the
elements off at all (#10); 2^-7 of max |out| for #11 and #15, whose
rounded intermediates feed one product each. The sums of #15 are held to
the sums of its own output within 1e-5 of the sum of |y| (or y^2). #15's
cast point is held bit for bit, through a conv that passes z unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jta, "_INTERPRET", True)
    monkeypatch.setattr(jsc, "_INTERPRET", True)


def _rng_f(seed):
    rng = np.random.default_rng(seed)
    return lambda *s, sc_=1.0, off=0.0: (
        rng.normal(size=s) * sc_ + off).astype(np.float32)


# ---------------------------------------------------------------------------
# #10
# ---------------------------------------------------------------------------

def _tattn(t, dtype, seed):
    b, p, c, heads = 2, 32, 128, 2
    f = _rng_f(seed)
    x = f(b, p, t, c, sc_=2.0, off=0.5)  # the TPU kernel's (B, P, T, C)
    lnw, lnb = f(c, sc_=0.1, off=1.0), f(c, sc_=0.1)
    wq, wk, wv, wo = (f(c, c, sc_=c ** -0.5) for _ in range(4))
    bo = f(c, sc_=0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jta._fused_tattn_call(
        jnp.asarray(x).astype(jdt), jnp.asarray(lnw), jnp.asarray(lnb),
        jnp.concatenate([wq, wk, wv], axis=1).astype(jdt),
        jnp.asarray(wo).astype(jdt), jnp.asarray(bo).astype(jdt), heads,
        0.125, 1e-5)
    stage = (torch.from_numpy(lnw), torch.from_numpy(lnb),
             *(torch.from_numpy(w).T.contiguous().to(tdt)
               for w in (wq, wk, wv, wo)), torch.from_numpy(bo).to(tdt))
    got = ta._fused_tattn_call(
        torch.from_numpy(x).transpose(1, 2).contiguous().to(tdt), stage,
        heads, 0.125)
    assert got.dtype == tdt
    return (got.float().transpose(1, 2).numpy(),
            np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("t", [16, 4])
def test_single_stage_matches_the_interpret_kernel_fp32(interpret, t):
    got, want = _tattn(t, "float32", seed=t)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_single_stage_matches_the_interpret_kernel_bf16(interpret):
    got, want = _tattn(16, "bfloat16", seed=3)
    err = np.abs(got - want)
    assert err.max() <= 2.0 ** -6 * np.abs(want).max()
    assert (err > 0).mean() <= 0.02


# ---------------------------------------------------------------------------
# #11
# ---------------------------------------------------------------------------

def _ptc(t, d, dtype, seed):
    b, p, heads = 2, 128, 2
    inner = heads * d
    f = _rng_f(seed)
    qkv = f(b, t, p, 3 * inner)  # the port's layout, one packed projection
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # the TPU kernel's (B, P, T, inner)
    jq, jk, jv = (jnp.asarray(qkv[..., i * inner:(i + 1) * inner]
                              ).transpose(0, 2, 1, 3).astype(jdt)
                  for i in range(3))
    want = jta._ptc_kernel_call(jq, jk, jv, heads=heads, scale=d ** -0.5)
    q, k, v = torch.from_numpy(qkv).to(tdt).chunk(3, dim=-1)
    assert not q.is_contiguous()  # read at the packed projection's strides
    got = ta.temporal_attention_ptc(q, k, v, heads=heads, scale=d ** -0.5)
    assert got.dtype == tdt and got.shape == (b, t, p, inner)
    return (got.float().numpy(),
            np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("t,d", [(16, 64), (8, 128)])
def test_ptc_matches_the_interpret_kernel_fp32(interpret, t, d):
    got, want = _ptc(t, d, "float32", seed=t + d)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ptc_matches_the_interpret_kernel_bf16(interpret):
    got, want = _ptc(16, 64, "bfloat16", seed=5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_ptc_gradients_are_the_formulas():
    f = _rng_f(9)
    ts = [torch.from_numpy(f(1, 8, 16, 128)).requires_grad_()
          for _ in range(3)]
    gy = torch.from_numpy(f(1, 8, 16, 128))
    ta.temporal_attention_ptc(*ts, heads=2, scale=0.125).backward(gy)
    refs = [t.detach().clone().requires_grad_() for t in ts]
    ta._xla_ptc(*refs, 2, 0.125).backward(gy)
    for a, e in zip(ts, refs):
        torch.testing.assert_close(a.grad, e.grad, rtol=0, atol=1e-6)


def test_rules_follow_the_jax_package(monkeypatch):
    monkeypatch.setattr(jta, "_INTERPRET", True)
    for t, p, d, c in ((16, 2560, 64, 320), (16, 144, 64, 1280),
                       (16, 40, 64, 1280), (16, 160, 64, 1280),
                       (32, 4096, 128, 1024), (4, 64, 64, 128),
                       (16, 2560, 32, 320)):
        assert ta.use_kernel(t, p, d, inner=c) == jta.use_kernel(
            t, p, d, inner=c)
        assert ta.use_fused_kernel(t, p, d, c, c) == jta.use_fused_kernel(
            t, p, d, c, c)
        for pair in (True, False):
            monkeypatch.setattr(jta, "_PAIR", pair)
            monkeypatch.setattr(ta, "_PAIR", pair)
            assert ta.use_pair_kernel(t, p, d, c, c) == jta.use_pair_kernel(
                t, p, d, c, c)


# ---------------------------------------------------------------------------
# #15
# ---------------------------------------------------------------------------

def _conv(dtype, residual, stats, seed):
    n, h, w, cin, cout = 2, 8, 12, 128, 64
    f = _rng_f(seed)
    x = f(n, h, w, cin, sc_=2.0, off=0.5)
    a = f(n, cin, sc_=0.2, off=1.0)
    b = f(n, cin, sc_=0.1)
    kernel = f(3, 3, cin, cout, sc_=(9 * cin) ** -0.5)  # HWIO
    bias = f(cout, sc_=0.1)
    res = f(n, h, w, cout) if residual else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jsc._pallas_fused_conv(
        jnp.asarray(x).astype(jdt), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(kernel).astype(jdt), jnp.asarray(bias).astype(jdt),
        None if res is None else jnp.asarray(res).astype(jdt), True, stats)
    got = sc._pallas_fused_conv(
        torch.from_numpy(x).to(tdt), torch.from_numpy(a),
        torch.from_numpy(b),
        torch.from_numpy(kernel).permute(3, 2, 0, 1).to(tdt),
        torch.from_numpy(bias).to(tdt),
        None if res is None else torch.from_numpy(res).to(tdt), True, stats)
    want = want if stats else (want,)
    got = got if stats else (got,)
    assert got[0].dtype == tdt
    return ([t.float().numpy() for t in got],
            [np.asarray(t.astype(jnp.float32)) for t in want])


@pytest.mark.parametrize("residual,stats", [(True, True), (False, False),
                                            (False, True)])
def test_conv_matches_the_interpret_kernel_fp32(interpret, residual, stats):
    got, want = _conv("float32", residual, stats, seed=int(residual))
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=2e-5 * np.abs(want[0]).max())
    for g, e, pw in zip(got[1:], want[1:], (1, 2)):
        np.testing.assert_allclose(
            g, e, rtol=0, atol=1e-5 * (np.abs(want[0]) ** pw).sum((1, 2))
            .max())


def test_conv_matches_the_interpret_kernel_bf16(interpret):
    got, want = _conv("bfloat16", True, True, seed=4)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=2.0 ** -7 * np.abs(want[0]).max())
    y = got[0].astype(np.float64)
    for s, pw in zip(got[1:], (1, 2)):
        np.testing.assert_allclose(
            s, (y ** pw).sum((1, 2)), rtol=0,
            atol=1e-5 * (np.abs(y) ** pw).sum((1, 2)).max())


def test_conv_cast_point_is_the_interpret_kernels_bit_for_bit(interpret):
    """A centre-tap identity weight (Cin = Cout = 64, zero bias) passes z
    through the conv unchanged, so y is z = bf16(silu(x A + B)) itself:
    one rounding after the SiLU, which #13's "ref" cast point (a rounding
    before it too) would move at a large share of the elements."""
    n, h, w, c = 2, 8, 12, 64
    f = _rng_f(5)
    x = f(n, h, w, c, sc_=2.0, off=0.5)
    a, b = f(n, c, sc_=0.2, off=1.0), f(n, c, sc_=0.1)
    kernel = np.zeros((3, 3, c, c), np.float32)  # HWIO
    kernel[1, 1] = np.eye(c, dtype=np.float32)
    bias = np.zeros(c, np.float32)
    want = np.asarray(jsc._pallas_fused_conv(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(kernel).astype(jnp.bfloat16),
        jnp.asarray(bias).astype(jnp.bfloat16), None, True, False
    ).astype(jnp.float32))
    tx, ta_, tb = (torch.from_numpy(v) for v in (x, a, b))
    tw = torch.from_numpy(kernel).permute(3, 2, 0, 1).to(torch.bfloat16)
    tbias = torch.from_numpy(bias).to(torch.bfloat16)
    got = sc._pallas_fused_conv(tx.to(torch.bfloat16), ta_, tb, tw, tbias)
    np.testing.assert_array_equal(got.float().numpy(), want)
    ref_point = sc._plain_conv3x3(tx.to(torch.bfloat16), ta_, tb, tw, tbias,
                                  None, True, False, round_first=True)
    assert (ref_point.float().numpy() != want).mean() > 0.05


def test_conv_rule_follows_the_jax_package(monkeypatch):
    """Where the port counts #15: the switch on, the Winograd tables
    missing and the JAX package's ``_use_kernel`` holding."""
    monkeypatch.setattr(jsc, "_SPATIAL_CONV_PALLAS", True)
    monkeypatch.setattr(sc, "_SPATIAL_CONV_PALLAS", True)
    monkeypatch.setattr(jsc, "_on_tpu", lambda: True)
    shapes = [(40, 64, 320, 320), (40, 64, 640, 320), (20, 32, 640, 640),
              (10, 16, 1280, 1280), (40, 64, 512, 512), (80, 128, 512, 512),
              (5, 8, 1280, 1280), (36, 64, 640, 640), (16, 16, 64, 64),
              (8, 12, 96, 64)]
    for key in shapes:
        want = "_pallas_fused_conv" if jsc._use_kernel(*key) else None
        assert sc._use_kernel(*key) == (want is not None), key
        assert sc._pick_tiles(*key) == jsc._pick_tiles(*key), key
    assert sc.conv_kernel_name(40, 64, 320, 320) == "_pallas_fused_conv"
    assert sc.conv_kernel_name(20, 32, 640, 640) == "winograd_gn_silu_conv3x3"
    assert sc.conv_kernel_name(36, 64, 640, 640) == (
        "winograd24_gn_silu_conv3x3")
    monkeypatch.setattr(sc, "_SPATIAL_CONV_PALLAS", False)
    assert sc.conv_kernel_name(40, 64, 320, 320) == "winograd_gn_silu_conv3x3"
    assert sc.tpu_kernel(40, 64, 320, 320) is None


@pytest.mark.parametrize("route", ["pair", "single", "ptc"])
def test_temporal_block_routes_compute_one_function(route):
    """A temporal BasicTransformerBlock's routes (the pair, #10 twice, the
    LayerNorm + projections around #11) against its unfused plain chain,
    in fp32 on the CPU: summation order only, 1e-5 of max |out|."""
    from tooncrafter_tpu_torch.models.unet import BasicTransformerBlock

    torch.manual_seed(0)
    blk = BasicTransformerBlock(128, 2, 64, None, cross=False).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn_like(p))
        x = torch.from_numpy(_rng_f(11)(2, 8, 4, 6, 128, sc_=2.0))
        want = blk(x, route="plain")
        got = blk(x, route=route)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
