"""The port's flash-attention wrappers on the CPU (their plain versions)
against the four TPU kernels of tooncrafter_tpu/ops/flash_attention.py, run
in Pallas interpret mode as tests/test_flash_attention.py runs them, at
small shapes inside each kernel's envelope. fp32 inputs from numpy with a
seed; bar 2e-5 absolute (the TPU kernels' exp2-domain softmax against an
exact softmax, as in tests/test_flash_attention.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import flash_attention as jfa
from tooncrafter_tpu_torch.ops import attention as att
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    fa.reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert not any(fa.LAUNCHES.values()), fa.LAUNCHES


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_packed_matches_flash_mh_packed():
    qkv = _rand(0, 2, 512, 3 * 320)
    assert jfa._packed_direct_blk(512, 320, 5) == 512
    ref = jfa.flash_attention_packed(jnp.asarray(qkv), 5)
    out = fa._flash_mh_packed(torch.from_numpy(qkv), 5, 64 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the public entry dispatches to the same wrapper, and refuses shapes
    # outside the envelope (the UNet sends those to ops.attention)
    np.testing.assert_allclose(
        fa.flash_attention_packed(torch.from_numpy(qkv), 5).numpy(),
        np.asarray(ref), atol=ATOL)
    assert not fa.use_packed_kernel(100, 320, 5)
    with pytest.raises(ValueError, match="envelope"):
        fa.flash_attention_packed(torch.zeros(1, 100, 960), 5)


def test_mh_matches_flash_mh():
    q, k, v = (_rand(i, 2, 160, 128) for i in (1, 2, 3))
    blk = jfa._mh_blk(160, 160, 128, 2)
    assert blk == 160
    ref = jfa._flash_mh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                        0.125, blk)
    out = fa._flash_mh(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), 2, 0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_two_pass_matches_flash_bh_with_lse(monkeypatch):
    # force the TPU's online two-pass body, as that file's
    # test_two_pass_forward_matches_reference does
    monkeypatch.setattr(jfa, "_single_pass_blk", lambda *a: 0)
    q = _rand(4, 2, 256, 64)
    k, v = _rand(5, 2, 512, 64), _rand(6, 2, 512, 64)
    ref, ref_lse = jfa._flash_bh_with_lse(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), 0.125)
    out, lse = fa._flash_bh_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL)


def test_single_pass_d512_matches_flash_bh_single():
    q, k, v = (_rand(i, 2, 256, 512) for i in (7, 8, 9))
    sc = 512 ** -0.5
    blk = jfa._single_pass_blk(256, 256, 512)
    assert blk
    ref, ref_lse = jfa._flash_bh_single(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), sc, blk)
    out, lse = fa._flash_bh_single(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), sc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2.0 ** -7)])
def test_mh_ones_matches_flash_mh_ones(dtype, atol):
    """#5 at tests/test_flash_attention.py's shapes: fp32 to 1e-5 as that
    test holds it; in bf16 both sides round p for the product and its sum
    and the output once, so only a rounding that the two summation orders
    straddle moves, by one bf16 ulp: 2^-7 of max |out|."""
    q = _rand(16, 2, 256, 128)
    k, v = _rand(17, 2, 512, 128), _rand(18, 2, 512, 128)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jfa._flash_mh_ones(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), 2, 64 ** -0.5,
        128).astype(jnp.float32))
    out = fa._flash_mh_ones(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                            2, 64 ** -0.5)
    assert out.dtype == tdt and tuple(out.shape) == (2, 256, 128)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=atol * np.abs(ref).max())


def test_mh_ones_normalizer_cast_point():
    """#5 divides by the sum of bf16(p), #2 by the unrounded sum
    (kernel_check.ones_pin_inputs), bit for bit."""
    q, k, v, heads, scale = kc.ones_pin_inputs()
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    ones = np.asarray(jfa._flash_mh_ones(jq, jk, jv, heads, scale, 128)
                      .astype(jnp.float32))
    mh = np.asarray(jfa._flash_mh(jq, jk, jv, heads, scale, 128)
                    .astype(jnp.float32))
    assert (ones == 1.0).all() and (mh == 0.99609375).all()
    out = fa._flash_mh_ones(*(torch.from_numpy(t).bfloat16()
                              for t in (q, k, v)), heads, scale)
    assert np.array_equal(out.float().numpy(), ones)


@pytest.mark.parametrize("sq,sk,d", [(2560, 2560, 64), (640, 640, 64),
                                     (160, 160, 64), (40960, 5120, 64),
                                     (163840, 20480, 64), (2560, 2560, 512),
                                     (256, 513, 64), (77, 2560, 64),
                                     (2560, 5120, 64), (9216, 9216, 64)])
def test_selectors_equal_the_tpu_envelopes(sq, sk, d):
    assert fa._pick_block(sq) == jfa._pick_block(sq)
    assert fa._single_pass_blk(sq, sk, d) == jfa._single_pass_blk(sq, sk, d)
    assert fa._use_kernel(sq, sk, d) == jfa._use_kernel(sq, sk, d)
    for c, heads in ((320, 5), (640, 10), (1280, 20), (320, 4)):
        assert fa._mh_blk(sq, sk, c, heads) == jfa._mh_blk(sq, sk, c, heads)
        assert (fa._packed_direct_blk(sq, c, heads)
                == jfa._packed_direct_blk(sq, c, heads))


def test_attention_dispatch_follows_the_envelope(monkeypatch):
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q = torch.from_numpy(_rand(10, 1, 160, 128))
    ctx = torch.from_numpy(_rand(11, 1, 77, 128))
    ref = att.dot_product_attention(q.view(1, 160, 2, 64),
                                    q.view(1, 160, 2, 64),
                                    q.view(1, 160, 2, 64)).reshape(1, 160, 128)
    out = att.attention(q, q, q, heads=2)
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    att.attention(q, ctx, ctx, heads=2)          # 77 context tokens
    mask = torch.ones(1, 1, 160, 160, dtype=torch.bool)
    att.attention(q, q, q, heads=2, mask=mask)   # masked
    assert calls == [1]


def test_plain_version_chunks_exactly():
    q, k, v = (torch.from_numpy(_rand(i, 2, 300, 64)) for i in (12, 13, 14))
    whole = fa._plain_bh(q, k, v, 0.125, chunk=300)
    chunked = fa._plain_bh(q, k, v, 0.125, chunk=64)
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(chunked[1], whole[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [1e-2, 1.0, 3.0])
def test_error_bounds_pass_rounding_and_refuse_a_scaled_output(scale):
    # the bounds the card's kernels are held to: bf16 rounding of the fp32
    # reference passes at any magnitude; an output 1% too large does not
    ref = torch.from_numpy(_rand(15, 4, 256, 64)) * scale
    max_bound, mean_bound = fa.error_bounds(ref)
    top = ref.abs().max().item()
    assert top * 2 ** -7 < max_bound <= top * 2 ** -6
    rounded = (ref.to(torch.bfloat16).float() - ref).abs()
    assert rounded.max().item() <= max_bound
    assert rounded.mean().item() * 4 == pytest.approx(mean_bound)
    scaled = ((ref * 1.01).to(torch.bfloat16).float() - ref).abs()
    assert scaled.mean().item() > mean_bound
