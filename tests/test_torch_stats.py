"""The port's per-channel sums (ops/stats.py, #18) against the JAX package's
``_pallas_sums`` in Pallas interpret mode and its ``_jnp_sums``, the
gradient against ``jax.grad`` of the JAX custom_vjp, the dispatch envelope
against the JAX rule, the cast point (x squared in fp32), and the 512 UNet's
GroupNorm inputs that the envelope accepts (chip_smoke.py's shapes), read
off the model on the meta device.

Bounds: fp32 sums in another order than the interpret kernel's: 1e-5 of
sum |x| (s1) or of sum x^2 (s2), ~100 fp32 ulps of a sum of 256 terms; bf16
inputs are cast to fp32 first on both sides, so the same bound holds.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_selectors_1024 import _stub_launches
from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu.ops import stats as jst
from tooncrafter_tpu_torch.config import model_config_from_yaml
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import stats as st
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

REL = 1e-5
YAML_512 = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "inference_512_v1.0.yaml")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jst, "_INTERPRET", True)
    st.reset_launch_counts()
    yield
    assert st.LAUNCHES["_pallas_sums"] == 0  # the CPU runs no kernel


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, x):
    """got, want: (s1, s2); x the fp32 input, flattened to (N, S, C)."""
    xf = np.asarray(x, np.float32).reshape(want[0].shape[0], -1,
                                           want[0].shape[-1])
    scale = (np.abs(xf).sum(1), np.square(xf).sum(1))
    for g, w, sc in zip(got, want, scale):
        assert g.dtype == torch.float32
        np.testing.assert_array_less(np.abs(g.numpy() - np.asarray(w)),
                                     REL * sc + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (2, 8, 8, 64),
                                   (2, 3, 4, 4, 128)])
def test_plain_matches_the_interpret_kernel(shape, dtype):
    jx, tx = _x(shape, len(shape) + shape[-1], dtype)
    n, c = shape[0], shape[-1]
    got = st._pallas_sums(tx.reshape(n, -1, c))
    want = jst._pallas_sums(jx.reshape(n, -1, c))
    _close(got, want, jx.astype(jnp.float32))
    # and the whole entry against the JAX entry on the same input
    _close(st.channel_sums(tx), jst.channel_sums(jx), jx.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 5, 6, 96)])
def test_plain_matches_jnp_sums_outside_the_kernel(shape):
    jx, tx = _x(shape, 3, "float32")
    _close(st.channel_sums(tx), jst._jnp_sums(jx), jx)
    assert norms.channel_sums is st._plain_sums


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (2, 4, 4, 64)])
def test_gradient_matches_jax_grad(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    w1, w2 = (np.random.default_rng(s).normal(size=(shape[0], shape[-1]))
              .astype(np.float32) for s in (3, 4))

    def loss(x_):
        s1, s2 = jst.channel_sums(x_)
        return jnp.sum(s1 * w1 + s2 * w2)
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    s1, s2 = st.channel_sums(xt)
    (s1 * torch.from_numpy(w1) + s2 * torch.from_numpy(w2)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    # one output used alone: the other's gradient is zero
    xt.grad = None
    st.channel_sums(xt)[1].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), 2 * x, rtol=1e-6)


@pytest.mark.parametrize("s,c", [(256, 128), (255, 128), (2560, 320),
                                 (640, 1280), (40, 1280), (160, 640),
                                 (40960, 320), (512, 96), (1024, 64),
                                 (163840, 128), (300, 128), (4096, 4096)])
def test_envelope_equals_the_jax_rule(monkeypatch, s, c):
    assert st._pick_stile(s, c) == jst._pick_stile(s, c)
    monkeypatch.setattr(jst, "_INTERPRET", False)
    for cuda in (True, False):
        monkeypatch.setattr(_dispatch, "on_tpu", lambda v=cuda: v)
        assert st._use_kernel(s, c, cuda) == jst._use_kernel(s, c)


def test_sums_square_x_in_fp32():
    """The cast point, bit for bit: x = +-2^k (1 + 2^-7) in bf16 has an
    exact fp32 square 2^2k (1 + 2^-6 + 2^-14); a bf16 square drops the
    2^-14 (6e-5 relative, 6x STATS_REL). 256 positions: every sum is exact
    in fp32, whatever its order."""
    n, s, c = 2, 256, 128
    k = torch.arange(c) % 5 - 2
    sign = torch.from_numpy(np.random.default_rng(5).choice(
        [-1.0, 1.0], size=(n, s, c)).astype(np.float32))
    x = (sign * torch.exp2(k.float()) * (1 + 2.0 ** -7)).to(torch.bfloat16)
    assert torch.equal(x.float().abs(), torch.exp2(k.float())
                       * (1 + 2.0 ** -7) * torch.ones(n, s, c))
    got = st._pallas_sums(x)
    want = jst._pallas_sums(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    exact = s * torch.exp2(2 * k.float()) * (1 + 2.0 ** -6 + 2.0 ** -14)
    assert torch.equal(got[1], exact.expand(n, c))
    bf16_square = (x * x).float().sum(1)
    rel = ((bf16_square - got[1]).abs() / got[1]).min().item()
    assert rel > 5 * kc.STATS_REL


def test_the_512_unet_group_norm_inputs_in_the_envelope(monkeypatch):
    """The (N, S, C) of every GroupNorm input of one 512 UNet call (2 CFG
    branches x 16 frames), on the meta device, that ``_use_kernel`` takes:
    chip_smoke.py times #18 at these (kernel_check.STATS_512)."""
    cfg = model_config_from_yaml(YAML_512)
    with torch.device("meta"):
        model = ToonCrafter(cfg).to(torch.bfloat16).eval()
    _stub_launches(monkeypatch)
    seen = collections.Counter()
    for attr in ("forward", "folded"):
        fn_ = getattr(norms.GroupNorm, attr)

        def spied(self, x, *a, fn_=fn_, **k):
            c = x.shape[-1]
            seen[(x.shape[0], x[0].numel() // c, c)] += 1
            return fn_(self, x, *a, **k)
        monkeypatch.setattr(norms.GroupNorm, attr, spied)
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    meta = dict(device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        model.unet(torch.empty(2, t, h, w, cfg.unet_in_channels, **meta),
                   torch.empty(2, device="meta"),
                   torch.empty(2, 77 + t * cfg.resampler_queries,
                               cfg.context_dim, **meta),
                   torch.empty(2, device="meta"))
    taken = {k: v for k, v in seen.items() if st._use_kernel(k[1], k[2], True)}
    assert taken == {shape: count for _, shape, count in kc.STATS_512
                     if count}
    assert sum(seen.values()) > sum(taken.values())  # S = 40, 160: refused
