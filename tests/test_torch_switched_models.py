"""The port's UNet, VAE encoder and dual-ref decoder with the JAX package's
three opt-in switches on (TC_TATTN_PAIR=0, TC_SPATIAL_CONV_PALLAS=1,
TOONCRAFTER_FUSED_GN=1, set as module globals on both sides) against the JAX
modules on the CPU in fp32, the JAX kernels in interpret mode.

The config is the tiny one with 64-wide heads at an 8x8 latent, so that
the switched routes are reached: the temporal blocks at 8x8 (P = 64) take
the single-stage kernel (#10; those at 4x4, P = 16, the plain chain on
both sides; the T-attention core's rule wants P >= 128, and wherever it
holds the single-stage rule does as well, so #11 runs on neither side),
the 8x8 ResBlock convs and the VAE's 64-channel convs the im2col kernel
(#15), and the init attention's GroupNorm and the encoder's norm_out the
one-pass GroupNorm (#16). The port's launch counters (its wrappers on CPU
tensors run their plain versions and count nothing) are replaced by spies
on the wrappers. Same weights on both sides: the JAX parameter tree (from
``jax.eval_shape`` of its init) filled with seeded noise at each leaf's
fan-in scale, carried into the port by ``from_jax_params``; inputs from
numpy with a seed. Bar: max |port - jax| <= 2e-4 of the output's
magnitude, as the unswitched model tests.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from tooncrafter_tpu.ops import fused_norms as jfn
from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TOL = 2e-4
SIZE = dict(latent_h=8, latent_w=8, num_head_channels=64)


def _close(actual, expected, tol=TOL):
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape, (a.shape, e.shape)
    rel = float(np.abs(a - e).max()) / max(1e-3, float(np.abs(e).max()))
    assert rel <= tol, f"max rel err {rel:.3e} > {tol}"


def _random_params(shapes, seed):
    """Seeded values for a parameter tree of ShapeDtypeStructs: kernels at
    fan-in scale, norm scales near 1, everything else small."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = str(path[-1])
        shape = leaf.shape
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if "weight" in name or "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


@pytest.fixture(scope="module")
def switched():
    """Both packages' switch globals on (and the JAX kernels in interpret
    mode) for the module's tests; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, attr, val in ((jta, "_PAIR", False), (ta, "_PAIR", False),
                               (jsc, "_SPATIAL_CONV_PALLAS", True),
                               (sc, "_SPATIAL_CONV_PALLAS", True),
                               (jfn, "_FUSED_GN", True),
                               (fn, "_FUSED_GN", True),
                               (jta, "_INTERPRET", True),
                               (jsc, "_INTERPRET", True),
                               (jfn, "_INTERPRET", True)):
            mp.setattr(mod, attr, val)
        yield


@pytest.fixture(scope="module")
def models(switched):
    jm = JaxToonCrafter(JaxConfig().tiny(**SIZE))
    c = jm.config
    t, h_px, w_px = c.video_length, c.latent_h * 8, c.latent_w * 8
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jnp.zeros((1, t, c.latent_h, c.latent_w, c.unet_in_channels))
    ctx = jnp.zeros((1, 77 + t * c.resampler_queries, c.context_dim))
    ts = jnp.zeros((1,))
    shapes = {"unet": jax.eval_shape(jm.unet.init, k0, x, ts, ctx,
                                     ts)["params"],
              "vae": jax.eval_shape(jm.vae.init, k1, jnp.zeros(
                  (1, h_px, w_px, 3)))["params"]}
    taps = jm._tap_shapes(h_px, w_px)
    refs = [jnp.zeros((1, 2, th, tw, tc)) for (th, tw, tc) in taps]
    z = jnp.zeros((1, t, c.latent_h, c.latent_w, c.z_channels))
    shapes["dualref_decoder"] = jax.eval_shape(
        jm.dualref_decoder.init, k2, z, refs)["params"]
    params = _random_params(shapes, 0)
    pm = ToonCrafter(ModelConfig().tiny(**SIZE))
    missing, unexpected = pm.load_state_dict(
        from_jax_params(params, pm.config), strict=False)
    assert not unexpected, unexpected
    assert not [k for k in missing if k.startswith(
        ("model.diffusion_model.", "first_stage_model."))], missing
    return jm, params, pm.eval(), taps


@pytest.fixture
def calls(monkeypatch):
    """Which switched wrapper ran how often (spies; on CPU tensors the
    wrappers run their plain versions)."""
    seen = collections.Counter()
    for mod, name in ((ta, "_fused_tattn_call"), (ta, "_fused_tpair_call"),
                      (ta, "_ptc_kernel_call"), (fn, "_pallas_gn")):
        fn_ = getattr(mod, name)

        def spy(*a, _f=fn_, _n=name, **k):
            seen[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    conv = sc._conv

    def conv_spy(name, *a, **k):
        seen[name] += 1
        return conv(name, *a, **k)
    monkeypatch.setattr(sc, "_conv", conv_spy)
    return seen


def test_unet_matches_jax_with_the_switches_on(models, calls):
    jm, params, pm, _ = models
    c = jm.config
    t = c.video_length
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, t, c.latent_h, c.latent_w,
                         c.unet_in_channels)).astype(np.float32)
    ctx = rng.normal(size=(2, 77 + t * c.resampler_queries,
                           c.context_dim)).astype(np.float32)
    ts = np.array([999.0, 321.0], np.float32)
    fs = np.array([10.0, 24.0], np.float32)
    ref = jax.jit(jm.unet.apply)({"params": params["unet"]}, jnp.asarray(x),
                                 jnp.asarray(ts), jnp.asarray(ctx),
                                 jnp.asarray(fs))
    with torch.no_grad():
        out = pm.unet(*(torch.from_numpy(a) for a in (x, ts, ctx, fs)))
    assert np.abs(ref).max() > 1e-2
    _close(out.numpy(), ref)
    # the 8x8 temporal blocks (init attention, input and two output
    # blocks) through #10, two sub-blocks each; the 4x4 ones (and the mid
    # block) plain; #15 at the 8x8 ResBlocks' convs (input, two output);
    # #16 at the init attention's norm (no producer sums on either side)
    assert calls["_fused_tpair_call"] == calls["_ptc_kernel_call"] == 0
    assert calls["_fused_tattn_call"] == 2 * 4
    assert calls["_pallas_fused_conv"] == 2 * 3
    assert calls["_pallas_gn"] == 1


def test_encoder_matches_jax_with_the_switches_on(models, calls):
    jm, params, pm, taps = models
    c = jm.config
    x = np.random.default_rng(3).uniform(
        -1, 1, (1, c.latent_h * 8, c.latent_w * 8, 3)).astype(np.float32)
    ref_m, ref_taps = jax.jit(lambda p_, x_: jm.vae.apply(
        {"params": p_}, x_, return_hidden_states=True,
        method=JaxAutoencoderKL.encode))(params["vae"], jnp.asarray(x))
    with torch.no_grad():
        m, port_taps = pm.first_stage_model.encode(torch.from_numpy(x))
    _close(m.numpy(), ref_m)
    for a, e in zip(port_taps, ref_taps):
        _close(a.numpy(), e)
    # the 64-channel levels' and the mid blocks' ResnetBlock convs
    # (level 0 has 32 channels); norm_out
    assert calls["_pallas_fused_conv"] > 0
    assert calls["_pallas_gn"] == 1


def test_decoder_matches_jax_with_the_switches_on(models, calls):
    jm, params, pm, taps = models
    c = jm.config
    rng = np.random.default_rng(4)
    z = rng.normal(size=(1, c.video_length, c.latent_h, c.latent_w,
                         c.z_channels)).astype(np.float32)
    refs = [rng.normal(size=(1, 2, th, tw, tc)).astype(np.float32)
            for (th, tw, tc) in taps]
    ref = jax.jit(jm.dualref_decoder.apply)(
        {"params": params["dualref_decoder"]}, jnp.asarray(z),
        [jnp.asarray(r) for r in refs])
    with torch.no_grad():
        out = pm.first_stage_model.decoder(
            torch.from_numpy(z), [torch.from_numpy(r) for r in refs])
    _close(out.numpy(), ref)
    assert calls["_pallas_fused_conv"] > 0
