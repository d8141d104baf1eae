"""The port's VAE encoder (with its five hidden-state taps) and dual-ref
decoder against tooncrafter_tpu's at the tiny config in fp32 on the CPU.

Same weights on both sides (the JAX init with all-zero leaves replaced by
seeded noise, carried over by ``from_jax_params``); inputs from numpy with a
seed. Bar: max |port - jax| <= 2e-4 of each output's magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TOL = 2e-4


def _close(actual, expected, tol=TOL):
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape, (a.shape, e.shape)
    rel = float(np.abs(a - e).max()) / max(1e-3, float(np.abs(e).max()))
    assert rel <= tol, f"max rel err {rel:.3e} > {tol}"


def _fill_zero_leaves(tree, seed):
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, 0.05, x.shape).astype(np.float32) \
            if not x.any() else x
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def vaes():
    jm = JaxToonCrafter(JaxConfig().tiny())
    c = jm.config
    h_px, w_px = c.latent_h * 8, c.latent_w * 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"vae": jax.jit(jm.vae.init)(
        k1, jnp.zeros((1, h_px, w_px, 3)))["params"]}
    taps = jm._tap_shapes(h_px, w_px)
    refs = [jnp.zeros((1, 2, th, tw, tc)) for (th, tw, tc) in taps]
    z = jnp.zeros((1, c.video_length, c.latent_h, c.latent_w, c.z_channels))
    params["dualref_decoder"] = jax.jit(jm.dualref_decoder.init)(
        k2, z, refs)["params"]
    params = _fill_zero_leaves(params, 1)
    pm = ToonCrafter(ModelConfig().tiny())
    sd = from_jax_params(params, pm.config)
    prefix = "first_stage_model."
    missing, unexpected = pm.first_stage_model.load_state_dict(
        {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
        strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return jm, params, pm.eval(), taps


def test_encoder_moments_and_taps_match_jax(vaes):
    jm, params, pm, taps = vaes
    c = jm.config
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, c.latent_h * 8, c.latent_w * 8, 3)).astype(
        np.float32)
    ref_m, ref_taps = jm.vae.apply(
        {"params": params["vae"]}, jnp.asarray(x), return_hidden_states=True,
        method=JaxAutoencoderKL.encode)
    with torch.no_grad():
        m, port_taps = pm.first_stage_model.encode(torch.from_numpy(x))
    _close(m.numpy(), ref_m)
    assert len(port_taps) == len(ref_taps) == 5
    for (th, tw, tc), a, e in zip(taps, port_taps, ref_taps):
        assert a.shape[1:] == (th, tw, tc)
        _close(a.numpy(), e)


def test_dualref_decoder_matches_jax(vaes):
    jm, params, pm, taps = vaes
    c = jm.config
    rng = np.random.default_rng(4)
    z = rng.normal(size=(1, c.video_length, c.latent_h, c.latent_w,
                         c.z_channels)).astype(np.float32)
    refs = [rng.normal(size=(1, 2, th, tw, tc)).astype(np.float32)
            for (th, tw, tc) in taps]
    ref = jm.dualref_decoder.apply({"params": params["dualref_decoder"]},
                                   jnp.asarray(z),
                                   [jnp.asarray(r) for r in refs])
    with torch.no_grad():
        out = pm.first_stage_model.decoder(
            torch.from_numpy(z), [torch.from_numpy(r) for r in refs])
    assert out.shape == (1, c.video_length, c.latent_h * 8,
                         c.latent_w * 8, 3)
    _close(out.numpy(), ref)


def test_perframe_encode_equals_whole_batch(vaes):
    # chunk_size=1 is the perframe_ae path; the encoder is per-frame
    _, _, pm, _ = vaes
    c = pm.config
    rng = np.random.default_rng(5)
    video = torch.from_numpy(rng.uniform(
        -1, 1, (1, c.video_length, c.latent_h * 8, c.latent_w * 8, 3)
    ).astype(np.float32))
    with torch.no_grad():
        z1, r1 = pm.encode_first_stage(video, sample_posterior=False)
        z2, r2 = pm.encode_first_stage(video, sample_posterior=False,
                                       chunk_size=1)
    _close(z2.numpy(), z1.numpy(), 1e-5)
    for a, b in zip(r2, r1):
        assert a.shape[1] == 2  # first and last frame
        _close(a.numpy(), b.numpy(), 1e-5)
