"""The port's interpolation Pipeline end to end against tooncrafter_tpu's
ToonCrafter at the tiny config in fp32 on the CPU, in the shape of
tests/test_golden.py::_run_tiny_pipeline: two frames held for half the clip
each, DDIM-3 with CFG 7.5 + rescale 0.7, the middle-frame splice.

jax.random streams cannot be reproduced in torch, so both sides run with
eta=0, the posterior mode, and one explicit x_T from numpy; weights are the
JAX init with all-zero leaves replaced by seeded noise. Bar: every frame's
PSNR >= 40 dB (the golden gate's bar), with the max abs error reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.diffusion import middle_frame_splice
from tooncrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from tooncrafter_tpu.utils.metrics import psnr
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def _fill_zero_leaves(tree, seed):
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, 0.05, x.shape).astype(np.float32) \
            if not x.any() else x
    return jax.tree_util.tree_map(f, tree)


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    t = c.video_length
    h_px, w_px = c.latent_h * 8, c.latent_w * 8
    fa = rng.uniform(-1, 1, (1, 1, h_px, w_px, 3)).astype(np.float32)
    fb = rng.uniform(-1, 1, (1, 1, h_px, w_px, 3)).astype(np.float32)
    video = np.concatenate([fa.repeat(t // 2, 1), fb.repeat(t - t // 2, 1)],
                           1)
    tokens = rng.integers(0, 49408, (1, 77))
    null_tokens = np.zeros((1, 77), np.int64)
    x_T = rng.normal(size=(1, t, c.latent_h, c.latent_w,
                           c.z_channels)).astype(np.float32)
    fs = np.full((1,), 10.0, np.float32)
    return video, tokens, null_tokens, x_T, fs


def _jax_pipeline(jm, params, video, tokens, null_tokens, x_T, fs, steps):
    z, refs = jm.encode_first_stage(params, jnp.asarray(video),
                                    sample_posterior=False)
    concat = jm.build_concat_cond(z, "interp")
    text = jm.encode_text(params, jnp.asarray(tokens, jnp.int32))
    uc_text = jm.encode_text(params, jnp.asarray(null_tokens, jnp.int32))
    frame0 = jnp.asarray(video[:, 0])
    img = jm.encode_image_context(params, frame0)
    uc_img = jm.encode_image_context(params, jnp.zeros_like(frame0))
    contexts = jnp.stack([jnp.concatenate([uc_text, uc_img], 1),
                          jnp.concatenate([text, img], 1)])
    samples = jm.denoise(
        params, jnp.asarray(x_T), contexts, concat, jnp.asarray(fs),
        jax.random.PRNGKey(0),
        JaxGuidance(cfg_scale=7.5, guidance_rescale=0.7), ddim_steps=steps,
        eta=0.0)
    return np.asarray(middle_frame_splice(jm, params, samples, refs))


@pytest.fixture(scope="module")
def both():
    jm = JaxToonCrafter(JaxConfig().tiny())
    params = _fill_zero_leaves(jm.init_params(jax.random.PRNGKey(0)), 3)
    pm = ToonCrafter(ModelConfig().tiny())
    pm.load_state_dict(from_jax_params(params, pm.config), strict=True)
    return jm, params, pm.eval()


def test_pipeline_matches_jax(both):
    jm, params, pm = both
    video, tokens, null_tokens, x_T, fs = _inputs(pm.config)
    ref = _jax_pipeline(jm, params, video, tokens, null_tokens, x_T, fs, 3)
    pipe = Pipeline(pm, ddim_steps=3, eta=0.0,
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7))
    out = pipe(torch.from_numpy(video), torch.from_numpy(tokens),
               torch.from_numpy(null_tokens), torch.from_numpy(fs),
               x_T=torch.from_numpy(x_T)).numpy()
    assert out.shape == ref.shape == video.shape
    max_abs = float(np.abs(out - ref).max())
    p = float(np.min(np.asarray(psnr(jnp.asarray(ref), jnp.asarray(out)))))
    print(f"tiny pipeline: min PSNR {p:.1f} dB, max abs err {max_abs:.3e}")
    assert np.isfinite(out).all()
    assert p >= 40.0, f"min PSNR {p:.1f} dB < 40 (max abs err {max_abs:.3e})"
    assert set(pipe.timings) == {"encode", "conditioning", "denoise",
                                 "decode", "decode_splice"}


def test_pipeline_is_deterministic_per_generator(both):
    # eta=1 and a sampled posterior: the same seed gives the same clip
    _, _, pm = both
    video, tokens, null_tokens, _, fs = _inputs(pm.config, seed=1)
    pipe = Pipeline(pm, ddim_steps=2, perframe_ae=True)
    args = (torch.from_numpy(video), torch.from_numpy(tokens),
            torch.from_numpy(null_tokens), torch.from_numpy(fs))
    a = pipe(*args, generator=torch.Generator().manual_seed(7))
    b = pipe(*args, generator=torch.Generator().manual_seed(7))
    c = pipe(*args, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
