"""The port's interpolation Pipeline against tooncrafter_tpu's at a
non-square latent, 6x8 (48x64 pixels), with the 576x1024 YAML's
``base_scale`` 0.3: the UNet's deepest level is then 3x4, odd in height
like the 576x1024 model's 9x16 mid block, and a swapped H and W anywhere
(a reshape, a tap, a splice) changes the result where the square tiny test
cannot see it. Same inputs and bar as tests/test_torch_pipeline.py: fp32 on
the CPU, DDIM with CFG 7.5 + rescale 0.7, eta 0, the posterior mode, one
x_T from numpy, the middle-frame splice, every frame's PSNR >= 40 dB.

To stay cheap on the CPU the JAX side runs as one jitted program (its
towers compiled once together, not one by one), and the weights are seeded
numpy noise on the JAX parameter tree's shapes (``jax.eval_shape`` of its
init; no init is compiled), scaled by fan-in.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_pipeline import _inputs
from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.diffusion import middle_frame_splice
from tooncrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from tooncrafter_tpu.utils.metrics import psnr
from tooncrafter_tpu_torch.config import ModelConfig, model_config_from_yaml
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

YAML_1024 = os.path.join(os.path.dirname(__file__), "..", "configs",
                         "inference_1024_v1.0.yaml")
STEPS = 2


def _seeded_params(jm, seed):
    """Noise on every leaf of the JAX parameter tree: matrices and conv
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest
    N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path).split("'")[-2]
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            x = rng.normal(size=s.shape) * fan_in ** -0.5
        elif name == "weight" and len(s.shape) == 1:
            x = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            x = 0.05 * rng.normal(size=s.shape)
        return x.astype(np.float32)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_pipeline(jm, params, video, tokens, null_tokens, x_T, fs):
    """tests/test_torch_pipeline.py's JAX pipeline, traceable as one
    program."""
    z, refs = jm.encode_first_stage(params, video, sample_posterior=False)
    concat = jm.build_concat_cond(z, "interp")
    text = jm.encode_text(params, tokens)
    uc_text = jm.encode_text(params, null_tokens)
    frame0 = video[:, 0]
    img = jm.encode_image_context(params, frame0)
    uc_img = jm.encode_image_context(params, jnp.zeros_like(frame0))
    contexts = jnp.stack([jnp.concatenate([uc_text, uc_img], 1),
                          jnp.concatenate([text, img], 1)])
    samples = jm.denoise(
        params, x_T, contexts, concat, fs, jax.random.PRNGKey(0),
        JaxGuidance(cfg_scale=7.5, guidance_rescale=0.7), ddim_steps=STEPS,
        eta=0.0)
    return middle_frame_splice(jm, params, samples, refs)


def test_nonsquare_pipeline_matches_jax():
    base_scale = model_config_from_yaml(YAML_1024).base_scale
    assert base_scale == 0.3
    geometry = dict(latent_h=6, latent_w=8, base_scale=base_scale)
    jm = JaxToonCrafter(JaxConfig().tiny(**geometry))
    params = _seeded_params(jm, 5)
    pm = ToonCrafter(ModelConfig().tiny(**geometry))
    assert np.isclose(np.asarray(pm.schedule.scale_arr)[-1], base_scale)
    pm.load_state_dict(from_jax_params(params, pm.config), strict=True)
    video, tokens, null_tokens, x_T, fs = _inputs(pm.config, seed=2)
    assert video.shape == (1, 4, 48, 64, 3)
    ref = np.asarray(jax.jit(
        lambda *a: _jax_pipeline(jm, *a))(
            params, video, tokens.astype(np.int32),
            null_tokens.astype(np.int32), x_T, fs))
    pipe = Pipeline(pm.eval(), ddim_steps=STEPS, eta=0.0,
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7))
    out = pipe(torch.from_numpy(video), torch.from_numpy(tokens),
               torch.from_numpy(null_tokens), torch.from_numpy(fs),
               x_T=torch.from_numpy(x_T)).numpy()
    assert out.shape == ref.shape == video.shape
    max_abs = float(np.abs(out - ref).max())
    p = float(np.min(np.asarray(psnr(jnp.asarray(ref), jnp.asarray(out)))))
    print(f"non-square tiny pipeline: min PSNR {p:.1f} dB, max abs err "
          f"{max_abs:.3e}, max |ref| {np.abs(ref).max():.3f}")
    assert np.isfinite(out).all()
    assert p >= 40.0, f"min PSNR {p:.1f} dB < 40 (max abs err {max_abs:.3e})"
