"""The port's UNet (tooncrafter_tpu_torch) against tooncrafter_tpu's at the
tiny config in fp32 on the CPU.

Both sides get the same weights: the JAX init, with every all-zero leaf
(zero-init projections, biases) replaced by seeded noise so that every
layer shapes the output, carried into the port by
``utils.weights.from_jax_params``. Inputs come from numpy with a seed.
Bar: max |port - jax| <= 2e-4 of the output's magnitude
(tests/parity/refutil.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.unet import UNetModel
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TOL = 2e-4
PREFIX = "model.diffusion_model."


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
def unets():
    jm = JaxToonCrafter(JaxConfig().tiny())
    c = jm.config
    t = c.video_length
    x = jnp.zeros((1, t, c.latent_h, c.latent_w, c.unet_in_channels))
    ctx = jnp.zeros((1, 77 + t * c.resampler_queries, c.context_dim))
    ts = jnp.zeros((1,))
    params = jax.jit(jm.unet.init)(jax.random.PRNGKey(0), x, ts, ctx,
                                   ts)["params"]
    params = _fill_zero_leaves(params, 0)
    pm = ToonCrafter(ModelConfig().tiny())
    sd = from_jax_params({"unet": params}, pm.config)
    pm.unet.load_state_dict(
        {k[len(PREFIX):]: v for k, v in sd.items() if k.startswith(PREFIX)},
        strict=True)
    return jm, params, pm.unet.eval()


def _inputs(c, b, ctx_len, seed):
    rng = np.random.default_rng(seed)
    t = c.video_length
    x = rng.normal(size=(b, t, c.latent_h, c.latent_w,
                         c.unet_in_channels)).astype(np.float32)
    ctx = rng.normal(size=(b, ctx_len, c.context_dim)).astype(np.float32)
    ts = np.array([999.0, 321.0][:b], np.float32)
    fs = np.array([10.0, 24.0][:b], np.float32)
    return x, ts, ctx, fs


def _both(unets, x, ts, ctx, fs):
    jm, params, unet = unets
    ref = jm.unet.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx), jnp.asarray(fs))
    with torch.no_grad():
        out = unet(torch.from_numpy(x), torch.from_numpy(ts),
                   torch.from_numpy(ctx), torch.from_numpy(fs))
    return out.numpy(), np.asarray(ref)


def test_unet_matches_jax_with_per_frame_image_tokens(unets):
    c = unets[0].config
    x, ts, ctx, fs = _inputs(c, 2, 77 + c.video_length * c.resampler_queries,
                             1)
    out, ref = _both(unets, x, ts, ctx, fs)
    assert np.abs(ref).max() > 1e-2  # the perturbed weights reach the output
    _close(out, ref)


def test_unet_matches_jax_with_broadcast_context(unets):
    # a context of other length is broadcast to every frame (unet.py:834)
    c = unets[0].config
    x, ts, ctx, fs = _inputs(c, 1, 77 + 3, 2)
    out, ref = _both(unets, x, ts, ctx, fs)
    _close(out, ref)


def test_unet_parameter_names_follow_the_upstream_checkpoint():
    unet = UNetModel(model_channels=64, num_res_blocks=1,
                     channel_mult=(1, 2), attention_resolutions=(1, 2),
                     num_head_channels=32, context_dim=64, temporal_length=4)
    keys = set(unet.state_dict())
    for k in ("time_embed.0.weight", "fps_embedding.2.bias",
              "input_blocks.0.0.weight", "init_attn.0.proj_in.weight",
              "input_blocks.1.0.in_layers.0.weight",
              "input_blocks.1.0.temopral_conv.conv1.2.weight",
              "input_blocks.1.0.temopral_conv.conv4.3.weight",
              "input_blocks.1.1.transformer_blocks.0.attn2.to_k_ip.weight",
              "input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight",
              "input_blocks.2.0.op.weight", "middle_block.3.out_layers.3.bias",
              "output_blocks.1.3.conv.weight", "out.2.weight"):
        assert k in keys, k
    assert unet.state_dict()["init_attn.0.proj_in.weight"].ndim == 3
