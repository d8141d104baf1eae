"""The port's conditioning towers (CLIP text and vision, the Resampler) and
resize ops against tooncrafter_tpu's at the tiny config in fp32 on the CPU.

Same weights on both sides (the JAX init with all-zero leaves replaced by
seeded noise, via ``from_jax_params``); inputs from numpy with a seed.
Bar: max |port - jax| <= 2e-4 of each output's magnitude; the resize
matrices agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models import clip as jclip
from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.ops import resize as jresize
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models import clip
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import resize
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
def towers():
    jm = JaxToonCrafter(JaxConfig().tiny())
    c = jm.config
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    sz = c.clip_image_size
    params = {
        "text_encoder": jax.jit(jm.text_encoder.init)(
            ks[0], jnp.zeros((1, 77), jnp.int32))["params"],
        "image_encoder": jax.jit(jm.image_encoder.init)(
            ks[1], jnp.zeros((1, sz, sz, 3)))["params"],
    }
    n_tok = (sz // jm.image_encoder.patch_size) ** 2 + 1
    params["image_proj"] = jax.jit(jm.image_proj.init)(
        ks[2], jnp.zeros((1, n_tok, c.clip_vision_width)))["params"]
    params = _fill_zero_leaves(params, 2)
    pm = ToonCrafter(ModelConfig().tiny())
    sd = from_jax_params(params, pm.config)
    missing, unexpected = pm.load_state_dict(sd, strict=False)
    assert not unexpected
    prefixes = ("cond_stage_model.", "embedder.", "image_proj_model.")
    assert not [k for k in missing if k.startswith(prefixes)]
    return jm, params, pm.eval()


def test_text_tower_matches_jax(towers):
    jm, params, pm = towers
    tokens = np.random.default_rng(0).integers(0, 49408, (2, 77))
    ref = jm.text_encoder.apply({"params": params["text_encoder"]},
                                jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        out = pm.encode_text(torch.from_numpy(tokens))
    _close(out.numpy(), ref)


def test_image_context_matches_jax(towers):
    # clip_preprocess -> vision tower (all 257-style tokens) -> Resampler
    jm, params, pm = towers
    frame = np.random.default_rng(1).uniform(-1, 1, (2, 32, 48, 3)).astype(
        np.float32)
    x = jclip.clip_preprocess(jnp.asarray(frame), jm.config.clip_image_size)
    toks = jm.image_encoder.apply({"params": params["image_encoder"]}, x)
    ref = jm.image_proj.apply({"params": params["image_proj"]}, toks)
    with torch.no_grad():
        out = pm.encode_image_context(torch.from_numpy(frame))
        ptoks = pm.embedder.model.visual(
            clip.clip_preprocess(torch.from_numpy(frame),
                                 pm.config.clip_image_size))
    _close(ptoks.numpy(), toks)
    c = pm.config
    assert out.shape == (2, c.video_length * c.resampler_queries,
                         c.context_dim)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("ac,aa", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_resize_matrices_and_crop_match_jax(ac, aa):
    x = np.random.default_rng(2).uniform(-1, 1, (1, 37, 53, 3)).astype(
        np.float32)
    ours = resize.resize_bicubic(torch.from_numpy(x), 20, 28, ac, aa)
    ref = jresize.resize_bicubic(jnp.asarray(x), 20, 28, ac, aa)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        resize.center_crop_resize(torch.from_numpy(x), 24, 24).numpy(),
        np.asarray(jresize.center_crop_resize(jnp.asarray(x), 24, 24)),
        atol=1e-5)
