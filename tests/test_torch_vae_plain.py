"""The port's plain decoder path against tooncrafter_tpu's at the tiny config
in fp32 on the CPU: the plain ``Decoder``, ``AutoencoderKL.decode`` and its
round trip, ``ToonCrafter.decode_plain``, and the Pipeline in the
single-image ``"repeat"`` mode without the splice (``use_splice=False``).

The JAX model holds both decoders; the port holds one under the upstream
key ``first_stage_model.decoder``: the dual-ref one (``ToonCrafter(cfg)``,
a ToonCrafter checkpoint) or the plain one (``dualref=False``, a
DynamiCrafter checkpoint). Both load their tensors exactly through
``full_mapping(cfg, dualref)``. Same weights on both sides (the JAX init
with all-zero leaves replaced by seeded noise); inputs from numpy with a
seed; eta=0 and an explicit x_T for the pipeline. Bar: every frame's PSNR
>= 40 dB (tests/test_torch_pipeline.py's), the max abs error reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from tooncrafter_tpu.models.vae import Decoder as JaxDecoder
from tooncrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from tooncrafter_tpu.utils.metrics import psnr
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.utils import checkpoint as ckpt
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

MIN_PSNR = 40.0


def _fill_zero_leaves(tree, seed):
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, 0.05, x.shape).astype(np.float32) \
            if not x.any() else x
    return jax.tree_util.tree_map(f, tree)


def _agree(port, ref, what):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    frames = lambda a: a.reshape((-1,) + a.shape[-3:])
    p = float(np.min(np.asarray(psnr(jnp.asarray(frames(ref)),
                                     jnp.asarray(frames(port))))))
    err = float(np.abs(port - ref).max())
    print(f"{what}: min PSNR {p:.1f} dB, max abs err {err:.3e}")
    assert p >= MIN_PSNR, f"{what}: {p:.1f} dB (max abs err {err:.3e})"


@pytest.fixture(scope="module")
def both():
    jm = JaxToonCrafter(JaxConfig().tiny())
    params = _fill_zero_leaves(jm.init_params(jax.random.PRNGKey(0)), 3)
    cfg = ModelConfig().tiny()
    models = {}
    for dualref in (True, False):
        pm = ToonCrafter(cfg, dualref=dualref)
        pm.load_state_dict(from_jax_params(params, cfg, dualref=dualref),
                           strict=True)
        models[dualref] = pm.eval()
    return jm, params, models


def _mapped(cfg, dualref, prefix):
    return {k for entries in ckpt.full_mapping(cfg, dualref).values()
            for _, k, _ in entries if k.startswith(prefix)}


def test_decoder_placement(both):
    _, _, models = both
    cfg = ModelConfig().tiny()
    prefix = "first_stage_model.decoder."
    for dualref, pm in models.items():
        sd = pm.state_dict()
        # the decoder's tensors are the mapping's for the model's kind
        # (the mapping also lists the optional nin_shortcut of every block)
        have = {k for k in sd if k.startswith(prefix)}
        mapped = _mapped(cfg, dualref, prefix)
        assert have <= mapped, sorted(have - mapped)[:5]
        assert all(".nin_shortcut." in k for k in mapped - have), dualref
        assert "first_stage_model.post_quant_conv.weight" in sd
    with pytest.raises(TypeError, match="plain"):
        models[True].decode_plain(torch.zeros(1, 4, 4, 4, 4))
    with pytest.raises(TypeError, match="dual-ref"):
        models[False].decode_first_stage(torch.zeros(1, 4, 4, 4, 4), [])


def test_plain_decoder_decode_and_round_trip_match_jax(both):
    jm, params, models = both
    vae = models[False].first_stage_model
    c = jm.config
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, c.latent_h, c.latent_w, c.z_channels)).astype(
        np.float32)
    x = rng.uniform(-1, 1, (2, c.latent_h * 8, c.latent_w * 8, 3)).astype(
        np.float32)
    jdec = JaxDecoder(c.vae_ch, 3, tuple(c.vae_ch_mult),
                      c.vae_num_res_blocks)
    with torch.no_grad():
        _agree(vae.decoder(torch.from_numpy(z)).numpy(),
               jdec.apply({"params": params["vae"]["decoder"]},
                          jnp.asarray(z)), "plain Decoder")
        _agree(vae.decode(torch.from_numpy(z)).numpy(),
               jm.vae.apply({"params": params["vae"]}, jnp.asarray(z),
                            method=JaxAutoencoderKL.decode),
               "AutoencoderKL.decode")
        rec, moments = vae(torch.from_numpy(x))
    ref_rec, ref_m = jm.vae.apply({"params": params["vae"]}, jnp.asarray(x))
    _agree(rec.numpy(), ref_rec, "AutoencoderKL round trip")
    _agree(moments.numpy(), ref_m, "round trip moments")
    z5 = rng.normal(size=(1, c.video_length, c.latent_h, c.latent_w,
                          c.z_channels)).astype(np.float32)
    with torch.no_grad():
        out = models[False].decode_plain(torch.from_numpy(z5)).numpy()
    _agree(out, jm.decode_plain(params, jnp.asarray(z5)), "decode_plain")


def test_repeat_mode_without_splice_matches_jax(both):
    jm, params, models = both
    pm = models[True]
    c = pm.config
    rng = np.random.default_rng(5)
    t, h_px, w_px = c.video_length, c.latent_h * 8, c.latent_w * 8
    frame = rng.uniform(-1, 1, (1, 1, h_px, w_px, 3)).astype(np.float32)
    video = np.repeat(frame, t, 1)  # the single-image request's layout
    tokens = rng.integers(0, 49408, (1, 77))
    null_tokens = np.zeros((1, 77), np.int64)
    x_T = rng.normal(size=(1, t, c.latent_h, c.latent_w,
                           c.z_channels)).astype(np.float32)
    fs = np.full((1,), 10.0, np.float32)

    z, refs = jm.encode_first_stage(params, jnp.asarray(video),
                                    sample_posterior=False)
    concat = jm.build_concat_cond(z, "repeat")
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
        JaxGuidance(cfg_scale=7.5, guidance_rescale=0.7), ddim_steps=2,
        eta=0.0)
    ref = jm.decode_first_stage(params, samples, refs)

    pipe = Pipeline(pm, ddim_steps=2, eta=0.0, mode="repeat",
                    use_splice=False,
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7))
    out = pipe(torch.from_numpy(video), torch.from_numpy(tokens),
               torch.from_numpy(null_tokens), torch.from_numpy(fs),
               x_T=torch.from_numpy(x_T)).numpy()
    _agree(out, ref, "Pipeline repeat, use_splice=False")
    assert set(pipe.timings) == {"encode", "conditioning", "denoise",
                                 "decode"}
