"""The port's dual-ref decoder in the ``all`` and ``attn-only`` time modes
against tooncrafter_tpu's at the tiny config in fp32 on the CPU, and the
checkpoint mapping's coverage of each mode.

Same weights on both sides (the JAX init with all-zero leaves replaced by
seeded noise, through ``from_jax_params``); latents and reference taps
from numpy with a seed. Bar: every frame's PSNR >= 40 dB
(tests/test_torch_pipeline.py's), the max abs error reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.utils.metrics import psnr
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.vae_dualref import (TIME_MODES,
                                                      DualRefVideoDecoder)
from tooncrafter_tpu_torch.utils import checkpoint as ckpt
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

MIN_PSNR = 40.0
PREFIX = "first_stage_model.decoder."


def _fill_zero_leaves(tree, seed):
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, 0.05, x.shape).astype(np.float32) \
            if not x.any() else x
    return jax.tree_util.tree_map(f, tree)


@pytest.mark.parametrize("mode", ["all", "attn-only"])
def test_time_mode_matches_jax_and_mapping_covers_it(mode):
    overrides = dict(dualref_time_mode=mode, latent_w=6)
    jm = JaxToonCrafter(JaxConfig().tiny(**overrides))
    cfg = ModelConfig().tiny(**overrides)
    c = jm.config
    rng = np.random.default_rng(7)
    z = rng.normal(size=(1, c.video_length, c.latent_h, c.latent_w,
                         c.z_channels)).astype(np.float32)
    taps = jm._tap_shapes(c.latent_h * 8, c.latent_w * 8)
    refs = [rng.normal(size=(1, 2, th, tw, tc)).astype(np.float32)
            for (th, tw, tc) in taps]
    params = _fill_zero_leaves(jax.jit(jm.dualref_decoder.init)(
        jax.random.PRNGKey(1), jnp.asarray(z),
        [jnp.asarray(r) for r in refs])["params"], 2)
    ref = jm.dualref_decoder.apply({"params": params}, jnp.asarray(z),
                                   [jnp.asarray(r) for r in refs])

    dec = DualRefVideoDecoder.from_config(cfg)
    sd = from_jax_params({"dualref_decoder": params}, cfg)
    dec.load_state_dict({k[len(PREFIX):]: v for k, v in sd.items()},
                        strict=True)
    # every tensor of the mode is in the mapping, and every mapped tensor
    # but the optional nin_shortcuts is in the module
    have = {PREFIX + k for k in dec.state_dict()}
    mapped = {k for _, k, _ in ckpt.full_mapping(cfg)["dualref_decoder"]}
    assert have <= mapped, sorted(have - mapped)[:5]
    assert all(".nin_shortcut." in k for k in mapped - have)
    assert any(".time_mix_block." in k for k in have)
    assert any(".time_stack." in k for k in have) == (mode == "all")

    with torch.no_grad():
        out = dec.eval()(torch.from_numpy(z),
                         [torch.from_numpy(r) for r in refs]).numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    p = float(np.min(np.asarray(psnr(jnp.asarray(ref[0]),
                                     jnp.asarray(out[0])))))
    err = float(np.abs(out - ref).max())
    print(f"time_mode={mode}: min PSNR {p:.1f} dB, max abs err {err:.3e}")
    assert p >= MIN_PSNR, f"{p:.1f} dB (max abs err {err:.3e})"


def test_every_time_mode_builds():
    cfg = ModelConfig().tiny()
    for mode in TIME_MODES:
        DualRefVideoDecoder.from_config(cfg.tiny(dualref_time_mode=mode))
    with pytest.raises(ValueError, match="time_mode"):
        DualRefVideoDecoder.from_config(cfg.tiny(dualref_time_mode="frames"))
