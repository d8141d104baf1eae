"""The ToonCrafter model and its inference Pipeline
(tooncrafter_tpu/models/diffusion.py).

``ToonCrafter`` is one ``nn.Module`` whose state dict carries the upstream
checkpoint's top-level prefixes (``model.diffusion_model``,
``first_stage_model``, ``cond_stage_model.model``, ``embedder.model.visual``,
``image_proj_model``). ``Pipeline`` runs the interpolation path:

  encode (VAE, per-frame taps) -> conditioning (CLIP text + vision ->
  Resampler) -> DDIM with the CFG branches in one UNet batch -> dual-ref
  decode, twice: the full decode and the middle-frame splice
  (``middle_frame_splice``; ``use_splice=False`` keeps the full decode).

A ToonCrafter checkpoint's ``first_stage_model.decoder`` is the dual-ref
video decoder, a DynamiCrafter one's the plain decoder: ``ToonCrafter(cfg,
dualref=False)`` builds the latter in the same place, which
``decode_plain`` runs (``utils/checkpoint.full_mapping(cfg, dualref)``
lists either model's tensors).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import torch
from torch import nn

from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.clip import (CLIPTextTower, CLIPVisionTower,
                                               clip_preprocess)
from tooncrafter_tpu_torch.models.resampler import Resampler
from tooncrafter_tpu_torch.models.unet import UNetModel
from tooncrafter_tpu_torch.models.vae import (AutoencoderKL, Decoder,
                                              DiagonalGaussian)
from tooncrafter_tpu_torch.models.vae_dualref import DualRefVideoDecoder
from tooncrafter_tpu_torch.ops import schedule as S
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig, ddim_sample
from tooncrafter_tpu_torch.utils import rngs as R
from tooncrafter_tpu_torch.utils.weights import to_compute_dtype


class _Holder(nn.Module):
    """A named container that reproduces an upstream state-dict prefix."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            setattr(self, name, mod)


class ToonCrafter(nn.Module):
    def __init__(self, config: ModelConfig, dualref: bool = True):
        """``dualref`` picks the decoder under ``first_stage_model.decoder``:
        the dual-ref video decoder (a ToonCrafter checkpoint) or the plain
        one (a DynamiCrafter checkpoint)."""
        super().__init__()
        self.config = c = config
        self.dualref = dualref
        self.schedule = S.build_schedule(
            timesteps=c.timesteps, beta_schedule=c.beta_schedule,
            linear_start=c.linear_start, linear_end=c.linear_end,
            rescale_betas_zero_snr=c.rescale_betas_zero_snr,
            parameterization=c.parameterization,
            use_dynamic_rescale=c.use_dynamic_rescale,
            base_scale=c.base_scale, turning_step=c.turning_step)
        self.model = _Holder(diffusion_model=UNetModel(
            in_channels=c.unet_in_channels, model_channels=c.model_channels,
            out_channels=c.unet_out_channels,
            num_res_blocks=c.num_res_blocks,
            attention_resolutions=tuple(c.attention_resolutions),
            channel_mult=tuple(c.channel_mult),
            num_head_channels=c.num_head_channels,
            transformer_depth=c.transformer_depth,
            context_dim=c.context_dim, temporal_length=c.video_length,
            fs_condition=c.fs_condition, default_fs=c.default_fs,
            img_tokens_per_frame=c.resampler_queries,
            image_cross_attention_scale_learnable=(
                c.image_cross_attention_scale_learnable),
            use_causal_attention=c.use_causal_attention,
            use_relative_position=c.use_relative_position,
            use_checkpoint=c.use_checkpoint, remat_policy=c.remat_policy))
        if dualref:
            decoder = DualRefVideoDecoder.from_config(c)
        else:
            decoder = Decoder(ch=c.vae_ch, ch_mult=tuple(c.vae_ch_mult),
                              num_res_blocks=c.vae_num_res_blocks,
                              z_channels=c.z_channels)
        self.first_stage_model = AutoencoderKL(
            decoder, ch=c.vae_ch, ch_mult=tuple(c.vae_ch_mult),
            num_res_blocks=c.vae_num_res_blocks, z_channels=c.z_channels,
            embed_dim=c.z_channels)
        self.cond_stage_model = _Holder(model=CLIPTextTower(
            width=c.clip_text_width, heads=c.clip_text_heads,
            layers=c.clip_text_layers))
        self.embedder = _Holder(model=_Holder(visual=CLIPVisionTower(
            width=c.clip_vision_width, heads=c.clip_vision_heads,
            layers=c.clip_vision_layers, image_size=c.clip_image_size)))
        self.image_proj_model = Resampler(
            dim=c.context_dim, depth=c.resampler_depth,
            heads=c.resampler_heads, num_queries=c.resampler_queries,
            embedding_dim=c.clip_vision_width, output_dim=c.context_dim,
            video_length=c.video_length)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    def to_compute_dtype(self) -> "ToonCrafter":
        """Cast to ``config.compute_dtype``, keeping the norms' parameters
        fp32 (``utils/weights.to_compute_dtype``)."""
        return to_compute_dtype(self, self.config.compute_dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.input_blocks[0][0].weight.dtype

    # ---- pipeline stages ----

    def encode_first_stage(self, video, generator=None,
                           sample_posterior: bool = True,
                           chunk_size: Optional[int] = None, noise=None):
        """video (B, T, H, W, 3) in [-1, 1] -> (z (B, T, h, w, 4) scaled,
        refs: per tap (B, 2, H_l, W_l, C_l) first/last-frame features).
        ``chunk_size`` frames are encoded at a time (the per-frame
        ``perframe_ae`` path; the encoder is per-frame, so exact). The
        posterior's noise (B*T, h, w, 4) is ``noise`` when given, else drawn
        from ``generator``: one generator draws it whole, a sequence of B
        (``utils/rngs.py``) draws each clip's (T, h, w, 4) from its own."""
        b, t = video.shape[:2]
        flat = video.reshape((b * t,) + video.shape[2:]).to(self.dtype)
        vae = self.first_stage_model
        step = flat.shape[0] if chunk_size is None else chunk_size
        parts = [vae.encode(flat[i:i + step])
                 for i in range(0, flat.shape[0], step)]
        moments = torch.cat([p[0] for p in parts])
        taps = [torch.cat([p[1][l] for p in parts])
                for l in range(len(parts[0][1]))]
        post = DiagonalGaussian(moments.float())
        if noise is None and sample_posterior and R.is_batched(generator):
            noise = R.normal(generator, (b, t) + post.mean.shape[1:],
                             post.mean.device, post.mean.dtype)
        if noise is not None:
            z = post.mean + post.std * noise.reshape(post.mean.shape)
        else:
            z = post.sample(generator) if sample_posterior else post.mode()
        z = z.reshape((b, t) + z.shape[1:]) * self.config.scale_factor
        refs = []
        for tap in taps:
            tap = tap.reshape((b, t) + tap.shape[1:])
            refs.append(torch.cat([tap[:, :1], tap[:, -1:]], dim=1))
        return z, refs

    def encode_text(self, tokens):
        return self.cond_stage_model.model(tokens)

    def image_tokens(self, frame):
        """frame (B, H, W, 3) in [-1, 1] -> the CLIP vision tokens."""
        x = clip_preprocess(frame.float(), self.config.clip_image_size)
        return self.embedder.model.visual(x.to(self.dtype))

    def encode_image_context(self, frame):
        """frame (B, H, W, 3) in [-1, 1] -> (B, T*queries, context_dim)."""
        return self.image_proj_model(self.image_tokens(frame))

    def build_concat_cond(self, z, mode: str = "interp"):
        if mode == "interp":
            return torch.cat([z[:, :1], torch.zeros_like(z[:, 1:-1]),
                              z[:, -1:]], dim=1)
        return z[:, :1].expand_as(z).contiguous()

    def denoise(self, x_T, contexts, concat, fs, guidance: GuidanceConfig,
                ddim_steps: int = 50, eta: float = 1.0,
                spacing: str = "uniform_trailing", generator=None,
                temperature: float = 1.0):
        ddim = S.build_ddim_schedule(self.schedule, ddim_steps, eta, spacing)
        # the sampler stacks the CFG branches over the same x, t and fs: the
        # UNet runs its context-free stem once per clip (as
        # tooncrafter_tpu/models/diffusion.py:321-328 declares it)
        denoiser = functools.partial(self.unet,
                                     cfg_groups=guidance.num_branches)
        return ddim_sample(denoiser, self.schedule, ddim, x_T, contexts,
                           concat, fs, guidance, generator, temperature)

    def decode_first_stage(self, z, refs, chunk_size: Optional[int] = None):
        """Scaled latents (B, T, h, w, 4) -> video (B, T, H, W, 3); chunks
        of ``chunk_size`` frames decode separately with the same refs."""
        if not self.dualref:
            raise TypeError("decode_first_stage runs the dual-ref decoder; "
                            "this model holds the plain one (decode_plain)")
        z = (z / self.config.scale_factor).to(self.dtype)
        dec = self.first_stage_model.decoder
        t = z.shape[1]
        step = t if chunk_size is None else chunk_size
        return torch.cat([dec(z[:, i:i + step], refs)
                          for i in range(0, t, step)], dim=1)

    def decode_plain(self, z):
        """Scaled latents (B, T, h, w, 4) -> video (B, T, H, W, 3), every
        frame alone through post_quant_conv and the plain decoder (a
        ``dualref=False`` model)."""
        if self.dualref:
            raise TypeError("decode_plain runs the plain decoder; this model "
                            "holds the dual-ref one (build it with "
                            "dualref=False)")
        b, t = z.shape[:2]
        flat = (z / self.config.scale_factor).to(self.dtype).reshape(
            (b * t,) + z.shape[2:])
        out = self.first_stage_model.decode(flat)
        return out.reshape((b, t) + out.shape[1:])


def middle_frame_splice(model: ToonCrafter, samples, refs,
                        chunk_size: Optional[int] = None, timed=None):
    """Decode twice and put the two center frames of a decode whose latent
    frames {1, -2} were dropped into the full one. ``timed(name, fn,
    *args)``, when given, runs each decode (``Pipeline._timed``)."""
    run = timed or (lambda name, fn, *args: fn(*args))
    full = run("decode", model.decode_first_stage, samples, refs, chunk_size)
    t = samples.shape[1]
    keep = [i for i in range(t) if i not in (1, t - 2)]
    partial = run("decode_splice", model.decode_first_stage,
                  samples[:, keep], refs, chunk_size)
    mid = full.shape[1] // 2
    full[:, mid - 1:mid + 1] = partial[:, mid - 2:mid]
    return full


class Pipeline:
    """The interpolation path with per-phase wall times (``timings``)."""

    def __init__(self, model: ToonCrafter, ddim_steps: int = 50,
                 eta: float = 1.0, spacing: str = "uniform_trailing",
                 guidance: Optional[GuidanceConfig] = None,
                 mode: str = "interp", use_splice: bool = True,
                 perframe_ae: bool = False):
        self.model = model
        self.use_splice = use_splice
        self.guidance = guidance or GuidanceConfig(cfg_scale=7.5,
                                                   guidance_rescale=0.7)
        self.mode = mode
        self.ddim = dict(ddim_steps=ddim_steps, eta=eta, spacing=spacing)
        self.enc_chunk = 1 if perframe_ae else None
        self.dec_chunk = model.config.video_length if perframe_ae else None
        self.timings: Dict[str, float] = {}

    def _timed(self, name: str, fn, *args, **kwargs):
        dev = next(self.model.parameters()).device
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings[name] = time.perf_counter() - t0
        return out

    def conditioning(self, tokens, null_tokens, frame0):
        m = self.model
        text = m.encode_text(tokens)
        uc_text = (torch.zeros_like(text) if m.config.uncond_type ==
                   "zero_embed" else m.encode_text(null_tokens))
        img = m.encode_image_context(frame0)
        uc_img = m.encode_image_context(torch.zeros_like(frame0))
        cond = torch.cat([text, img], dim=1)
        uc = torch.cat([uc_text, uc_img], dim=1)
        n = self.guidance.num_branches
        if n == 3:
            return torch.stack([uc, torch.cat([uc_text, img], 1), cond])
        return torch.stack([uc, cond]) if n == 2 else cond[None]

    def decode(self, samples, refs):
        if not self.use_splice:
            return self._timed("decode", self.model.decode_first_stage,
                               samples, refs, self.dec_chunk)
        return middle_frame_splice(self.model, samples, refs, self.dec_chunk,
                                   timed=self._timed)

    @torch.no_grad()
    def __call__(self, video, tokens, null_tokens, fs,
                 generator: R.Generators = None,
                 x_T: Optional[torch.Tensor] = None):
        """video (B, T, H, W, 3) in [-1, 1]; tokens, null_tokens (B, 77);
        fs (B,). The posterior is sampled from ``generator`` when one is
        given (its mode otherwise); x_T is drawn from it unless passed, then
        the steps' noise. ``generator`` is one torch.Generator for the whole
        batch or B of them (``utils/rngs.per_item_generators``): then clip i
        draws its posterior, x_T and step noise, in that order, from its
        own, and its noise does not depend on the batch around it.
        Returns (B, T, H, W, 3) fp32."""
        m = self.model
        self.timings = {}
        z, refs = self._timed("encode", m.encode_first_stage, video,
                              generator, generator is not None,
                              self.enc_chunk)
        concat = m.build_concat_cond(z, self.mode)
        contexts = self._timed("conditioning", self.conditioning, tokens,
                               null_tokens, video[:, 0])
        if x_T is None:
            x_T = R.normal(generator, z.shape, z.device)
        samples = self._timed("denoise", m.denoise, x_T.float(), contexts,
                              concat, fs.float(), self.guidance,
                              generator=generator, **self.ddim)
        return self.decode(samples, refs).float()
