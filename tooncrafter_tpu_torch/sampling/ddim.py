"""DDIM sampling with the CFG branches batched into one UNet call
(tooncrafter_tpu/sampling/ddim.py): v -> eps, CFG rescale, dynamic rescale
of x0, per-step noise from an explicit ``torch.Generator`` (or one per
batch item, ``utils/rngs.py``); the temperature, the mask/x0 latent blend,
``stochastic_encode`` and ``ddim_decode_from`` (the sampler's img2img
path)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tooncrafter_tpu_torch.ops.schedule import (DDIMSchedule,
                                                DiffusionSchedule,
                                                rescale_noise_cfg)
from tooncrafter_tpu_torch.utils import rngs as R


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """cfg_scale: text guidance scale; cfg_img: optional image scale (the
    3-branch form); guidance_rescale: std-rescale of the combination."""

    cfg_scale: float = 7.5
    cfg_img: Optional[float] = None
    guidance_rescale: float = 0.0

    @property
    def num_branches(self) -> int:
        if self.cfg_scale == 1.0:
            return 1
        return 3 if self.cfg_img is not None and self.cfg_img != 1.0 else 2


@torch.no_grad()
def ddim_sample(denoiser: Callable, sched: DiffusionSchedule,
                ddim: DDIMSchedule, x_T: torch.Tensor,
                contexts: torch.Tensor, concat: torch.Tensor,
                fs: torch.Tensor, guidance: GuidanceConfig,
                generator: R.Generators = None, temperature: float = 1.0,
                mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                clean_cond: bool = False) -> torch.Tensor:
    """Run the DDIM loop from x_T (B, T, h, w, C) fp32.

    ``denoiser(x, t, context, fs)`` receives the CFG-batched tensors;
    ``contexts`` stacks the branches (n, B, L, D) as [uncond, (uncond_img,)
    cond]. Per-step noise (sigma > 0) is drawn from ``generator``: one
    generator for the batch, or a sequence of B, one per item.
    ``temperature`` scales every sigma (the noise and the direction term).

    ``mask`` (broadcastable to x, 1 = keep x0) blends the latent at the
    start of every step: the masked region becomes ``x0`` itself
    (``clean_cond``) or x0 noised to the step's marginal by q_sample, its
    noise drawn from ``generator`` before the step's own noise."""
    if mask is not None and x0 is None:
        raise ValueError("mask blending requires x0")
    n = guidance.num_branches
    b = x_T.shape[0]
    ctx_flat = contexts.reshape((n * b,) + contexts.shape[2:])
    concat_n = concat.repeat((n,) + (1,) * (concat.ndim - 1))
    fs_n = fs.repeat(n)
    sqrt_ab = sched.sqrt_alphas_cumprod
    sqrt_1mab = sched.sqrt_one_minus_alphas_cumprod
    x = x_T
    for i in reversed(range(ddim.num_steps)):
        t_idx = int(ddim.timesteps[i])
        a_prev = ddim.alphas_prev[i]
        sigma = ddim.sigmas[i] * np.float32(temperature)
        if mask is not None:
            orig = x0 if clean_cond else sched.q_sample(
                x0, torch.full((b,), t_idx, device=x.device),
                R.normal(generator, x.shape, x.device, x.dtype))
            x = orig * mask + (1.0 - mask) * x
        xin = torch.cat([x.repeat((n,) + (1,) * (x.ndim - 1)),
                         concat_n.to(x.dtype)], dim=-1)
        ts = torch.full((n * b,), float(t_idx), device=x.device)
        v_all = denoiser(xin, ts, ctx_flat, fs_n).reshape(
            (n, b) + x.shape[1:])
        if n == 1:
            v = v_all[0]
        elif n == 2:
            e_uc, e_c = v_all[0], v_all[1]
            v = e_uc + guidance.cfg_scale * (e_c - e_uc)
            if guidance.guidance_rescale > 0:
                v = rescale_noise_cfg(v, e_c, guidance.guidance_rescale)
        else:
            e_uc, e_uc_img, e_c = v_all[0], v_all[1], v_all[2]
            v = (e_uc + guidance.cfg_img * (e_uc_img - e_uc)
                 + guidance.cfg_scale * (e_c - e_uc_img))
            if guidance.guidance_rescale > 0:
                v = rescale_noise_cfg(v, e_c, guidance.guidance_rescale)

        if sched.parameterization == "v":
            a, s = float(sqrt_ab[t_idx]), float(sqrt_1mab[t_idx])
            e_t = a * v + s * x
            pred_x0 = a * x - s * v
        else:
            a_t = ddim.alphas[i]
            e_t = v
            pred_x0 = (x - float(np.sqrt(np.float32(1.0) - a_t)) * e_t) \
                / float(np.sqrt(a_t))
        if ddim.scale_arr is not None:
            pred_x0 = pred_x0 * float(ddim.scale_arr_prev[i]
                                      / ddim.scale_arr[i])
        dir_coef = np.sqrt(np.maximum(
            np.float32(1.0) - a_prev - sigma ** 2, np.float32(0.0)))
        x = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
        if sigma > 0:
            x = x + float(sigma) * R.normal(generator, x.shape, x.device,
                                            x.dtype)
    return x


def stochastic_encode(ddim: DDIMSchedule, x0: torch.Tensor, step_index: int,
                      generator: R.Generators = None) -> torch.Tensor:
    """Noise x0 to the marginal of DDIM step ``step_index``:
    sqrt(a) x0 + sqrt(1 - a) eps over the sub-schedule, eps drawn from
    ``generator`` (one, or one per item)."""
    a = float(ddim.alphas[step_index])
    noise = R.normal(generator, x0.shape, x0.device, x0.dtype)
    return float(np.sqrt(a)) * x0 + float(np.sqrt(1.0 - a)) * noise


def ddim_decode_from(denoiser: Callable, sched: DiffusionSchedule,
                     ddim: DDIMSchedule, x_t: torch.Tensor,
                     contexts: torch.Tensor, concat: torch.Tensor,
                     fs: torch.Tensor, guidance: GuidanceConfig,
                     t_start: int,
                     generator: R.Generators = None) -> torch.Tensor:
    """The DDIM loop from step ``t_start`` (exclusive) down to 0 on the
    sub-schedule: the img2img path after ``stochastic_encode``."""
    cut = lambda a: None if a is None else a[:t_start]
    sub = DDIMSchedule(
        timesteps=cut(ddim.timesteps), alphas=cut(ddim.alphas),
        alphas_prev=cut(ddim.alphas_prev), sigmas=cut(ddim.sigmas),
        sqrt_one_minus_alphas=cut(ddim.sqrt_one_minus_alphas),
        scale_arr=cut(ddim.scale_arr),
        scale_arr_prev=cut(ddim.scale_arr_prev))
    return ddim_sample(denoiser, sched, sub, x_t, contexts, concat, fs,
                       guidance, generator)
