"""Ancestral DDPM sampling over the full schedule
(tooncrafter_tpu/sampling/ddpm.py): each step predicts x0 (from v, eps or
x0 itself), takes the posterior q(x_{t-1} | x_t, x0) mean and adds noise
with the clipped posterior log-variance, none at t = 0. The validation
path beside DDIM; the inference path uses DDIM."""

from __future__ import annotations

from typing import Callable

import torch

from tooncrafter_tpu_torch.ops.schedule import DiffusionSchedule
from tooncrafter_tpu_torch.utils import rngs as R


@torch.no_grad()
def ddpm_sample(denoiser: Callable, sched: DiffusionSchedule,
                x_T: torch.Tensor, contexts: torch.Tensor,
                concat: torch.Tensor, fs: torch.Tensor,
                generator: R.Generators = None,
                clip_denoised: bool = False) -> torch.Tensor:
    """``sched.num_timesteps`` steps from x_T (B, T, h, w, C) fp32.
    ``contexts`` is (1, B, L, D): the base path runs no guidance. The noise
    of every step but the last is drawn from ``generator`` (one, or one per
    item)."""
    b = x_T.shape[0]
    ctx = contexts.reshape((-1,) + contexts.shape[2:])
    x = x_T
    for t in range(sched.num_timesteps - 1, -1, -1):
        tb = torch.full((b,), t, device=x.device)
        out = denoiser(torch.cat([x, concat.to(x.dtype)], dim=-1),
                       tb.float(), ctx, fs)
        g = lambda arr: sched.gather(arr, tb, x.ndim)
        if sched.parameterization == "v":
            x0 = (g(sched.sqrt_alphas_cumprod) * x
                  - g(sched.sqrt_one_minus_alphas_cumprod) * out)
        elif sched.parameterization == "eps":
            x0 = ((x - g(sched.sqrt_one_minus_alphas_cumprod) * out)
                  / g(sched.sqrt_alphas_cumprod).clamp_min(1e-8))
        else:
            x0 = out
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        x = (g(sched.posterior_mean_coef1) * x0
             + g(sched.posterior_mean_coef2) * x)
        if t > 0:
            x = x + torch.exp(0.5 * g(sched.posterior_log_variance_clipped)) \
                * R.normal(generator, x.shape, x.device, x.dtype)
    return x
