"""Diffusion schedule math.

The per-timestep constants are computed in float64 numpy at build time and
stored as float32 numpy, exactly as tooncrafter_tpu/ops/schedule.py does;
the tensor functions (``rescale_noise_cfg``, ``timestep_embedding`` and the
schedule's ``q_sample``, ``get_v`` and ``dynamic_rescale``) run in torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """float64 betas of shape (n_timestep,)."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                           n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                 + cosine_s)
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"unknown beta schedule '{schedule}'")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Algorithm 1 of arXiv 2305.08891: the last step gets zero SNR."""
    alphas_bar = np.cumprod(1.0 - betas, axis=0)
    sqrt_ab = np.sqrt(alphas_bar)
    sqrt_ab_0 = sqrt_ab[0].copy()
    sqrt_ab_T = sqrt_ab[-1].copy()
    sqrt_ab = (sqrt_ab - sqrt_ab_T) * sqrt_ab_0 / (sqrt_ab_0 - sqrt_ab_T)
    alphas_bar = sqrt_ab ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_ddim_timesteps(method: str, num_ddim_steps: int,
                        num_ddpm_steps: int) -> np.ndarray:
    """DDIM step indices, with the reference's +1 ('uniform', 'quad') and
    -1 ('uniform_trailing') offsets."""
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        return np.arange(0, num_ddpm_steps, c, dtype=np.int64) + 1
    if method == "uniform_trailing":
        c = num_ddpm_steps / num_ddim_steps
        steps = np.flip(np.round(np.arange(num_ddpm_steps, 0, -c)))
        return steps.astype(np.int64) - 1
    if method == "quad":
        return (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                            num_ddim_steps) ** 2).astype(np.int64) + 1
    raise NotImplementedError(f"unknown ddim discretization '{method}'")


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-step (sigma, alpha, alpha_prev), arXiv 2010.02502 eq. 16."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1],
                                  alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale=0.0):
    """Rescale the CFG-combined prediction toward the text branch's std
    (population std, guarded against a zero-variance prediction)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg.clamp_min(1e-12))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """[cos | sin] sinusoidal embedding; timesteps (N,) -> (N, dim) fp32."""
    half = dim // 2
    ts = torch.as_tensor(timesteps, dtype=torch.float32)
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=ts.device) / half)
    args = ts[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep constants of the DDPM process (float32 numpy)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    scale_arr: Optional[np.ndarray]
    num_timesteps: int
    parameterization: str  # 'eps' | 'x0' | 'v'

    # ---- the training loss's process math (per-sample constants) ----

    def gather(self, arr: np.ndarray, t, ndim: int) -> torch.Tensor:
        """arr[t] as fp32 on t's device, shaped (B, 1, ..., 1) to broadcast
        over an ndim-dimensional tensor."""
        t = torch.as_tensor(t)
        out = torch.as_tensor(arr, device=t.device)[t.long()]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def q_sample(self, x_start, t, noise):
        """Forward diffusion q(x_t | x_0)."""
        a = self.gather(self.sqrt_alphas_cumprod, t, x_start.ndim)
        s = self.gather(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
        return a * x_start + s * noise

    def get_v(self, x, noise, t):
        """v-target: v = sqrt(ab) eps - sqrt(1 - ab) x."""
        a = self.gather(self.sqrt_alphas_cumprod, t, x.ndim)
        s = self.gather(self.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        return a * noise - s * x

    def dynamic_rescale(self, x, t):
        """x * scale_arr[t], applied to x0 before q_sample in training."""
        if self.scale_arr is None:
            return x
        return x * self.gather(self.scale_arr, t, x.ndim)


def build_schedule(timesteps: int = 1000, beta_schedule: str = "linear",
                   linear_start: float = 0.00085, linear_end: float = 0.012,
                   cosine_s: float = 8e-3,
                   given_betas: Optional[np.ndarray] = None,
                   rescale_betas_zero_snr: bool = True,
                   parameterization: str = "v", v_posterior: float = 0.0,
                   use_dynamic_rescale: bool = True, base_scale: float = 0.7,
                   turning_step: int = 400) -> DiffusionSchedule:
    betas = (np.asarray(given_betas, np.float64) if given_betas is not None
             else make_beta_schedule(beta_schedule, timesteps,
                                     linear_start, linear_end, cosine_s))
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = ((1 - v_posterior) * betas
                          * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod) + v_posterior * betas)
    if parameterization == "eps":
        with np.errstate(divide="ignore", invalid="ignore"):
            lvlb = betas ** 2 / (2 * posterior_variance * alphas
                                 * (1 - alphas_cumprod))
    elif parameterization == "x0":
        lvlb = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    elif parameterization == "v":
        lvlb = np.ones_like(betas)
    else:
        raise NotImplementedError(parameterization)
    lvlb = lvlb.copy()
    lvlb[0] = lvlb[1]
    scale_arr = None
    if use_dynamic_rescale:
        # ramp 1.0 -> base_scale over turning_step, then flat
        scale_arr = np.concatenate([
            np.linspace(1.0, base_scale, turning_step),
            np.full(timesteps, base_scale)]).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    with np.errstate(divide="ignore"):
        log_omac = np.log(1.0 - alphas_cumprod)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(log_omac),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)),
        lvlb_weights=f32(lvlb),
        scale_arr=scale_arr,
        num_timesteps=int(timesteps),
        parameterization=parameterization,
    )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step constants, ascending in DDPM time."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    scale_arr: Optional[np.ndarray]
    scale_arr_prev: Optional[np.ndarray]

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def build_ddim_schedule(sched: DiffusionSchedule, num_steps: int,
                        eta: float = 1.0,
                        spacing: str = "uniform_trailing") -> DDIMSchedule:
    tsteps = make_ddim_timesteps(spacing, num_steps, sched.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        sched.alphas_cumprod.astype(np.float64), tsteps, eta)
    scale_arr = scale_arr_prev = None
    if sched.scale_arr is not None:
        scale_arr = sched.scale_arr[tsteps]
        scale_arr_prev = np.concatenate([scale_arr[:1], scale_arr[:-1]])
    f32 = lambda a: np.asarray(a, np.float32)
    return DDIMSchedule(
        timesteps=tsteps.astype(np.int32),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sigmas=f32(sigmas),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        scale_arr=None if scale_arr is None else f32(scale_arr),
        scale_arr_prev=None if scale_arr_prev is None else f32(scale_arr_prev),
    )
