"""The diffusion process and the DDIM sampler of the reference, in float32.

The v-parameterised schedule with zero terminal SNR (arXiv 2305.08891), the
DDIM step (arXiv 2010.02502, eq. 12 and 16) with 'uniform_trailing'
spacing, classifier-free guidance with its rescale (arXiv 2305.08891,
eq. 15-16), and the dynamic rescale of the predicted x0 that
DynamiCrafter's sampler applies (a ramp from 1 to ``base_scale`` over the
first ``turning_step`` timesteps). Numpy float64 for the per-step
constants, torch for the tensors. Imports nothing but torch and numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas_cumprod: np.ndarray   # float64, (T,)
    scale_arr: np.ndarray        # float32, (T,)


def schedule(cfg: dict) -> Schedule:
    n = cfg["timesteps"]
    betas = np.linspace(cfg["linear_start"] ** 0.5, cfg["linear_end"] ** 0.5,
                        n, dtype=np.float64) ** 2
    ab = np.cumprod(1.0 - betas)
    s = np.sqrt(ab)
    s = (s - s[-1]) * s[0] / (s[0] - s[-1])   # zero terminal SNR
    ab = s ** 2
    # through betas and back, as the rescaled schedule is stored
    alphas = np.concatenate([ab[:1], ab[1:] / ab[:-1]])
    ab = np.cumprod(alphas)
    ramp = np.concatenate([np.linspace(1.0, cfg["base_scale"],
                                       cfg["turning_step"]),
                           np.full(n, cfg["base_scale"])]).astype(np.float32)
    return Schedule(ab, ramp)


@dataclasses.dataclass(frozen=True)
class DDIM:
    timesteps: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    scale: np.ndarray       # scale_arr[t_prev] / scale_arr[t], per step


def ddim(sched: Schedule, steps: int, eta: float) -> DDIM:
    n = sched.alphas_cumprod.shape[0]
    c = n / steps
    ts = np.flip(np.round(np.arange(n, 0, -c))).astype(np.int64) - 1
    ab32 = sched.alphas_cumprod.astype(np.float32).astype(np.float64)
    a = ab32[ts]
    a_prev = np.concatenate([ab32[:1], ab32[ts[:-1]]])
    sig = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    sa = sched.scale_arr[ts]
    sa_prev = np.concatenate([sa[:1], sa[:-1]])
    return DDIM(ts, a_prev.astype(np.float32), sig.astype(np.float32),
                sa_prev / sa)


def guide(v_all, cfg_scale: float, rescale: float):
    """[uncond, cond] predictions (2, B, ...) -> the guided prediction."""
    e_uc, e_c = v_all[0], v_all[1]
    v = e_uc + cfg_scale * (e_c - e_uc)
    if rescale > 0:
        dims = tuple(range(1, e_c.ndim))
        std_c = e_c.std(dim=dims, keepdim=True, correction=0)
        std_v = v.std(dim=dims, keepdim=True, correction=0)
        v = rescale * v * (std_c / std_v.clamp_min(1e-12)) \
            + (1.0 - rescale) * v
    return v


def step(sched: Schedule, dd: DDIM, i: int, x, v, noise):
    """One DDIM step at index i (descending) from x with the guided
    v-prediction v and this step's standard normal ``noise``."""
    t = int(dd.timesteps[i])
    a = float(np.float32(np.sqrt(sched.alphas_cumprod[t])))
    s = float(np.float32(np.sqrt(1.0 - sched.alphas_cumprod[t])))
    e_t = a * v + s * x
    x0 = (a * x - s * v) * float(dd.scale[i])
    sigma = float(dd.sigmas[i])
    a_prev = float(dd.alphas_prev[i])
    dir_coef = float(np.sqrt(max(1.0 - a_prev - sigma ** 2, 0.0)))
    x = float(np.sqrt(a_prev)) * x0 + dir_coef * e_t
    return x + sigma * noise if sigma > 0 else x


def per_item_normal(gens, shape, device):
    """(B, *shape) standard normals, item i's drawn from gens[i]."""
    return torch.stack([torch.randn(tuple(shape), generator=g, device=device)
                        for g in gens])
