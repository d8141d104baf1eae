"""The JAX package's two low-memory optimizer profiles as torch optimizers
(tooncrafter_tpu/training/trainer.py:43-50, 73-91).

  * ``AdamWLowMem`` ('adamw_lowmem'): ``optax.adamw(lr, weight_decay=wd,
    mu_dtype=bfloat16)``: the AdamW rule with the first moment stored in
    bf16 (the second stays fp32). Its cast points, as optax 0.2.6 computes
    them: ``b1 * mu`` in bf16 (JAX gives the Python float a weak type, so
    b1 itself rounds to bf16, 0.8984375, and the product rounds once), the
    sum with ``(1 - b1) * g`` in fp32, the update from that fp32 mu, and
    only the stored mu rounded to bf16.
  * ``Adafactor`` ('adafactor'): ``optax.adafactor(lr,
    weight_decay_rate=wd or None, momentum=None)`` with every default:
    ``scale_by_factored_rms`` (decay 1 - (k + 1)^-0.8, eps 1e-30, the
    second moment factored into row and column means over the two largest
    dims where the second largest is >= 128, else kept whole),
    ``clip_by_block_rms(1.0)``, the learning rate,
    ``scale_by_param_block_rms`` (the update times max(rms(p), 1e-3)), then
    ``add_decayed_weights``: weight decay not scaled by the learning rate.
    The factored estimate is symmetric in its two dims, so torch's weight
    layouts ((O, I, kh, kw)) give the update the JAX layouts
    ((kh, kw, I, O)) give.

Both take the learning rate from ``group['lr']`` (the trainer's LambdaLR
sets it before each update, as optax reads its schedule at the update's
count) and keep a ``step`` count per parameter. ``state_dict`` round-trips
each profile's state as it is: bf16 mu stays bf16 (torch's loader would
cast it to the parameter's dtype), the factored rows and columns keep
their shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


# optax.adamw's and optax.adafactor's defaults, the only values the JAX
# package uses
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
DECAY_RATE, FACTORED_EPS, MIN_DIM_SIZE_TO_FACTOR = 0.8, 1e-30, 128
CLIPPING_THRESHOLD, MIN_SCALE = 1.0, 1e-3
# b1 as a bf16 product sees it: the weak-typed Python float rounded to bf16
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))


class AdamWLowMem(torch.optim.Optimizer):
    """optax.adamw with ``mu_dtype=bfloat16``; see the module docstring."""

    def __init__(self, params, lr: float = 1.0, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                k = int(st["step"])
                mu, nu = st["mu"], st["nu"]
                m = g * (1.0 - B1)
                m += mu * B1_BF16                 # the bf16 product
                nu.mul_(B2).add_(g.square().mul_(1.0 - B2))
                u = m / (1.0 - B1 ** k)
                u /= (nu / (1.0 - B2 ** k)).sqrt_().add_(ADAM_EPS)
                u += p * wd
                p.add_(u.mul_(-lr))
                mu.copy_(m)                       # only the stored mu rounds
        return loss

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "mu" in st:
                st["mu"] = st["mu"].to(torch.bfloat16)


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second largest and the largest dim, where the second
    largest is at least MIN_DIM_SIZE_TO_FACTOR (optax's ``_factored_dims``,
    ties broken by numpy's argsort as there)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    rms = x.square().mean().sqrt()
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor without momentum; see the module docstring.
    ``weight_decay`` None (or 0) adds no decay."""

    def __init__(self, params, lr: float = 1.0,
                 weight_decay: Optional[float] = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group["lr"], group["weight_decay"])
        return loss

    def _update(self, p, lr: float, wd: Optional[float]) -> None:
        g = p.grad.float()
        st = self.state[p]
        dims = _factored_dims(p.shape)
        if not st:
            st["step"] = torch.tensor(0.0)
            if dims is None:
                st["v"] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                st["v_row"] = p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:],
                                          dtype=torch.float32)
                st["v_col"] = p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:],
                                          dtype=torch.float32)
        # the decay at this update's count (before it increments), in fp32
        t = torch.tensor(float(st["step"]) + 1.0)
        decay = float(1.0 - t ** -DECAY_RATE)
        st["step"] += 1
        g2 = g.square().add_(FACTORED_EPS)
        if dims is None:
            v = st["v"].mul_(decay).add_(g2.mul_(1.0 - decay))
            u = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = st["v_row"].mul_(decay).add_(
                g2.mean(d0).mul_(1.0 - decay))
            v_col = st["v_col"].mul_(decay).add_(
                g2.mean(d1).mul_(1.0 - decay))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt_()
            u = g * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        # clip_by_block_rms, the learning rate, scale_by_param_block_rms
        u /= torch.clamp_min(u.square().mean().sqrt() / CLIPPING_THRESHOLD,
                             1.0)
        u *= lr
        u *= _safe_rms(p.float(), MIN_SCALE)
        if wd:
            u += p * wd
        p.sub_(u)
