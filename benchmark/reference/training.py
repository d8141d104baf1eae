"""The reference training step, in float32: the v-prediction diffusion loss
of DynamiCrafter / ToonCrafter training (``lvdm.models.ddpm3d``), its
gradients by autograd, and AdamW.

The loss of a batch {'video', 'tokens', 'null_tokens', 'fs', 'fps'} under the
step's draws {'posterior', 'rand', 'cond_frame', 'ts', 'noise'}: the clip
encoded frame by frame and sampled from its posterior; the text context
replaced by the empty prompt's where rand < 2u and the conditioning frame
by zeros where u <= rand < 3u (u = uncond_prob, the 3-way classifier-free
dropout); the image context from the resampler (trainable) over the frozen
CLIP vision tokens; the conditioning frame's latent repeated over T as the
concat; x0 dynamically rescaled by scale_arr[t], noised to t, the v target;
the UNet in training mode (dropout on), conditioned on the frame stride
or the frame rate as ``fps_condition_type`` says; the MSE over each clip,
averaged.
Imports nothing but torch, numpy and the reference model.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import diffusion as RD
from benchmark.reference import model as RM

TRAINABLE = ("model.diffusion_model.", "image_proj_model.")


def trainables(ref: RM.ToonCrafterRef) -> Dict[str, torch.nn.Parameter]:
    out = {}
    for name, p in ref.named_parameters():
        keep = name.startswith(TRAINABLE)
        p.requires_grad_(keep)
        if keep:
            out[name] = p
    return out


def gather(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)
    out = out[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def loss(ref: RM.ToonCrafterRef, batch: Dict[str, torch.Tensor],
         draws: Dict[str, torch.Tensor], uncond_prob: float) -> torch.Tensor:
    cfg = ref.cfg
    sched = RD.schedule(cfg)
    video = batch["video"]
    b, t = video.shape[:2]
    ref.eval()
    ref.unet.train(True)
    with torch.no_grad():
        z, _ = ref.encode(video, draws["posterior"])
        u, rand = uncond_prob, draws["rand"]
        drop_text = (rand < 2 * u)[:, None, None]
        drop_image = ((rand >= u) & (rand < 3 * u))[:, None, None, None]
        text = torch.where(drop_text, ref.text(batch["null_tokens"]),
                           ref.text(batch["tokens"]))
        cf = int(draws["cond_frame"])
        img = video[:, cf]
        img = torch.where(drop_image, torch.zeros_like(img), img)
        img_tokens = ref.embedder.model.visual(
            RM.clip_preprocess(img, cfg["clip_image_size"]))
    context = torch.cat([text, ref.image_proj_model(img_tokens)], dim=1)
    concat = z[:, cf:cf + 1].expand_as(z)
    ts = draws["ts"].long()
    ab = sched.alphas_cumprod
    x0 = z * gather(sched.scale_arr, ts, z.ndim)
    a = gather(np.sqrt(ab), ts, z.ndim)
    s = gather(np.sqrt(1.0 - ab), ts, z.ndim)
    noise = draws["noise"]
    x_noisy = a * x0 + s * noise
    target = a * noise - s * x0
    signal = batch["fs" if cfg["fps_condition_type"] == "fs" else "fps"]
    pred = ref.unet(torch.cat([x_noisy, concat], dim=-1), ts.float(),
                    context, signal.float())
    return torch.mean(torch.square(pred - target), dim=(1, 2, 3, 4)).mean()


class AdamW:
    """Decoupled weight decay Adam (arXiv 1711.05101), fp32 state."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.n = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.n += 1
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m / c1, (v / c2).sqrt_().add_(self.eps),
                       value=-self.lr)
