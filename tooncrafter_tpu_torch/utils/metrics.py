"""Video quality metrics (tooncrafter_tpu/utils/metrics.py): PSNR, SSIM
with a separable Gaussian window, the per-clip video PSNR, and the LPIPS
hook, which needs weights (``models/lpips.py``) or a feature extractor.
Inputs are channels-last (..., H, W, C) in [-1, 1] by default."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a, b, data_range: float = 2.0):
    """Peak signal-to-noise ratio (dB) per leading index of (..., H, W, C)."""
    mse = (a.float() - b.float()).square().mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def ssim(a, b, data_range: float = 2.0, size: int = 11,
         sigma: float = 1.5):
    """Structural similarity of (..., H, W, C) images, the mean over
    channels and the valid window positions (Wang et al. 2004)."""
    a, b = a.float(), b.float()
    lead = a.shape[:-3]
    h, w, c = a.shape[-3:]
    win = _gaussian_kernel(size, sigma).to(a.device)
    kh, kw = win.view(1, 1, size, 1), win.view(1, 1, 1, size)

    def blur(x):  # (N, H, W, C) -> valid separable Gaussian per channel
        x = x.permute(0, 3, 1, 2).reshape(-1, 1, h, w)
        x = F.conv2d(F.conv2d(x, kh), kw)
        return x.reshape(-1, c, x.shape[-2], x.shape[-1])

    a = a.reshape(-1, h, w, c)
    b = b.reshape(-1, h, w, c)
    mu_a, mu_b = blur(a), blur(b)
    saa = blur(a * a) - mu_a ** 2
    sbb = blur(b * b) - mu_b ** 2
    sab = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2))
    out = s.mean(dim=(1, 2, 3))
    return out.reshape(lead) if lead else out[0]


def video_psnr(a, b):
    """(B, T, H, W, C) -> the per-clip mean PSNR over frames."""
    return psnr(a, b).mean(dim=-1)


def lpips(a, b, feature_fn=None, params=None):
    """Perceptual distance of (B, H, W, 3) images. ``params``: the state
    dict from ``models/lpips.load_lpips_params`` (VGG16 features and the
    LPIPS lin heads) runs the full LPIPS head; else ``feature_fn(images)
    -> list of (B, H_l, W_l, C_l)`` gives the unweighted variant. The
    weights are not shipped."""
    if params is not None:
        from tooncrafter_tpu_torch.models.lpips import LPIPS

        model = LPIPS().to(a.device)
        model.load_state_dict(params)
        return model(a, b)
    if feature_fn is None:
        raise ValueError(
            "lpips needs weights: pass params= from "
            "tooncrafter_tpu_torch.models.lpips.load_lpips_params "
            "(torchvision vgg16 features + lpips lin state dicts), or a raw "
            "feature_fn")
    dist = 0.0
    for xa, xb in zip(feature_fn(a), feature_fn(b)):
        na = xa / xa.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        nb = xb / xb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        dist = dist + (na - nb).square().sum(dim=-1).mean(dim=(-2, -1))
    return dist
