"""One-command end-to-end smoke of the PyTorch port: a tiny random-weight
model through the full pipeline (tooncrafter_tpu/cli/smoke.py).

    python -m tooncrafter_tpu_torch.cli.smoke [--steps N] [--out DIR] \\
        [--device cpu]

Builds the tiny config (the 512 model's topology, every tower shrunk),
runs encode -> conditioning -> DDIM -> dual-ref decode with the
middle-frame splice, checks the clip is finite and writes it (an mp4, or
PNG frames without OpenCV) as ``DIR.mp4``. It runs on one CUDA device
(bf16) and refuses to start without one unless ``--device cpu`` is passed
(fp32). ``main`` returns the clip.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "tooncrafter_smoke"))
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one card, bf16) or cpu (fp32)")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from tooncrafter_tpu_torch.cli import resolve_device
    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils.video_io import write_video
    from tooncrafter_tpu_torch.utils.weights import init_random_

    dev = resolve_device(args.device)
    t0 = time.time()
    cfg = dataclasses.replace(
        ModelConfig().tiny(),
        compute_dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16)
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(0))
    model.to_compute_dtype().eval()
    print(f"[smoke] tiny model initialized in {time.time() - t0:.1f}s "
          f"on {dev}")

    t = cfg.video_length
    h_px, w_px = cfg.latent_h * 8, cfg.latent_w * 8
    g = torch.Generator().manual_seed(1)
    fa = torch.rand(1, 1, h_px, w_px, 3, generator=g) * 2 - 1
    fb = torch.rand(1, 1, h_px, w_px, 3, generator=g) * 2 - 1
    video = torch.cat([fa.expand(1, t // 2, h_px, w_px, 3),
                       fb.expand(1, t - t // 2, h_px, w_px, 3)], 1).to(dev)
    tokens = torch.zeros((1, 77), dtype=torch.long, device=dev)

    pipe = Pipeline(model, ddim_steps=args.steps,
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7))
    out = pipe(video, tokens, tokens, torch.full((1,), 10.0, device=dev),
               generator=torch.Generator(dev).manual_seed(3))
    arr = out[0].float().cpu().numpy()
    if not np.isfinite(arr).all():
        raise SystemExit("[smoke] non-finite output")
    path = write_video(f"{args.out}.mp4", arr, fps=8)
    print(f"[smoke] OK: {tuple(out.shape)} -> {path} "
          f"(total {time.time() - t0:.1f}s)")
    return out


if __name__ == "__main__":
    main()
