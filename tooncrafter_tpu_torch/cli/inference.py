"""Inference CLI of the PyTorch port, with the flags of
tooncrafter_tpu/cli/inference.py (the upstream scripts/evaluation/
inference.py parser):

  python -m tooncrafter_tpu_torch.cli.inference \
      --config configs/inference_512_v1.0.yaml \
      --prompt_dir prompts/512_interp --savedir results/ \
      --height 320 --width 512 --interp --text_input \
      --unconditional_guidance_scale 7.5 --ddim_steps 50 --ddim_eta 1.0 \
      --timestep_spacing uniform_trailing --guidance_rescale 0.7 \
      --frame_stride 10 --seed 123

  torchrun --nproc_per_node N -m tooncrafter_tpu_torch.cli.inference ...

It runs on one CUDA device and refuses to start without one unless
``--device cpu`` is passed (fp32, the kernels' plain versions). Under
torchrun each rank takes ``cuda:{LOCAL_RANK}`` over NCCL (gloo with
``--device cpu``), takes rank 0's weights and runs its ``batch_slice`` of
the prompts (contiguous, the remainder on the first ranks, none dropped),
writing its own clips; a clip's noise is keyed by its global index, so it
does not depend on the world size. Without
--ckpt_path the weights are random, drawn from --seed. Each clip's noise
comes from its own generator, seeded from (--seed, its global index
prompt * n_samples + sample) (``utils/rngs.py``), so --bs 2 writes the
videos --bs 1 writes. Optional packages:
Pillow reads the input images; OpenCV writes mp4 (without it each clip is
written as PNG frames through Pillow); ``regex`` is needed only with
--bpe_path (the CLIP tokenizer's pattern).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time
import warnings

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--savedir", type=str, default="results")
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--prompt_dir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frame_stride", type=int, default=10)
    p.add_argument("--unconditional_guidance_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--negative_prompt", action="store_true")
    p.add_argument("--text_input", action="store_true")
    p.add_argument("--multiple_cond_cfg", action="store_true")
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--timestep_spacing", type=str, default="uniform_trailing")
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    # default None: fall back to the model YAML's `perframe_ae`
    p.add_argument("--perframe_ae", action="store_true", default=None)
    p.add_argument("--loop", action="store_true")
    p.add_argument("--interp", action="store_true")
    p.add_argument("--bpe_path", type=str, default=None,
                   help="CLIP BPE merges file (ships with the checkpoint)")
    p.add_argument("--save_fps", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one card, bf16) or cpu (fp32)")
    return p


def load_data_prompts(data_dir, video_size, video_frames, interp):
    """Image pairs (or single images) + prompts.txt -> (names, clips
    (T, H, W, 3) in [-1, 1], prompts)."""
    from tooncrafter_tpu_torch.utils.video_io import load_image
    from tooncrafter_tpu_torch.ops.resize import center_crop_resize

    prompt_files = sorted(glob.glob(os.path.join(data_dir, "*.txt")))
    if not prompt_files:
        raise FileNotFoundError(f"no prompt .txt in {data_dir}")
    with open(prompt_files[0]) as f:
        prompts = [l.strip() for l in f if l.strip()]
    images = sorted(sum((glob.glob(os.path.join(data_dir, e)) for e in
                         ("*.png", "*.jpg", "*.jpeg", "*.JPEG", "*.PNG")),
                        []))

    def frame(path):
        img = torch.from_numpy(load_image(path)[None])
        return center_crop_resize(img, *video_size).numpy()

    data, names = [], []
    for i in range(len(prompts)):
        if interp:
            a, b = frame(images[2 * i]), frame(images[2 * i + 1])
            half = video_frames // 2
            vid = np.concatenate([np.repeat(a, half, 0),
                                  np.repeat(b, video_frames - half, 0)], 0)
            names.append(os.path.basename(images[2 * i]))
        else:
            vid = np.repeat(frame(images[i]), video_frames, 0)
            names.append(os.path.basename(images[i]))
        data.append(vid)
    return names, data, prompts


def build_model(config_path, ckpt_path, height: int, width: int,
                video_length: int, seed: int, device: torch.device):
    """The model of ``config_path`` (the default config without one) at
    height x width and video_length frames on ``device``, bf16 on a card
    and fp32 on the CPU, with the weights of ``ckpt_path`` or random ones
    drawn from ``seed``. The inference CLI and the serving backend build
    their model here."""
    from tooncrafter_tpu_torch.config import ModelConfig, model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = model_config_from_yaml(config_path) if config_path \
        else ModelConfig()
    cfg = dataclasses.replace(
        cfg, video_length=video_length, latent_h=height // 8,
        latent_w=width // 8,
        compute_dtype=(torch.float32 if device.type == "cpu"
                       else torch.bfloat16))
    with torch.device(device):
        model = ToonCrafter(cfg)
    if ckpt_path:
        from tooncrafter_tpu_torch.utils.checkpoint import \
            load_torch_state_dict
        missing, _ = model.load_state_dict(
            load_torch_state_dict(ckpt_path), strict=False)
        if missing:
            warnings.warn(f"{len(missing)} parameters missing from "
                          f"{ckpt_path}", stacklevel=2)
    else:
        warnings.warn("no checkpoint: using random weights (smoke mode)",
                      stacklevel=2)
        init_random_(model, torch.Generator(device).manual_seed(seed))
    return model.to_compute_dtype().eval()


def main(argv=None):
    args = get_parser().parse_args(argv)
    from tooncrafter_tpu_torch.cli import resolve_device
    from tooncrafter_tpu_torch.parallel import mesh as M

    d = M.init_distributed(resolve_device(args.device))
    try:
        _infer(args, d)
    finally:
        if d.group is not None:
            torch.distributed.destroy_process_group()


def _infer(args, d):
    from tooncrafter_tpu_torch.models.diffusion import Pipeline
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import rngs as R
    from tooncrafter_tpu_torch.utils.tokenizer import ClipTokenizer
    from tooncrafter_tpu_torch.utils.video_io import write_video

    device = d.device
    t_start = time.time()
    model = build_model(args.config, args.ckpt_path, args.height,
                        args.width, args.video_length, args.seed, device)
    M.replicate_(model, 0, d.group)
    tokenizer = None
    if args.bpe_path:
        tokenizer = ClipTokenizer(bpe_path=args.bpe_path)
    elif args.text_input:
        warnings.warn("--text_input without --bpe_path: prompts will be "
                      "IGNORED (zero tokens for both cond and uncond)",
                      stacklevel=2)
    names, data, prompts = load_data_prompts(
        args.prompt_dir, (args.height, args.width), args.video_length,
        args.interp)
    guidance = GuidanceConfig(
        cfg_scale=args.unconditional_guidance_scale,
        cfg_img=args.cfg_img if args.multiple_cond_cfg else None,
        guidance_rescale=args.guidance_rescale)
    perframe_ae = (model.config.perframe_ae if args.perframe_ae is None
                   else args.perframe_ae)
    pipe = Pipeline(model, ddim_steps=args.ddim_steps, eta=args.ddim_eta,
                    spacing=args.timestep_spacing, guidance=guidance,
                    mode="interp" if (args.interp or args.loop) else "repeat",
                    perframe_ae=perframe_ae)
    os.makedirs(os.path.join(args.savedir, "samples_separate"),
                exist_ok=True)
    bs = max(1, args.bs)
    sel = M.batch_slice(len(prompts), d.rank, d.world)
    mine = list(range(sel.start, sel.stop))
    for i0 in range(0, len(mine), bs):
        chunk = mine[i0:i0 + bs]
        batch_prompts = [prompts[j] if args.text_input else "" for j in chunk]
        if tokenizer is not None:
            tokens = torch.as_tensor(np.asarray(tokenizer(batch_prompts)))
            null_tokens = torch.as_tensor(
                np.asarray(tokenizer([""]))).repeat(len(chunk), 1)
        else:
            tokens = torch.zeros((len(chunk), 77), dtype=torch.long)
            null_tokens = torch.zeros_like(tokens)
        video = torch.from_numpy(np.stack([data[j] for j in chunk]))
        fs = torch.full((len(chunk),), float(args.frame_stride))
        for n in range(args.n_samples):
            gens = R.per_item_generators(
                args.seed, [j * args.n_samples + n for j in chunk], device)
            out = pipe(video.to(device), tokens.to(device),
                       null_tokens.to(device), fs.to(device), generator=gens)
            print("phase seconds: " + ", ".join(
                f"{k} {v:.2f}" for k, v in pipe.timings.items()))
            for k, idx in enumerate(chunk):
                out_np = out[k].cpu().numpy()
                if args.loop:
                    out_np = out_np[:-1]
                stem = os.path.splitext(names[idx])[0]
                path = os.path.join(args.savedir, "samples_separate",
                                    f"{stem}_sample{n}.mp4")
                print(f"saved {write_video(path, out_np, fps=args.save_fps)}")
    print(f"Saved in {args.savedir}. Time used: "
          f"{time.time() - t_start:.2f} seconds")


if __name__ == "__main__":
    main()
