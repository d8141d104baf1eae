"""Training CLI of the PyTorch port (tooncrafter_tpu/cli/train.py, same
flags): config-driven data and model construction, the LR scaled by the
global batch, periodic checkpoints, sampled-video logging, validation,
SIGUSR1 save-on-preemption, auto-resume.

  python -m tooncrafter_tpu_torch.cli.train --config config.yaml \\
      --name run0 --logdir ./runs [--train] [--device cpu]

It runs on ``cuda:0`` (bf16 autocast over fp32 master weights) and refuses
to start without a card unless ``--device cpu`` is passed (fp32). One card:
``--n_model_shards`` above 1 is refused. The optimizer is read from the
YAML's ``model.params.optimizer`` when present: 'adamw' (the default),
'adamw_lowmem' or 'adafactor', the JAX package's memory profiles (its CLI
ignores the key and trains AdamW).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import warnings


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--logdir", type=str, default="./runs")
    p.add_argument("--train", action="store_true")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--sample_every", type=int, default=500)
    p.add_argument("--val_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=20230211)
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="torch ckpt to warm-start from (any dialect)")
    p.add_argument("--ignore_keys", type=str, default="",
                   help="comma-separated torch-key prefixes to drop from "
                        "the pretrained ckpt")
    p.add_argument("--only_model", action="store_true",
                   help="load only the denoiser weights from the ckpt")
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--n_model_shards", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the card, the default) or 'cpu'")
    return p


def warm_start(model, path: str, ignore_keys=(), only_model: bool = False):
    """Load an upstream checkpoint into ``model``; returns the missing
    keys."""
    from tooncrafter_tpu_torch.utils.checkpoint import load_torch_state_dict

    sd = load_torch_state_dict(path)
    sd = {k: v for k, v in sd.items()
          if not any(k.startswith(ik) for ik in ignore_keys)}
    if only_model:
        sd = {k: v for k, v in sd.items()
              if k.startswith("model.diffusion_model.")}
    missing, _ = model.load_state_dict(sd, strict=False)
    return missing


def to_device(batch, device):
    """A loader batch (numpy) as tensors on ``device``."""
    import numpy as np
    import torch

    out = {"video": torch.from_numpy(np.asarray(batch["video"], np.float32)),
           "fs": torch.from_numpy(np.asarray(batch["fs"])),
           "fps": torch.from_numpy(np.asarray(batch["fps"], np.float32))}
    for k in ("tokens", "null_tokens"):
        out[k] = torch.from_numpy(np.asarray(batch[k], np.int64))
    return {k: v.to(device) for k, v in out.items()}


def main(argv=None):
    args = get_parser().parse_args(argv)
    import torch

    if args.n_model_shards > 1:
        raise SystemExit("--n_model_shards > 1: multi-device training is "
                         "not ported (one card)")
    from tooncrafter_tpu_torch.cli import resolve_device
    device = resolve_device(args.device)

    from tooncrafter_tpu_torch.config import load_yaml, model_config_from_dict
    from tooncrafter_tpu_torch.data.webvid import PrefetchLoader, WebVidDataset
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import callbacks as CB
    from tooncrafter_tpu_torch.training import checkpoints as CKPT
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.tokenizer import ClipTokenizer
    from tooncrafter_tpu_torch.utils.weights import init_random_

    raw = load_yaml(args.config)
    cfg = model_config_from_dict(raw)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    torch.manual_seed(args.seed)  # dropout's stream
    with torch.device(device):
        model = ToonCrafter(cfg)

    workdir = os.path.join(args.logdir, args.name)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    os.makedirs(workdir, exist_ok=True)
    logger = CB.MetricLogger(workdir)

    # ---- data ----
    dcfg = raw.get("data", {}).get("params", {})
    train_d = dcfg.get("train", {}).get("params", {})
    base_lr = raw.get("model", {}).get("base_learning_rate", 1e-5)
    bs = dcfg.get("batch_size", 1)
    if args.bpe_path:
        tokenizer = ClipTokenizer(bpe_path=args.bpe_path)
    else:
        warnings.warn(
            "no --bpe_path: falling back to byte-level tokenization, which "
            "matches NO released CLIP checkpoint; text conditioning will be "
            "garbage outside smoke runs", stacklevel=2)
        tokenizer = ClipTokenizer(merges=[])
    res = [cfg.latent_h * 8, cfg.latent_w * 8]

    def dataset(d, default_dir=""):
        return WebVidDataset(
            meta_path=d.get("meta_path", ""),
            data_dir=d.get("data_dir", default_dir),
            video_length=d.get("video_length", cfg.video_length),
            frame_stride=d.get("frame_stride", 6),
            resolution=d.get("resolution", res), fps_max=d.get("fps_max"),
            fixed_fps=d.get("fixed_fps"))

    loader = PrefetchLoader(dataset(train_d), bs, tokenizer=tokenizer,
                            num_workers=dcfg.get("num_workers", 4),
                            seed=args.seed)
    val_d = dcfg.get("validation", {}).get("params", {})
    val_loader = None
    if val_d.get("meta_path"):
        val_loader = PrefetchLoader(
            dataset(val_d, train_d.get("data_dir", "")), bs,
            tokenizer=tokenizer, num_workers=2, seed=args.seed + 1)

    # ---- params / optimizer ----
    lr = base_lr * bs  # the reference's scaling rule, one card
    mp = raw.get("model", {}).get("params", {})
    tcfg = T.TrainConfig(
        learning_rate=lr,
        uncond_prob=mp.get("uncond_prob", 0.05),
        rand_cond_frame=mp.get("rand_cond_frame", True),
        optimizer=mp.get("optimizer", "adamw"),
        scheduler=mp.get("scheduler_config"))
    lr_of_step = tcfg.lr_schedule()

    init_random_(model, torch.Generator(device).manual_seed(args.seed))
    if args.pretrained_ckpt:
        ik = tuple(k for k in args.ignore_keys.split(",") if k)
        missing = warm_start(model, args.pretrained_ckpt, ik, args.only_model)
        print(f"warm start: {len(missing)} missing (left at their "
              "random init)")

    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    if args.auto_resume:
        state, start_step = CKPT.restore_train_state(ckpt_dir, state)
        print(f"resumed at step {start_step}")

    step_fn = T.make_train_step(model, opt, tcfg)
    val_fn = T.make_val_step(model, tcfg)
    sampler_log = CB.VideoSampleLogger(model, workdir,
                                       every_steps=args.sample_every)
    tracker = CB.ThroughputTracker(bs)
    gen = torch.Generator(device).manual_seed(args.seed)

    # SIGUSR1 -> checkpoint now (preemption hook)
    want_ckpt = {"now": False}
    signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(now=True))

    if not args.train:
        print("dry run complete (pass --train to start)")
        return

    probe = None
    val_iter = iter(val_loader) if val_loader is not None else None
    step = state.step
    while step < args.max_steps:
        for batch in loader:
            tb = to_device(batch, device)
            if probe is None:
                probe = tb
            state, metrics = step_fn(state, tb, gen)
            step = state.step
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(tracker.step())
            metrics.update(CB.device_memory_stats(device)
                           if device.type == "cuda" else {})
            metrics["lr"] = float(lr_of_step(step))
            logger.log(step, metrics)
            if step % 50 == 0:
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"({metrics.get('samples_per_sec', 0):.2f} samples/s)")
            out = sampler_log.maybe_log(step, state, probe, gen)
            if out:
                print(f"sampled video -> {out}")
            if val_loader is not None and step % args.val_every == 0:
                try:
                    vb = next(val_iter)
                except StopIteration:
                    val_iter = iter(val_loader)
                    vb = next(val_iter)
                vm = {k: float(v) for k, v in
                      val_fn(state, to_device(vb, device), gen).items()}
                logger.log(step, vm)
                print(f"step {step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in vm.items()))
            if step % args.ckpt_every == 0 or want_ckpt["now"]:
                CKPT.save_train_state(ckpt_dir, step, state)
                want_ckpt["now"] = False
            if step >= args.max_steps:
                break
    CKPT.save_train_state(ckpt_dir, step, state)
    logger.close()
    print(f"done at step {step}")


if __name__ == "__main__":
    main()
