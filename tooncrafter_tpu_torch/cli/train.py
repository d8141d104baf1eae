"""Training CLI of the PyTorch port (tooncrafter_tpu/cli/train.py, same
flags): config-driven data and model construction, the LR scaled by the
global batch, periodic checkpoints, sampled-video logging, validation,
SIGUSR1 save-on-preemption, auto-resume.

  python -m tooncrafter_tpu_torch.cli.train --config config.yaml \\
      --name run0 --logdir ./runs [--train] [--device cpu]
  torchrun --nproc_per_node N -m tooncrafter_tpu_torch.cli.train ...

It runs on a card (bf16 autocast over fp32 master weights) and refuses to
start without one unless ``--device cpu`` is passed (fp32). Under torchrun
each rank takes ``cuda:{LOCAL_RANK}`` over NCCL (gloo with ``--device
cpu``), loads its shard of the data, trains on a batch of the YAML's
``batch_size`` (a global batch of that times the world size, and the
learning rate ``base_learning_rate x batch_size x world``, the
reference's rule), with the gradients all-reduced and the optimizer state
split by owner (``training/trainer.py``); rank 0 logs, prints, samples and
writes the checkpoints, and SIGUSR1 on any rank checkpoints every rank at
the next step. ``--n_model_shards k`` builds the (world / k, k) mesh, as
the JAX CLI does: the UNet's transformer blocks are sharded over each group
of k consecutive ranks (tensor parallelism, ``parallel/tensor.py``), which
share their data shard, batch rows and dropout seed; the global batch is
then ``batch_size`` times world / k, and the learning rate keeps the
reference's ``x world`` (the JAX CLI's ``n_chips`` counts every device).
The optimizer is read from the YAML's
``model.params.optimizer`` when present: 'adamw' (the default),
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

    from tooncrafter_tpu_torch.parallel import mesh as M

    from tooncrafter_tpu_torch.cli import resolve_device
    joined = torch.distributed.is_initialized()  # a group the caller owns
    d = M.init_distributed(resolve_device(args.device))
    try:
        if args.n_model_shards < 1 or d.world % args.n_model_shards:
            raise SystemExit(f"--n_model_shards {args.n_model_shards} does "
                             f"not divide the {d.world} ranks of this run")
        _train(args, d)
    finally:
        if d.group is not None and not joined:
            torch.distributed.destroy_process_group()


def _train(args, d):
    import torch

    from tooncrafter_tpu_torch.parallel import mesh as M

    device = d.device
    lead = d.rank == 0
    k = args.n_model_shards
    mesh = (M.make_mesh(n_model=k, device_type=device.type)
            if d.group is not None else None)
    # the ranks of a model group share their data and their dropout draws
    drank, n_data = d.rank // k, d.world // k

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
    torch.manual_seed(args.seed + drank)  # dropout's stream, per data rank
    with torch.device(device):
        model = ToonCrafter(cfg)

    workdir = os.path.join(args.logdir, args.name)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    os.makedirs(workdir, exist_ok=True)
    logger = CB.MetricLogger(workdir) if lead else None

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

    def dataset(split, default_dir=""):
        return WebVidDataset(
            meta_path=split.get("meta_path", ""),
            data_dir=split.get("data_dir", default_dir),
            video_length=split.get("video_length", cfg.video_length),
            frame_stride=split.get("frame_stride", 6),
            resolution=split.get("resolution", res),
            fps_max=split.get("fps_max"), fixed_fps=split.get("fixed_fps"))

    # each rank loads a disjoint shard of every epoch (the reference's
    # DistributedSampler)
    shard = (drank, n_data)
    loader = PrefetchLoader(dataset(train_d), bs, tokenizer=tokenizer,
                            num_workers=dcfg.get("num_workers", 4),
                            seed=args.seed, shard=shard)
    val_d = dcfg.get("validation", {}).get("params", {})
    val_loader = None
    if val_d.get("meta_path"):
        val_loader = PrefetchLoader(
            dataset(val_d, train_d.get("data_dir", "")), bs,
            tokenizer=tokenizer, num_workers=2, seed=args.seed + 1,
            shard=shard)

    # ---- params / optimizer ----
    lr = base_lr * bs * d.world  # the reference's rule: the global batch
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
        if lead:
            print(f"warm start: {len(missing)} missing (left at their "
                  "random init)")

    # with a mesh every rank takes rank 0's weights and owns a share of
    # the optimizer state
    state, opt = T.make_train_state(model, tcfg, use_ema=True, group=mesh)
    if args.auto_resume:
        state, start_step = CKPT.restore_train_state(ckpt_dir, state)
        if lead:
            print(f"resumed at step {start_step}")

    step_fn = T.make_train_step(model, opt, tcfg)
    val_fn = T.make_val_step(model, tcfg)
    sampler_log = CB.VideoSampleLogger(model, workdir,
                                       every_steps=args.sample_every,
                                       write=lead)
    tracker = CB.ThroughputTracker(bs * n_data)
    gen = torch.Generator(device).manual_seed(args.seed)
    # data rank 0 alone samples clips (its model group together, rank 0
    # writes them): with more than one rank they draw from a generator of
    # their own, so every rank's training draws stay equal
    sample_gen = (gen if d.world == 1 else
                  torch.Generator(device).manual_seed(args.seed + 1))

    # SIGUSR1 -> checkpoint now (preemption hook); the flag is all-reduced
    # every step, so every rank checkpoints together
    want_ckpt = {"now": False}
    signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(now=True))

    def ckpt_now() -> bool:
        if d.group is None:
            return want_ckpt["now"]
        flag = torch.tensor([float(want_ckpt["now"])], device=device)
        torch.distributed.all_reduce(flag)  # every rank of the mesh
        return bool(flag.item() > 0)

    if not args.train:
        if lead:
            print("dry run complete (pass --train to start)")
        return
    if device.type == "cuda" and d.group is not None:
        # rank 0 builds the kernels (one nvcc each); the others wait and
        # load them
        if lead:
            from tooncrafter_tpu_torch.utils import kernel_check as kc
            kc.build_all()
        M.barrier(state.group, device)

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
            if lead:
                logger.log(step, metrics)
                if step % 50 == 0:
                    print(f"step {step}: loss={metrics['loss']:.4f} "
                          f"({metrics.get('samples_per_sec', 0):.2f} "
                          "samples/s)")
            if drank == 0:
                out = sampler_log.maybe_log(step, state, probe, sample_gen)
                if out and lead:
                    print(f"sampled video -> {out}")
            if val_loader is not None and step % args.val_every == 0:
                try:
                    vb = next(val_iter)
                except StopIteration:
                    val_iter = iter(val_loader)
                    vb = next(val_iter)
                vm = {k: float(v) for k, v in
                      val_fn(state, to_device(vb, device), gen).items()}
                if lead:
                    logger.log(step, vm)
                    print(f"step {step}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in vm.items()))
            if step % args.ckpt_every == 0 or ckpt_now():
                CKPT.save_train_state(ckpt_dir, step, state)
                want_ckpt["now"] = False
            if step >= args.max_steps:
                break
    CKPT.save_train_state(ckpt_dir, step, state)
    if lead:
        logger.close()
        print(f"done at step {step}")


if __name__ == "__main__":
    main()
