"""Where the card's time goes: a torch.profiler breakdown of one denoise
step (one CFG-batched UNet call) and one dual-ref decode of a 16-frame
interpolation model (``--config``, by default the 320x512 model's
configs/inference_512_v1.0.yaml; configs/inference_1024_v1.0.yaml for the
576x1024 model), by kernel and by kind; with ``--train``, of one training
step of the 512 model (configs/training_512_v1.0.yaml, batch 2, AdamW +
EMA) and its phases.

    python -m tooncrafter_tpu_torch.utils.profiling [--config YAML] [--train]

The JAX package's opt-in switches apply as they do to the CLI, read at
import: ``TC_TATTN_PAIR=0 TC_SPATIAL_CONV_PALLAS=1 TOONCRAFTER_FUSED_GN=1``
before the command profiles the switched routes (the single-stage temporal
attention, the im2col-named conv, the one-pass GroupNorm).

Needs a CUDA device. Device busy time is the sum of kernel times (one
stream) from a trace of CUDA activity only. Wall time comes from separate
runs without the profiler, timed on the host around a synchronize; the
idle share is 1 - busy / wall.
"""

from __future__ import annotations

import dataclasses
import statistics
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

KINDS = (
    ("flash attention (port kernel)", ("flash_fwd_wgmma", "flash_fwd_d512")),
    ("flash attention backward (port kernel)", ("flash_bwd_",)),
    ("fused FF (port kernel)", ("fused_ff_kernel",)),
    ("temporal conv (port kernel)", ("igemm::tconv_kernel",)),
    ("GN+SiLU+3x3 conv (port kernel)", ("::conv_kernel<",)),
    ("temporal attention pair / single stage (port kernel)",
     ("tpair_kernel",)),
    ("T-attention core (port kernel)", ("ptc_kernel",)),
    ("one-pass GroupNorm (port kernel)", ("gn_partial", "gn_finalize",
                                          "gn_apply")),
    ("convolution", ("conv", "implicit", "winograd", "fprop", "dgrad",
                     "nhwc", "xmma_fprop")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "matmul", "sm90_")),
    ("norm / softmax / reduce", ("norm", "softmax", "reduce", "welford",
                                 "var_mean")),
    ("elementwise / copy", ("elementwise", "copy", "cat", "index",
                            "fill", "silu", "gelu")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


SEED = 123
WALL_RUNS = 5


def profile(fn: Callable[[], object]) -> Tuple[float, List[Tuple[str, float,
                                                                  int]]]:
    """Time ``fn`` without instrumentation (median of WALL_RUNS runs, after
    a warm-up), then trace one run's CUDA activity. Returns (wall ms,
    [(kernel name, device ms, calls)] by device time)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    print(f"   uninstrumented wall ms: "
          + ", ".join(f"{w:.2f}" for w in walls))
    return statistics.median(walls), rows


def report(title: str, wall: float, rows, top: int = 15) -> Dict[str, float]:
    busy = sum(r[1] for r in rows)
    by_kind: Dict[str, float] = defaultdict(float)
    for name, ms, _ in rows:
        by_kind[kind_of(name)] += ms
    print(f"-- {title}: wall (median) {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"   {kind:32s} {ms:10.2f} ms {ms / busy:6.1%}")
    for name, ms, calls in rows[:top]:
        print(f"   {ms:10.2f} ms {calls:6d}x  {name[:110]}")
    return dict(by_kind, wall_ms=wall, busy_ms=busy)


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAIN_STEPS = 6


def random_batch(cfg, b: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A training batch made from ``seed``: ``b`` clips of uniform noise in
    [-1, 1] at the config's geometry, random tokens, empty null tokens,
    frame stride 3, 8 fps."""
    g = torch.Generator(device).manual_seed(seed)
    t, h, w = cfg.video_length, cfg.latent_h * 8, cfg.latent_w * 8
    return {"video": torch.rand(b, t, h, w, 3, generator=g,
                                device=device) * 2 - 1,
            "tokens": torch.randint(0, 49408, (b, 77), generator=g,
                                    device=device),
            "null_tokens": torch.zeros(b, 77, dtype=torch.long,
                                       device=device),
            "fs": torch.full((b,), 3, device=device),
            "fps": torch.full((b,), 8.0, device=device)}


def _timed(fn: Callable[[], object]) -> Tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_breakdown(dev) -> None:
    """Steps of the 512 training model: the whole step's wall time per
    step; then the phases of a step run piecewise with a synchronize
    between them (frozen encoders, the forward through the loss, the
    backward, the AdamW update and the EMA); then one traced step by
    kernel kind."""
    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(
        model_config_from_yaml(os.path.join(REPO, "configs",
                                            "training_512_v1.0.yaml")),
        compute_dtype=torch.bfloat16)
    torch.manual_seed(SEED)
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    tcfg = T.TrainConfig(learning_rate=2e-5)
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    step_fn = T.make_train_step(model, opt, tcfg)
    g = torch.Generator(dev).manual_seed(SEED)
    batch = random_batch(cfg, 2, SEED, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = [_timed(lambda: step_fn(state, batch, g))[1]
             for _ in range(TRAIN_STEPS)]
    print("-- training step (B=2, 16x320x512, AdamW + EMA): wall ms "
          + ", ".join(f"{w:.1f}" for w in walls) + f"; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    params = list(state.train_params.values())
    phases: Dict[str, List[float]] = defaultdict(list)
    for _ in range(3):
        draws = T.sample_draws(model, batch["video"], g)

        def encode():
            with torch.no_grad(), T.autocast(model, dev):
                model.encode_first_stage(batch["video"],
                                         noise=draws["posterior"],
                                         chunk_size=1)
                model.encode_text(batch["tokens"])
                model.encode_text(batch["null_tokens"])
                model.image_tokens(batch["video"][:, 0])
        phases["frozen encoders (VAE, CLIP text x2, CLIP vision)"].append(
            _timed(encode)[1])
        (loss, _), ms = _timed(lambda: T._loss(model, tcfg, state, batch,
                                               None, draws, True))
        phases["forward through the loss (encoders included)"].append(ms)
        phases["backward"].append(_timed(loss.backward)[1])
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        phases["AdamW update + EMA"].append(
            _timed(lambda: T.update(state, tcfg, grads))[1])
    for name, ms in phases.items():
        print(f"   {name:52s} " + ", ".join(f"{m:.1f}" for m in ms) + " ms")
    report("training step (traced)", *profile(
        lambda: step_fn(state, batch, g)), top=25)


def main() -> None:
    import argparse

    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.weights import init_random_

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "inference_512_v1.0.yaml"),
                    help="the inference model's YAML")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of inference")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.train:
        train_breakdown(dev)
        return
    cfg = dataclasses.replace(model_config_from_yaml(args.config),
                              compute_dtype=torch.bfloat16)
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    model.to_compute_dtype().eval()
    g = torch.Generator(dev).manual_seed(SEED)
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    x = torch.randn(2, t, h, w, cfg.unet_in_channels, generator=g,
                    device=dev)
    ts = torch.full((2,), 500.0, device=dev)
    ctx = torch.randn(2, 77 + t * cfg.resampler_queries, cfg.context_dim,
                      generator=g, device=dev)
    fs = torch.full((2,), 10.0, device=dev)
    z = torch.randn(1, t, h, w, cfg.z_channels, generator=g, device=dev)
    refs = [torch.randn(1, 2, h * 8 >> i, w * 8 >> i, cfg.vae_ch * m,
                        generator=g, device=dev, dtype=torch.bfloat16)
            for i, m in enumerate(cfg.vae_ch_mult)]
    refs.append(torch.randn(1, 2, h * 8, w * 8, cfg.vae_ch, generator=g,
                            device=dev, dtype=torch.bfloat16))
    geometry = f"{h * 8}x{w * 8}"
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        report(f"denoise step (UNet, 2 CFG branches x 16 frames, {geometry})",
               *profile(lambda: model.unet(x, ts, ctx, fs)))
        report(f"dual-ref decode (16 frames, {geometry})",
               *profile(lambda: model.decode_first_stage(z, refs)))
    print(f"peak memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    main()
