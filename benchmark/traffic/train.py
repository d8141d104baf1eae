"""Training steps in a closed loop: ``training.trainer.make_train_step``'s
``step_fn`` with the state and optimizer ``cli/train.py`` builds for the
training YAML (fp32 master weights, bf16 autocast, AdamW at the reference's
learning rate rule, base rate times the batch), without EMA as the YAML
sets it. Each step takes a batch and the step's draws made on the device
from (seed, step), and dropout's generator seeded from them.

Set-up builds the one state and drives it through its first
``check_steps`` steps, keeping what the comparison reads; then a warm-up
step; then the window: steps are issued while fewer than ``seconds`` have
passed, each ended by a synchronize.

The comparison (after the window, the program freed): the float32
reference (``benchmark/reference/training.py``) follows the same steps from
the same weights, batches, draws and dropout masks.

  loss_err    each step's loss, |program - reference| / |reference|
  grad_err    the first step's gradient, the program's taken from AdamW's
              first moment after one step (m = (1 - b1) g): by the worst
              leaf, | |g_p| - |g_r| | / max(|g_r|, the median leaf's |g_r|)
  update_err  each parameter's change after the checked steps, the same
              measure; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (they move by
              round-off alone)
"""

from __future__ import annotations

import gc
import math
import time
import traceback
from typing import Dict, List

import torch

from benchmark.harness import core, counts
from benchmark.harness import trace as T
from benchmark.harness.weights import fill_, rules, seed64
from benchmark.reference import model as RM
from benchmark.reference import training as RT


def batch(seed: int, step: int, b: int, cfg: dict, mix: dict, device):
    from benchmark.traffic import i2v

    t, h, w = cfg["video_length"], cfg["latent_h"] * 8, cfg["latent_w"] * 8
    g = torch.Generator(device).manual_seed(seed64(seed, step, 1))
    vids, toks = [], []
    for _ in range(b):
        frames = i2v.keyframes(g, h, w, device)           # two keyframes
        mix_t = torch.linspace(0, 1, t, device=device)[:, None, None, None]
        vids.append(frames[0] * (1 - mix_t) + frames[1] * mix_t)
        toks.append(i2v.tokens(g, device))
    null = torch.zeros(b, 77, dtype=torch.long, device=device)
    null[:, :2] = torch.tensor(i2v.NULL_TOKENS, device=device)
    return {"video": torch.stack(vids), "tokens": torch.stack(toks),
            "null_tokens": null,
            "fs": torch.full((b,), mix["frame_stride"], device=device),
            "fps": torch.full((b,), float(mix["fps"]), device=device)}


def draws(seed: int, step: int, b: int, cfg: dict, device):
    """The step's draws in the trainer's form (``sample_draws``)."""
    t, h, w = cfg["video_length"], cfg["latent_h"], cfg["latent_w"]
    g = torch.Generator(device).manual_seed(seed64(seed, step, 2))
    kw = dict(generator=g, device=device)
    return {"posterior": torch.randn((b * t, h, w, cfg["z_channels"]), **kw),
            "rand": torch.rand(b, **kw),
            "cond_frame": torch.randint(0, t, (), **kw),
            "ts": torch.randint(0, cfg["timesteps"], (b,), **kw),
            "noise": torch.randn((b, t, h, w, cfg["z_channels"]), **kw)}


def seed_dropout(seed: int, step: int) -> None:
    torch.manual_seed(seed64(seed, step, 3))


def train_config(cfg: dict, mix: dict):
    from tooncrafter_tpu_torch.training import trainer as TR

    return TR.TrainConfig(learning_rate=mix["base_learning_rate"]
                          * mix["batch"],
                          uncond_prob=mix["uncond_prob"],
                          rand_cond_frame=mix["rand_cond_frame"],
                          optimizer="adamw", scheduler=None)


def build_program(cfg: dict, mix: dict, seed: int, device):
    from benchmark.traffic import i2v
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import trainer as TR

    mc = i2v.model_config(cfg, device)
    with torch.device("meta"):
        model = ToonCrafter(mc)
    model = model.to_empty(device=device)
    fill_(model, seed, torch.float32)        # fp32 master weights
    tcfg = train_config(cfg, mix)
    state, opt = TR.make_train_state(model, tcfg, use_ema=False)
    return model, state, TR.make_train_step(model, opt, tcfg)


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return [float(n) for n in torch._foreach_norm(tensors)]


def first_steps(model, state, step_fn, seed, cfg, mix, device,
                n: int) -> Dict[str, list]:
    """Drive the state through its first n steps, keeping each loss, the
    first gradient's leaf norms (from AdamW's first moment) and the leaf
    norms of the parameters' change after the n steps."""
    names = list(state.train_params)
    params = [state.train_params[k] for k in names]
    start = [p.detach().clone() for p in params]
    b = mix["batch"]
    out = {"loss": []}
    for k in range(n):
        seed_dropout(seed, k)
        _, m = step_fn(state, batch(seed, k, b, cfg, mix, device),
                       draws=draws(seed, k, b, cfg, device))
        out["loss"].append(float(m["loss"]))
        if k == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            out["grad"] = dict(zip(names, (v / (1 - beta1) for v in leaf_norms(
                [state.optimizer.state[p]["exp_avg"] for p in params]))))
    torch._foreach_sub_(start, [p.detach() for p in params])
    out["update"] = dict(zip(names, leaf_norms(start)))
    del start
    return out


def reference_steps(ref, seed, cfg, mix, device, n: int) -> Dict[str, list]:
    """The same n steps by the float32 reference."""
    train = RT.trainables(ref)
    names = list(train)
    params = [train[k] for k in names]
    start = [p.detach().clone() for p in params]
    opt = RT.AdamW(params, mix["base_learning_rate"] * mix["batch"],
                   mix["weight_decay"])
    b = mix["batch"]
    out = {"loss": []}
    for k in range(n):
        seed_dropout(seed, k)
        loss = RT.loss(ref, batch(seed, k, b, cfg, mix, device),
                       draws(seed, k, b, cfg, device), mix["uncond_prob"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        out["loss"].append(float(loss.detach()))
        if k == 0:
            out["grad"] = dict(zip(names, leaf_norms(grads)))
        opt.step(grads)
        del grads, loss
    torch._foreach_sub_(start, [p.detach() for p in params])
    out["update"] = dict(zip(names, leaf_norms(start)))
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers, leaves matched by name (a leaf one side lacks
    reads infinite)."""
    if set(prog["grad"]) != set(ref["grad"]):
        return {"loss_err": math.inf, "grad_err": math.inf,
                "update_err": math.inf}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    rg, pg = ref["grad"], prog["grad"]
    gm = med(list(rg.values()))
    grad = max(abs(pg[k] - rg[k]) / max(rg[k], gm) for k in rg)
    ru, pu = ref["update"], prog["update"]
    um = med(list(ru.values()))
    update = max(abs(pu[k] - ru[k]) / max(ru[k], um) for k in ru
                 if rg[k] >= 1e-3 * gm)
    return {"loss_err": loss, "grad_err": grad, "update_err": update}


def build_reference(cfg: dict, seed: int, device, fp8: bool = False):
    with torch.device("meta"):
        ref = RM.ToonCrafterRef(cfg)
    ref = ref.to_empty(device=device)
    fill_(ref, seed, torch.float32)
    RM.set_ops(ref, RM.Ops(fp8=fp8))
    mask = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    for m in ref.modules():
        if isinstance(m, RM.Dropout):
            m.mask_dtype = mask
    return ref


def step_flops(cfg: dict, b: int) -> float:
    """Model FLOPs of a step: the UNet and resampler forward three times
    (forward, and twice its products for the backward; recomputation not
    counted), the frozen encoder and CLIP towers once."""
    t, h, w = cfg["video_length"], cfg["latent_h"], cfg["latent_w"]

    def frozen():
        ref = RM.ToonCrafterRef(cfg)
        video = torch.zeros(b, t, h * 8, w * 8, 3)
        ref.encode(video, torch.zeros(b * t, h, w, cfg["z_channels"]))
        tok = torch.zeros(b, 77, dtype=torch.long)
        ref.text(tok), ref.text(tok)
        ref.embedder.model.visual(torch.zeros(b, cfg["clip_image_size"],
                                              cfg["clip_image_size"], 3))

    def trained():
        ref = RM.ToonCrafterRef(cfg)
        tokens = ref.image_proj_model(torch.zeros(
            b, (cfg["clip_image_size"] // 14) ** 2 + 1,
            cfg["clip_vision_width"]))
        ctx = torch.cat([torch.zeros(b, 77, cfg["context_dim"]), tokens], 1)
        ref.unet(torch.zeros(b, t, h, w, cfg["unet_in_channels"]),
                 torch.zeros(b), ctx, torch.zeros(b))

    return counts.model_flops(frozen) + 3 * counts.model_flops(trained)


def run(ctx) -> core.Run:
    cfg, mix, seed, device = ctx.config, ctx.mix, ctx.seed, ctx.device
    b = mix["batch"]
    out = core.Run()
    t_imports = time.monotonic() - ctx.t_start
    model, state, step_fn = build_program(cfg, mix, seed, device)
    names = [(n, tuple(p.shape)) for n, p, _ in rules(model)]
    ctx.sync()
    t_model = time.monotonic() - ctx.t_start
    n = mix["check_steps"]
    prog = first_steps(model, state, step_fn, seed, cfg, mix, device, n)
    ctx.sync()
    t_checked = time.monotonic() - ctx.t_start
    k = n
    for _ in range(mix["warmup_steps"]):
        seed_dropout(seed, k)
        step_fn(state, batch(seed, k, b, cfg, mix, device),
                draws=draws(seed, k, b, cfg, device))
        k += 1
    ctx.sync()
    out.setup_s = time.monotonic() - ctx.t_start
    core.log(f"setup {out.setup_s:.3f} s: to the loop {t_imports:.3f}, "
             f"model and state made {t_model - t_imports:.3f}, checked "
             f"steps {t_checked - t_model:.3f}, warm-up "
             f"{out.setup_s - t_checked:.3f}; losses {prog['loss']}")
    ctx.reset_peak()

    t_open = time.perf_counter()
    times = []
    while True:
        t0 = time.perf_counter()
        out.attempted += 1
        try:
            seed_dropout(seed, k)
            _, m = step_fn(state, batch(seed, k, b, cfg, mix, device),
                           draws=draws(seed, k, b, cfg, device))
            loss = float(m["loss"])          # waits for the step
            if not math.isfinite(loss):
                raise FloatingPointError(f"step {k}: loss {loss}")
            out.units += 1
        except Exception:   # a step that fails counts, the loop goes on
            traceback.print_exc()
            out.failed += 1
        times.append(time.perf_counter() - t0)
        k += 1
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    out.window_s = time.perf_counter() - t_open
    core.log("step seconds: " + ", ".join(f"{x:.3f}" for x in times))
    out.memory_peak_bytes = ctx.memory_peak()

    if ctx.traced:
        def two_steps():
            nonlocal k
            for _ in range(2):
                seed_dropout(seed, k)
                step_fn(state, batch(seed, k, b, cfg, mix, device),
                        draws=draws(seed, k, b, cfg, device))
                k += 1
        dev = T.profile(two_steps, host=False)
        out.trace = T.profile(two_steps)
        out.trace.update(T.device_pass(dev), units=2)
        T.log_busy(out)
        out.flops_per_unit = step_flops(cfg, b)

    del model, state, step_fn
    gc.collect()
    ctx.empty_cache()
    limits = mix["limits"]
    with ctx.fp32():
        ref = build_reference(cfg, seed, device)
        if [(nm, tuple(p.shape)) for nm, p, _ in rules(ref)] != names:
            raise SystemExit("the reference's parameters are not the "
                             "program's")
        got = numbers(prog, reference_steps(ref, seed, cfg, mix, device, n))
    out.checks = {k2: (got.get(k2), lim) for k2, lim in limits.items()}
    return out


def half_batch(step_fn):
    """The fault of half the batch left out: each step's loss and
    gradients over the first half of its clips alone."""
    def step(state, batch, generator=None, draws=None):
        h = batch["video"].shape[0] // 2
        t = batch["video"].shape[1]
        sub = {k: v[:h] for k, v in batch.items()}
        d = {k: (v if k == "cond_frame" else
                 v[:h * t] if k == "posterior" else v[:h])
             for k, v in draws.items()}
        return step_fn(state, sub, generator, d)
    return step


FAULTS = {"half_batch": half_batch}


def calibrate(ctx, seeds, control_seeds, emit, fault=None) -> None:
    """The program's readings on ``seeds`` (with ``fault`` planted in its
    step, when named), then the control's (the reference with fp8
    products) on ``control_seeds``, each against the float32 reference
    at the same seed."""
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    n = mix["check_steps"]

    def reference(s):
        with ctx.fp32():
            ref = build_reference(cfg, s, device)
            got = reference_steps(ref, s, cfg, mix, device, n)
        del ref
        gc.collect()
        ctx.empty_cache()
        return got

    for s in seeds:
        model, state, step_fn = build_program(cfg, mix, s, device)
        if fault:
            step_fn = FAULTS[fault](step_fn)
        t0 = time.perf_counter()
        prog = first_steps(model, state, step_fn, s, cfg, mix, device, n)
        made = time.perf_counter() - t0
        del model, state, step_fn
        gc.collect()
        ctx.empty_cache()
        t0 = time.perf_counter()
        ref = reference(s)
        emit({"seed": s, "side": fault or "program", **numbers(prog, ref),
              "loss": prog["loss"], "ref_loss": ref["loss"],
              "steps_s": made, "check_s": time.perf_counter() - t0})
    for s in control_seeds:
        with ctx.fp32():
            ctl = build_reference(cfg, s, device, fp8=True)
            t0 = time.perf_counter()
            got = reference_steps(ctl, s, cfg, mix, device, n)
            made = time.perf_counter() - t0
        del ctl
        gc.collect()
        ctx.empty_cache()
        ref = reference(s)
        emit({"seed": s, "side": "control", **numbers(got, ref),
              "loss": got["loss"], "ref_loss": ref["loss"], "made_s": made})

