"""Image-to-video interpolation requests in a closed loop with one client.

Each request goes through ``models.diffusion.Pipeline.__call__`` as
``cli/inference.py`` drives it: ``batch`` clips, each with its own
generator, two keyframes at the model's resolution laid out as
``cli/serve.Image2Video.request_video`` lays them out (the first for the
first half of the frames), 77 token ids, ``perframe_ae`` from the
configuration. A request ends when its clips are on the host. The window
opens when the first request is issued; requests are issued while fewer
than ``seconds`` have passed and it closes when the last one completes.

The comparison that decides ``correct`` (``check``) runs once the window
has closed and the model is freed, on the requests drawn from the seed,
against the plain float32 reference (``benchmark/reference``) given the
same weights, inputs and noise. The reference follows the program step by
step from the program's own state, so each stage is compared by itself:

  encode_err  the posterior-sampled latents (VAE encoder, per frame)
  cond_err    the CFG contexts (CLIP text and vision towers, resampler)
  unet_err    the UNet's output at sampled DDIM steps, on the program's
              inputs of that step (every level, the CFG stem shared)
  ddim_err    every DDIM step (guidance, rescale, noise) replayed from the
              program's state and UNet output; x_T against the reference's
  decode_err  the clip: the dual-ref decode of the program's final latents
              twice with the middle-frame splice, the reference's own refs

Each is ||program - reference|| / ||reference||, the worst over the
checked requests (and steps).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import math
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import core, counts, trace as T
from benchmark.harness.weights import fill_, rules, seed64
from benchmark.reference import diffusion as RD
from benchmark.reference import model as RM

NULL_TOKENS = [49406, 49407]      # the tokenizer's empty prompt
WARMUP_STEPS = 2                  # DDIM steps of the set-up's request
CHECK_UNET_STEPS = 3              # UNet calls of a request compared


# ---------------------------------------------------------------------------
# inputs, all from (seed, request index, item)
# ---------------------------------------------------------------------------

def keyframes(gen, h: int, w: int, device) -> torch.Tensor:
    """Two (H, W, 3) frames in [-1, 1]: smooth colour fields (noise at a
    sixteenth of the size, upsampled) with fine noise on top."""
    coarse = torch.rand(2, 3, max(1, h // 16), max(1, w // 16),
                        generator=gen, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(h, w),
                                          mode="bilinear",
                                          align_corners=False)
    img = img + 0.1 * torch.rand(2, 3, h, w, generator=gen, device=device)
    return (img.clamp(0, 1) * 2 - 1).permute(0, 2, 3, 1).contiguous()


def tokens(gen, device) -> torch.Tensor:
    n = int(torch.randint(4, 40, (), generator=gen, device=device))
    ids = torch.randint(1, 49406, (n,), generator=gen, device=device)
    out = torch.zeros(77, dtype=torch.long, device=device)
    out[0], out[1:n + 1], out[n + 1] = 49406, ids, 49407
    return out


@dataclasses.dataclass
class Request:
    video: torch.Tensor          # (B, T, H, W, 3)
    tokens: torch.Tensor         # (B, 77)
    null_tokens: torch.Tensor
    fs: torch.Tensor             # (B,)
    noise_seeds: List[int]

    def generators(self, device) -> List[torch.Generator]:
        return [torch.Generator(device).manual_seed(s)
                for s in self.noise_seeds]


def request(seed: int, idx: int, b: int, cfg: dict, mix: dict,
            device) -> Request:
    t = cfg["video_length"]
    h, w = cfg["latent_h"] * 8, cfg["latent_w"] * 8
    vids, toks = [], []
    for k in range(b):
        g = torch.Generator(device).manual_seed(seed64(seed, idx, k, 1))
        a, z = keyframes(g, h, w, device)
        half = t // 2
        vids.append(torch.cat([a.expand(half, h, w, 3),
                               z.expand(t - half, h, w, 3)]))
        toks.append(tokens(g, device))
    null = torch.zeros(b, 77, dtype=torch.long, device=device)
    null[:, :2] = torch.tensor(NULL_TOKENS, device=device)
    return Request(torch.stack(vids), torch.stack(toks), null,
                   torch.full((b,), float(mix["fs"]), device=device),
                   [seed64(seed, idx, k, 2) for k in range(b)])


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

def model_config(cfg: dict, device):
    from tooncrafter_tpu_torch.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in fields}
    kw["compute_dtype"] = served_dtype(device)
    return ModelConfig(**kw)


def build_program(cfg: dict, seed: int, device):
    """The port's ToonCrafter at the configuration, its weights drawn from
    the seed on the device, in eval mode."""
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter

    mc = model_config(cfg, device)
    with torch.device("meta"):
        model = ToonCrafter(mc)
    model.to_compute_dtype()
    model = model.to_empty(device=device)
    fill_(model, seed, mc.compute_dtype)
    return model.eval()


def pipeline(model, mix: dict, ddim_steps: int):
    from tooncrafter_tpu_torch.models.diffusion import Pipeline
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig

    return Pipeline(model, ddim_steps=ddim_steps, eta=mix["eta"],
                    spacing=mix["spacing"],
                    guidance=GuidanceConfig(
                        cfg_scale=mix["cfg_scale"],
                        guidance_rescale=mix["guidance_rescale"]),
                    mode=mix["mode"], perframe_ae=model.config.perframe_ae)


class Capture:
    """Keeps, for the request being served, what the comparison reads: the
    UNet's inputs and output at each step, the latents from the encoder and
    the sampler's result. References only: the tensors are the program's
    own, made anew each call."""

    def __init__(self, model):
        self.rec = None
        self.model = model
        self._hook = model.unet.register_forward_hook(self._unet,
                                                      with_kwargs=True)
        enc, den = model.encode_first_stage, model.denoise

        def encode(*a, **k):
            out = enc(*a, **k)
            if self.rec is not None:
                self.rec["z"] = out[0]
            return out

        def denoise(*a, **k):
            out = den(*a, **k)
            if self.rec is not None:
                self.rec["samples"] = out
            return out

        model.encode_first_stage, model.denoise = encode, denoise

    def _unet(self, mod, args, kwargs, out):
        if self.rec is not None:
            self.rec["xin"].append(args[0])
            self.rec["ts"].append(args[1])
            self.rec["ctx"], self.rec["fs"] = args[2], args[3]
            self.rec["groups"] = kwargs.get("cfg_groups", 1)
            self.rec["v"].append(out)

    def start(self, idx: int):
        self.rec = {"idx": idx, "xin": [], "ts": [], "v": []}
        return self.rec

    def close(self):
        self._hook.remove()
        del self.model.encode_first_stage, self.model.denoise
        self.rec = None


def serve(pipe, req: Request, device):
    out = pipe(req.video, req.tokens, req.null_tokens, req.fs,
               generator=req.generators(device))
    return out.cpu()


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def rel(a, b) -> float:
    """||a - b|| / ||b||; infinite where the shapes differ."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double().to(a.device)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def served_dtype(device) -> torch.dtype:
    """The type the program serves its weights in: bf16 on a card."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def build_reference(cfg: dict, seed: int, device, fp8: bool = False):
    """The plain model in float32 with the program's weights (drawn again
    from the seed in the served type, bf16 on a card)."""
    with torch.device("meta"):
        ref = RM.ToonCrafterRef(cfg)
    ref = ref.to_empty(device=device)
    fill_(ref, seed, served_dtype(device))
    RM.set_ops(ref, RM.Ops(fp8=fp8))
    return ref.eval()


def draws(req: Request, cfg: dict, dd: RD.DDIM, device):
    """The noise each clip's generator gives, in the program's order: the
    posterior, x_T, then each step with sigma > 0 (descending)."""
    gens = req.generators(device)
    b, t = req.video.shape[:2]
    shape = (t, cfg["latent_h"], cfg["latent_w"], cfg["z_channels"])
    post = RD.per_item_normal(gens, shape, device)
    x_t = RD.per_item_normal(gens, shape, device)
    steps = {}
    for i in reversed(range(len(dd.timesteps))):
        if dd.sigmas[i] > 0:
            steps[i] = RD.per_item_normal(gens, shape, device)
    return post, x_t, steps


@torch.no_grad()
def compare(ref, rec: dict, req: Request, cfg: dict, mix: dict,
            unet_steps: List[int], device) -> Dict[str, float]:
    """The five numbers of one request, the program's record against the
    reference."""
    sched = RD.schedule(cfg)
    dd = RD.ddim(sched, mix["ddim_steps"], mix["eta"])
    b = rec["xin"][0].shape[0] // 2      # the clips the program served
    post, x_t, noise = draws(req, cfg, dd, device)
    z, refs = ref.encode(req.video, post)
    out = {"encode_err": rel(rec["z"], z)}
    ctx = ref.conditioning(req.tokens, req.null_tokens, req.video[:, 0])
    out["cond_err"] = rel(rec["ctx"].reshape((2, b) + ctx.shape[2:]), ctx)
    del ctx, z
    n = len(rec["v"])
    worst = 0.0
    for j in unet_steps:
        v = ref.unet(rec["xin"][j].float(), rec["ts"][j].float(),
                     rec["ctx"].float(), rec["fs"].float(),
                     cfg_groups=rec["groups"])
        worst = max(worst, rel(rec["v"][j], v))
    out["unet_err"] = worst
    xs = [x[:b, ..., :cfg["z_channels"]] for x in rec["xin"]] \
        + [rec["samples"]]
    errs = [rel(xs[0], x_t)]
    for j in range(n):
        i = n - 1 - j
        v = RD.guide(rec["v"][j].reshape((2, b) + xs[j].shape[1:]).float(),
                     mix["cfg_scale"], mix["guidance_rescale"])
        nxt = RD.step(sched, dd, i, xs[j].float(), v,
                      noise.get(i, torch.zeros_like(v)))
        errs.append(rel(xs[j + 1], nxt))
    out["ddim_err"] = max(errs)
    core.log("ddim_err by step (x_T first): "
             + " ".join(f"{e:.2e}" for e in errs))
    if rec["samples"].shape[0] != req.video.shape[0]:
        out["decode_err"] = math.inf   # clips missing from the batch
        return out
    clip = ref.decode_spliced(rec["samples"].float(), refs)
    out["decode_err"] = rel(rec["clip"], clip.cpu())
    return out


def control_record(ctl, req: Request, cfg: dict, mix: dict,
                   device) -> dict:
    """The record the control leaves in the program's place: the reference
    with fp8 products (``ctl``), its sampler state rounded to bfloat16 at
    each step (the precision under the program's float32 state)."""
    sched = RD.schedule(cfg)
    dd = RD.ddim(sched, mix["ddim_steps"], mix["eta"])
    b = req.video.shape[0]
    post, x, noise = draws(req, cfg, dd, device)
    bf = lambda a: a.to(torch.bfloat16).float()
    with torch.no_grad():
        z, refs = ctl.encode(req.video, post)
        ctx = ctl.conditioning(req.tokens, req.null_tokens, req.video[:, 0])
        rec = {"z": z, "ctx": ctx.reshape((2 * b,) + ctx.shape[2:]),
               "xin": [], "ts": [], "v": [], "groups": 2,
               "fs": req.fs.repeat(2)}
        concat = RM.interp_concat(z).repeat(2, 1, 1, 1, 1)
        for i in reversed(range(mix["ddim_steps"])):
            xin = torch.cat([x.repeat(2, 1, 1, 1, 1), concat], dim=-1)
            ts = torch.full((2 * b,), float(dd.timesteps[i]), device=device)
            v_all = ctl.unet(xin, ts, rec["ctx"], rec["fs"], cfg_groups=2)
            rec["xin"].append(xin)
            rec["ts"].append(ts)
            rec["v"].append(v_all)
            v = bf(RD.guide(bf(v_all.reshape((2, b) + x.shape[1:])),
                            mix["cfg_scale"], mix["guidance_rescale"]))
            x = bf(RD.step(sched, dd, i, bf(x), v,
                           noise.get(i, torch.zeros_like(v))))
        rec["samples"] = x
        rec["clip"] = ctl.decode_spliced(x, refs).cpu()
    return rec


class Sample:
    """One of the completed requests, uniformly, drawn from the seed as
    they complete: the n-th replaces the one kept with probability 1/n and
    the other's capture is dropped at once, so the capture holds at most
    two requests whatever the window's length."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed64(seed, 0xC4EC))
        self.kept, self.seen = None, 0

    def offer(self, rec: dict) -> None:
        self.seen += 1
        if self.seen == 1 or int(self.rng.integers(self.seen)) == 0:
            if self.kept is not None:
                self.kept.clear()
            self.kept = rec
        else:
            rec.clear()


def unet_steps(seed: int, ddim_steps: int) -> List[int]:
    """The UNet calls the comparison reads, drawn from the seed: the first
    and ``CHECK_UNET_STEPS`` - 1 others."""
    rng = np.random.default_rng(seed64(seed, 0x57E9))
    others = rng.choice(np.arange(1, ddim_steps), CHECK_UNET_STEPS - 1,
                        replace=False)
    return [0] + sorted(others.tolist())


# ---------------------------------------------------------------------------
# the per-block counters of the traced run
# ---------------------------------------------------------------------------

def block_classes():
    from tooncrafter_tpu_torch.models import unet as U

    def resblock(m, args):
        x, emb, t = args[0], args[1], args[2]
        cin, cout = x.shape[-1], m.in_layers[2].out_channels
        return counts.resblock(x.shape[0], x.shape[1], x.shape[2], cin,
                               cout, int(t), emb.shape[-1])

    def spatial(m, args):
        x, ctx = args[0], args[1]
        return counts.spatial_transformer(
            x.shape[0], x.shape[1] * x.shape[2], x.shape[-1], ctx.shape[1],
            ctx.shape[2])

    return {"resblock": (U.ResBlock, resblock),
            "transformer": (U.SpatialTransformer, spatial)}


def request_flops(cfg: dict, mix: dict, b: int) -> float:
    """Model FLOPs of one request: the encoder over every frame, the CLIP
    towers and resampler for both branches, ``ddim_steps`` CFG-batched
    UNet calls with the stem once per clip, both decodes."""
    t, h, w = cfg["video_length"], cfg["latent_h"], cfg["latent_w"]

    def run():
        ref = RM.ToonCrafterRef(cfg)
        video = torch.zeros(b, t, h * 8, w * 8, 3)
        z, refs = ref.encode(video, torch.zeros(b, t, h, w,
                                                cfg["z_channels"]))
        tok = torch.zeros(b, 77, dtype=torch.long)
        ctx = ref.conditioning(tok, tok, video[:, 0])
        xin = torch.zeros(2 * b, t, h, w, cfg["unet_in_channels"])
        ref.unet(xin, torch.zeros(2 * b), ctx.reshape((2 * b,)
                                                      + ctx.shape[2:]),
                 torch.zeros(2 * b), cfg_groups=2)
        ref.decode_spliced(z, refs)

    def unet_only():
        ref = RM.ToonCrafterRef(cfg)
        xin = torch.zeros(2 * b, t, h, w, cfg["unet_in_channels"])
        ctx = torch.zeros(2 * b, 77 + t * cfg["resampler_queries"],
                          cfg["context_dim"])
        ref.unet(xin, torch.zeros(2 * b), ctx, torch.zeros(2 * b),
                 cfg_groups=2)

    whole, unet = counts.model_flops(run), counts.model_flops(unet_only)
    return whole + (mix["ddim_steps"] - 1) * unet


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(ctx) -> core.Run:
    cfg, mix, seed, device = ctx.config, ctx.mix, ctx.seed, ctx.device
    b = mix["batch"]
    out = core.Run(steps_per_unit=mix["ddim_steps"])
    t_imports = time.monotonic() - ctx.t_start
    model = build_program(cfg, seed, device)
    names = [(n, tuple(p.shape)) for n, p, _ in rules(model)]
    pipe = pipeline(model, mix, mix["ddim_steps"])
    cap = Capture(model)
    ctx.sync()
    t_model = time.monotonic() - ctx.t_start
    # warm-up: one short request at the cell's batch and resolution (the
    # kernels' build on a cold checkout is in it)
    serve(pipeline(model, mix, WARMUP_STEPS),
          request(seed, -1, b, cfg, mix, device), device)
    ctx.sync()
    out.setup_s = time.monotonic() - ctx.t_start
    core.log(f"setup {out.setup_s:.3f} s: to the loop {t_imports:.3f}, "
             f"model made {t_model - t_imports:.3f}, warm-up "
             f"{out.setup_s - t_model:.3f}")
    ctx.reset_peak()

    sample = Sample(seed)
    timings = []
    t_open = time.perf_counter()
    idx = 0
    while True:
        rec = cap.start(idx)
        out.attempted += b
        try:
            rec["clip"] = serve(pipe, request(seed, idx, b, cfg, mix,
                                              device), device)
            timings.append(dict(pipe.timings))
            out.units += b
            sample.offer(rec)
        except Exception:   # a request that fails counts, the loop goes on
            traceback.print_exc()
            out.failed += b
            rec.clear()
        idx += 1
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    out.window_s = time.perf_counter() - t_open
    cap.rec = None
    out.requests = idx
    for tm in timings:
        for k, v in tm.items():
            out.phases[k] = out.phases.get(k, 0.0) + v
    core.log("request seconds: " + ", ".join(
        f"{sum(tm.values()):.3f}" for tm in timings))
    out.memory_peak_bytes = ctx.memory_peak()

    if ctx.traced:
        # one more request traced on the device alone (busy, window, ops),
        # then one with the host's ops and the blocks' ranges
        req = request(seed, idx, b, cfg, mix, device)
        dev = T.profile(lambda: serve(pipe, req, device), host=False)
        blocks = T.BlockRanges(model.unet, block_classes(), counts.least_s)
        req = request(seed, idx + 1, b, cfg, mix, device)
        out.trace = T.profile(lambda: serve(pipe, req, device))
        blocks.remove()
        out.trace.update(T.device_pass(dev), units=b)
        out.trace["block_least_s"] = dict(blocks.least)
        T.log_busy(out)
        core.log(f"trace: kernels linked to blocks "
                 f"{out.trace['linked_kernels']} of "
                 f"{out.trace['device_events']}")
        out.flops_per_unit = request_flops(cfg, mix, b) / b

    cap.close()
    del pipe, model, cap
    gc.collect()
    ctx.empty_cache()
    steps = unet_steps(seed, mix["ddim_steps"])
    out.checks = check(ctx, sample.kept, steps, names)
    return out


def calibrate(ctx, seeds, control_seeds, emit, fault=None) -> None:
    """Each seed draws its own weights, inputs and noise, as a run does."""
    if fault:
        raise SystemExit(f"no fault {fault!r} for this traffic")
    i2v = sys.modules[__name__]
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    b = mix["batch"]
    records = []
    for s in seeds:
        model = i2v.build_program(cfg, s, device)
        pipe = i2v.pipeline(model, mix, mix["ddim_steps"])
        cap = i2v.Capture(model)
        rec = cap.start(0)
        t0 = time.perf_counter()
        rec["clip"] = i2v.serve(pipe, i2v.request(s, 0, b, cfg, mix, device),
                                device)
        core.log(f"seed {s}: request {time.perf_counter() - t0:.3f} s")
        records.append((s, rec))
        cap.close()
        del pipe, model, cap
        gc.collect()
        ctx.empty_cache()
    with ctx.fp32():
        ref = i2v.build_reference(cfg, 0, device)
        for s, rec in records:
            i2v.fill_(ref, s, i2v.served_dtype(device))
            steps = i2v.unet_steps(s, mix["ddim_steps"])
            t0 = time.perf_counter()
            got = i2v.compare(ref, rec, i2v.request(s, 0, b, cfg, mix, device),
                              cfg, mix, steps, device)
            emit({"seed": s, "side": "program", **got,
                  "check_s": time.perf_counter() - t0})
            rec.clear()
        for s in control_seeds:
            i2v.fill_(ref, s, i2v.served_dtype(device))
            steps = i2v.unet_steps(s, mix["ddim_steps"])
            req = i2v.request(s, 0, b, cfg, mix, device)
            i2v.RM.set_ops(ref, i2v.RM.Ops(fp8=True))
            t0 = time.perf_counter()
            rec = i2v.control_record(ref, req, cfg, mix, device)
            made = time.perf_counter() - t0
            i2v.RM.set_ops(ref, i2v.RM.Ops())
            got = i2v.compare(ref, rec, req, cfg, mix, steps, device)
            emit({"seed": s, "side": "control", **got, "made_s": made})


def check(ctx, rec, steps: List[int], names) -> Dict:
    """The request kept (``rec``; None where none completed) against the
    reference."""
    cfg, mix, seed, device = ctx.config, ctx.mix, ctx.seed, ctx.device
    limits = mix["limits"]
    if rec is None:
        return {k: (None, lim) for k, lim in limits.items()}
    with ctx.fp32():
        ref = build_reference(cfg, seed, device)
        if [(n, tuple(p.shape)) for n, p, _ in rules(ref)] != names:
            raise SystemExit("the reference's parameters are not the "
                             "program's")
        req = request(seed, rec["idx"], mix["batch"], cfg, mix, device)
        got = compare(ref, rec, req, cfg, mix, steps, device)
    return {k: (got.get(k), lim) for k, lim in limits.items()}
