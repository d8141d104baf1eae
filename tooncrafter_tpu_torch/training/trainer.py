"""Training step: v-prediction diffusion loss with 3-way CFG dropout
(tooncrafter_tpu/training/trainer.py).

  * ``diffusion_loss``: VAE-encode the clip and sample the posterior; CLIP
    text and image context with the 3-way classifier-free dropout (5%
    text-only, 5% image-only, 5% both at uncond_prob 0.05); the cond-frame
    latent (a random frame with ``rand_cond_frame``) repeated T times as the
    hybrid concat; t ~ U[0, 1000), dynamic rescale of x0, offset noise,
    q_sample, the v target; MSE over (T, H, W, C) with the per-timestep
    logvar weighting and the VLB term.
  * AdamW (or the JAX package's 'adamw_lowmem' and 'adafactor' profiles)
    over the UNet and the image projector (``TRAINABLE``); the VAE and the
    CLIP towers stay frozen and run under no_grad.
  * An EMA shadow with warmup decay min(decay, (1 + n) / (10 + n)).

The draws of a step (the posterior noise, ``rand``, ``cond_frame``, ``ts``,
``noise``, ``offset``) come from a ``torch.Generator`` in that order, or
are passed in ``draws``; dropout draws from torch's global RNG. Torch's
streams are not JAX's: the same seed gives other numbers.

Data parallel (a process group, or a ``DeviceMesh`` whose ``data`` axis is
taken; ``parallel/mesh.py``): each rank holds the same weights and its
rows of the global batch (equal row counts). Every rank draws the global
batch's draws from the same seeded generator (or is given them) and keeps
its rows, so N ranks compute what one process computes on the global
batch, up to the order of sums. The gradients are all-reduced to their
mean in fp32 (``grad_accum`` > 1: on the k-th call, the local running
means), the clip norm taken from the reduced gradients. The optimizer is
torch's ``ZeroRedundancyOptimizer`` over the profile's class: each
trainable is owned whole by one rank (greedy by size, largest first),
whose local optimizer alone holds its state and steps it, then broadcasts
it. The EMA, the schedule and the step count move on every rank; the
metrics are the ranks' mean. Without a group nothing of this runs.

Tensor parallel (a ``DeviceMesh`` with a ``model`` axis of more than one
rank; ``parallel/tensor.py``): every rank takes global rank 0's weights,
then keeps its share of the UNet's transformer blocks (``shard_``). The
ranks of one model group take the same batch rows and draws (the data
axis's), and seed their dropout alike, so the activations they share stay
equal. After the backward the parameters whose gradient on a model rank is
that rank's part (the sharded blocks' norms, ``alpha``, the relative
position tables) are summed over the model group, then every gradient is
averaged over the data group as above; the clip's global norm counts each
sharded tensor's pieces once. The optimizer, over the data group, steps a
rank's shards; AdamW and its low-memory profile are elementwise, so that is
the whole tensor's update. The factored Adafactor is not: its row and
column moments would need the model group's sums, and under a model axis
it is refused. The EMA runs on the shards.

Precision: fp32 master weights; on the card the loss runs under CUDA
autocast in the model's ``compute_dtype`` (bf16), with fp32 norm
statistics, as the JAX CLI computes in bf16 on an accelerator. The
optimizer, the EMA and the gradient clip run in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tooncrafter_tpu_torch.parallel import mesh as M
from tooncrafter_tpu_torch.parallel import tensor as TP
from tooncrafter_tpu_torch.training import lr_schedule as LR
from tooncrafter_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    uncond_prob: float = 0.05
    ema_decay: float = 0.9999
    grad_clip: float = 0.0
    rand_cond_frame: bool = True
    grad_accum: int = 1
    # the JAX package's memory profiles: 'adamw' (fp32 moments, the
    # reference's configure_optimizers), 'adamw_lowmem' (a bf16 first
    # moment), 'adafactor' (a factored second moment; training/optim.py)
    optimizer: str = "adamw"
    # reference scheduler YAML block; None -> constant learning_rate
    scheduler: Optional[dict] = None

    def lr_schedule(self) -> LR.Schedule:
        if self.scheduler is None:
            return LR.constant_schedule(self.learning_rate)
        return LR.from_config(self.learning_rate, self.scheduler)


TRAINABLE = ("unet", "image_proj")
# the upstream state-dict prefix of each trainable tower
PREFIXES = {"unet": "model.diffusion_model.",
            "image_proj": "image_proj_model."}


def split_trainable(model: nn.Module) -> Tuple[Dict[str, nn.Parameter],
                                               Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by upstream name; the frozen ones
    stop requiring grad."""
    prefixes = tuple(PREFIXES[k] for k in TRAINABLE)
    train, frozen = {}, {}
    for name, p in model.named_parameters():
        if name.startswith(prefixes):
            train[name] = p
        else:
            p.requires_grad_(False)
            frozen[name] = p
    return train, frozen


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor],
                   group=None):
    """(optimizer, LambdaLR), the learning rate from ``cfg.lr_schedule()``
    at each update. 'adamw' is optax.adamw's rule: b1 0.9, b2 0.999, eps
    1e-8, weight decay decoupled and applied to every trainable;
    'adamw_lowmem' the same with a bf16 first moment; 'adafactor'
    optax.adafactor's (training/optim.py). With a process group the
    profile runs inside a ``ZeroRedundancyOptimizer`` over it (each tensor's
    state on its owning rank alone)."""
    if cfg.optimizer == "adamw":
        cls, kw = torch.optim.AdamW, dict(betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adamw_lowmem":
        cls, kw = optim.AdamWLowMem, dict(weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adafactor":
        cls, kw = optim.Adafactor, dict(weight_decay=cfg.weight_decay or None)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if group is None:
        opt = cls(params, lr=1.0, **kw)
    else:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        opt = ZeroRedundancyOptimizer(params, optimizer_class=cls,
                                      process_group=group, lr=1.0, **kw)
    return opt, LR.lambda_lr(opt, cfg.lr_schedule())


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(tensors)]))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               step: int, decay: float = 0.9999) -> None:
    """In place: e = e * d + p * (1 - d), d = min(decay, (1+n)/(10+n))."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    shadow = list(ema.values())
    torch._foreach_mul_(shadow, d)
    torch._foreach_add_(shadow, [params[k].detach() for k in ema],
                        alpha=1.0 - d)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def sample_draws(model, video: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 rand_cond_frame: bool = True,
                 batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A step's random draws, in the loss's order, on the video's device,
    for ``batch`` clips (default: the video's)."""
    c = model.config
    b, t, hh, ww = video.shape[:4]
    b = b if batch is None else batch
    f = 2 ** (len(c.vae_ch_mult) - 1)
    dev = video.device
    z_shape = (b, t, hh // f, ww // f, c.z_channels)
    kw = dict(generator=generator, device=dev)
    draws = {
        "posterior": torch.randn((b * t,) + z_shape[2:], **kw),
        "rand": torch.rand(b, **kw),
        "cond_frame": (torch.randint(0, t, (), **kw) if rand_cond_frame
                       else torch.zeros((), dtype=torch.long, device=dev)),
        "ts": torch.randint(0, model.schedule.num_timesteps, (b,), **kw),
        "noise": torch.randn(z_shape, **kw),
    }
    if c.noise_strength > 0:
        draws["offset"] = torch.randn((b, t, 1, 1, c.z_channels), **kw)
    return draws


def rank_draws(model, cfg: TrainConfig, batch, generator, draws, group):
    """This rank's draws: with a group, its rows of the global batch's
    (``draws``, else drawn from ``generator`` for every rank's rows; the
    posterior's rows are per frame, ``cond_frame`` is one for the whole
    batch); without one, ``draws`` as given."""
    if group is None:
        return draws
    rank, world = M.rank_world(group)
    video = batch["video"]
    b, t = video.shape[:2]
    if draws is None:
        draws = sample_draws(model, video, generator, cfg.rand_cond_frame,
                             batch=b * world)
    lo, hi = rank * b, (rank + 1) * b
    return {k: (v if k == "cond_frame" else
                v[lo * t:hi * t] if k == "posterior" else v[lo:hi])
            for k, v in draws.items()}


def mean_metrics(metrics: Dict[str, torch.Tensor],
                 group) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the group's ranks (one all-reduce)."""
    if group is None:
        return metrics
    keys = list(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    M.all_reduce_mean_([v], group)
    return {k: v[i] for i, k in enumerate(keys)}


def autocast(model, device: torch.device):
    """CUDA autocast in the model's compute dtype on the card; nothing on
    the CPU or in fp32."""
    dt = model.config.compute_dtype
    if device.type != "cuda" or dt == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast("cuda", dtype=dt)


def diffusion_loss(model, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   uncond_prob: float = 0.05, rand_cond_frame: bool = True,
                   train: bool = True,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   logvar: Optional[torch.Tensor] = None):
    """batch: {'video': (B,T,H,W,3) in [-1,1], 'tokens': (B,77),
    'null_tokens': (B,77), 'fs': (B,) frame strides, 'fps': (B,) real fps},
    on the model's device. The fps embedding reads 'fs' or 'fps' as the
    model's ``fps_condition_type`` says. ``train`` turns the UNet's dropout
    on. Returns (loss, metrics)."""
    mcfg = model.config
    fct = mcfg.fps_condition_type
    if fct not in ("fs", "fps"):
        raise ValueError(f"unknown fps_condition_type '{fct}'")
    sched = model.schedule
    video = batch["video"]
    if draws is None:
        draws = sample_draws(model, video, generator, rand_cond_frame)
    draws = {k: v.to(video.device) for k, v in draws.items()}
    model.eval()
    model.unet.train(train)

    with torch.no_grad():
        # first stage and CLIP towers (frozen)
        z, _ = model.encode_first_stage(
            video, noise=draws["posterior"],
            chunk_size=1 if mcfg.perframe_ae else None)
        u = uncond_prob
        rand = draws["rand"]
        drop_text = (rand < 2 * u)[:, None, None]
        drop_image = ((rand >= u) & (rand < 3 * u))[:, None, None, None]
        text = model.encode_text(batch["tokens"])
        null = model.encode_text(batch["null_tokens"])
        text_emb = torch.where(drop_text, null, text)
        cond_frame = int(draws["cond_frame"]) if rand_cond_frame else 0
        img = video[:, cond_frame]
        img = torch.where(drop_image, torch.zeros_like(img), img)
        img_tokens = model.image_tokens(img)
    img_ctx = model.image_proj_model(img_tokens)  # grads -> image_proj
    context = torch.cat([text_emb.to(img_ctx.dtype), img_ctx], dim=1)
    # hybrid concat: the cond-frame latent repeated T times
    concat = z[:, cond_frame:cond_frame + 1].expand_as(z)

    ts = draws["ts"].long()
    x0 = sched.dynamic_rescale(z, ts)
    noise = draws["noise"]
    if mcfg.noise_strength > 0:
        # offset noise: per-(batch, frame, channel), broadcast over H, W
        noise = noise + mcfg.noise_strength * draws["offset"]
    x_noisy = sched.q_sample(x0, ts, noise)
    target = sched.get_v(x0, noise, ts)
    fs_signal = batch["fs"] if fct == "fs" else batch["fps"]
    pred = model.unet(torch.cat([x_noisy, concat], dim=-1), ts.float(),
                      context, fs_signal.float())

    loss_simple = torch.mean(torch.square(pred.float() - target),
                             dim=(1, 2, 3, 4))
    if logvar is None:
        logvar = torch.full((sched.num_timesteps,), mcfg.logvar_init,
                            device=video.device)
    logvar_t = logvar[ts]
    loss_gamma = loss_simple / torch.exp(logvar_t) + logvar_t
    loss = mcfg.l_simple_weight * loss_gamma.mean()
    lvlb = sched.gather(sched.lvlb_weights, ts, 1)
    loss_vlb = (lvlb * loss_simple).mean()
    loss = loss + mcfg.original_elbo_weight * loss_vlb
    metrics = {"loss": loss.detach(),
               "loss_simple": loss_simple.mean().detach(),
               "loss_vlb": loss_vlb.detach(), "t_mean": ts.float().mean()}
    if mcfg.learn_logvar:
        metrics["loss_gamma"] = loss_gamma.mean().detach()
        metrics["logvar"] = logvar.mean().detach()
    return loss, metrics


# ---------------------------------------------------------------------------
# state, steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    train_params: Dict[str, torch.Tensor]
    frozen_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: Optional[Dict[str, torch.Tensor]]
    # grad_accum > 1: the running mean of the micro-batches' gradients and
    # how many it holds (optax.MultiSteps)
    accum: Optional[List[torch.Tensor]] = None
    micro: int = 0
    # data parallel: the process group (the optimizer is then a
    # ZeroRedundancyOptimizer over it)
    group: Optional[object] = None
    # tensor parallel: the model group the UNet's blocks are sharded over
    model_group: Optional[object] = None


def make_train_state(model, cfg: TrainConfig, use_ema: bool = False,
                     group=None):
    """-> (state, optimizer). Under ``learn_logvar`` a per-timestep logvar
    joins the trainables as 'logvar' (the reference promotes its buffer to
    a parameter). With ``group`` (a process group or a ``DeviceMesh``)
    every rank takes rank 0's weights and buffers, and its optimizer holds
    the state of the trainables it owns alone; a mesh with a model axis of
    more than one rank then shards the UNet's transformer blocks over it."""
    mgroup = M.model_group(group)
    mesh, group = group, M.data_group(group)
    if mgroup is not None:
        if cfg.optimizer == "adafactor":
            raise NotImplementedError(
                "the 'adafactor' profile factors each whole tensor's second "
                "moment; under a model axis use 'adamw' or 'adamw_lowmem'")
        M.replicate_(model, 0, dist.group.WORLD)
        TP.shard_(model, mesh)
    elif group is not None:
        M.replicate_(model, 0, group)
    train, frozen = split_trainable(model)
    if model.config.learn_logvar and "logvar" not in train:
        dev = next(iter(train.values())).device
        train["logvar"] = nn.Parameter(torch.full(
            (model.schedule.num_timesteps,), model.config.logvar_init,
            device=dev))
    opt, sched = make_optimizer(cfg, list(train.values()), group)
    ema = ({k: p.detach().clone() for k, p in train.items()} if use_ema
           else None)
    state = TrainState(step=0, model=model, train_params=train,
                       frozen_params=frozen, optimizer=opt, scheduler=sched,
                       ema_params=ema, group=group, model_group=mgroup)
    return state, opt


def eval_param_tree(state: TrainState, use_ema: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """The full parameter set for evaluation: the EMA shadow (when there
    is one and ``use_ema``) with the frozen towers."""
    train = (state.ema_params if use_ema and state.ema_params is not None
             else state.train_params)
    return {**train, **state.frozen_params}


@contextlib.contextmanager
def ema_scope(state: TrainState):
    """The reference's ema_scope: the model holds the EMA shadow's values
    inside the block (storage swapped, nothing copied)."""
    if state.ema_params is None:
        yield state.model
        return
    pairs = [(state.train_params[k], e) for k, e in state.ema_params.items()]

    def swap():
        for p, e in pairs:
            p.data, e.data = e.data, p.data
    swap()
    try:
        yield state.model
    finally:
        swap()


def _loss(model, cfg: TrainConfig, state: TrainState, batch, generator,
          draws, train: bool):
    dev = batch["video"].device
    with autocast(model, dev):
        return diffusion_loss(model, batch, generator, cfg.uncond_prob,
                              cfg.rand_cond_frame, train=train, draws=draws,
                              logvar=state.train_params.get("logvar"))


def make_val_step(model, cfg: TrainConfig):
    """(state, batch, generator=None, draws=None) -> metrics: the loss
    with the raw weights and, with an EMA shadow, with it, on the same
    draws (the reference's validation_step). Under the state's group each
    rank takes its rows' loss and the metrics are the ranks' mean."""

    @torch.no_grad()
    def val_fn(state: TrainState, batch, generator=None, draws=None):
        g = state.group
        if g is not None:
            draws = rank_draws(model, cfg, batch, generator, draws, g)
        elif draws is None:
            draws = sample_draws(model, batch["video"], generator,
                                 cfg.rand_cond_frame)
        loss, _ = _loss(model, cfg, state, batch, None, draws, train=False)
        metrics = {"val/loss": loss.detach()}
        if state.ema_params is not None:
            with ema_scope(state):
                loss_ema, _ = _loss(model, cfg, state, batch, None, draws,
                                    train=False)
            metrics["val/loss_ema"] = loss_ema.detach()
        return mean_metrics(metrics, g)

    return val_fn


def _apply_update(state: TrainState, cfg: TrainConfig,
                  grads: List[torch.Tensor]) -> torch.Tensor:
    """Reduce (under a group; under a model group first the replicated
    parameters' partial gradients summed over it), clip, step the optimizer
    (under a group each owner steps its tensors and broadcasts them) and
    the schedule. Returns the global norm of the (reduced) gradients before
    the clip."""
    sharded = reduce_grads_(state, grads)
    norm = (global_norm(grads) if sharded is None else
            TP.global_norm(grads, sharded, state.model_group))
    if cfg.grad_clip > 0:
        # optax.clip_by_global_norm: g * max / |g| where |g| >= max
        scale = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                            cfg.grad_clip / norm)
        torch._foreach_mul_(grads, scale.to(grads[0].device))
    params = list(state.train_params.values())
    for p, g in zip(params, grads):
        p.grad = g
    state.optimizer.step()
    state.scheduler.step()
    for p in params:
        p.grad = None
    return norm


def reduce_grads_(state: TrainState,
                  grads: List[torch.Tensor]) -> Optional[List[bool]]:
    """In place, the gradients (``train_params`` order) of every rank as
    one process's: under a model group the replicated parameters' partial
    gradients summed over it; under a data group the mean over it. Returns,
    under a model group, which of them are sharded (else None)."""
    sharded = None
    if state.model_group is not None:
        names, partial = TP.grad_roles(state.model)
        TP.sum_over_model_([g for n, g in zip(state.train_params, grads)
                            if n in partial], state.model_group)
        sharded = [n in names for n in state.train_params]
    if state.group is not None:
        M.all_reduce_mean_(grads, state.group)
    return sharded


def loss_and_grads(model, cfg: TrainConfig, state: TrainState, batch,
                   generator=None, draws=None):
    """The training loss on this rank's rows: (metrics, the local
    gradients in ``train_params`` order, zeros where none flowed)."""
    params = list(state.train_params.values())
    for p in params:
        p.grad = None
    draws = rank_draws(model, cfg, batch, generator, draws, state.group)
    loss, metrics = _loss(model, cfg, state, batch, generator, draws,
                          train=True)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    for p in params:
        p.grad = None
    return metrics, grads


def make_train_step(model, opt, cfg: TrainConfig):
    """(state, batch, generator=None, draws=None) -> (state, metrics).
    The state is updated in place (``update``). With ``grad_accum`` k > 1
    the gradients of k calls are averaged and the optimizer (and the
    schedule) steps once, on the k-th; the EMA and the step count move on
    every call, as in the JAX step. Under the state's group the batch is
    this rank's rows, ``draws`` (when given) the
    global batch's, and the metrics the ranks' mean; ``grad_norm`` is the
    reduced gradients' (the micro-batch's own with ``grad_accum`` > 1)."""

    def step_fn(state: TrainState, batch, generator=None, draws=None):
        metrics, grads = loss_and_grads(model, cfg, state, batch, generator,
                                        draws)
        local = global_norm(grads) if cfg.grad_accum > 1 else None
        norm = update(state, cfg, grads)
        metrics["grad_norm"] = norm if local is None else local
        return state, mean_metrics(metrics, state.group)

    return step_fn


def update(state: TrainState, cfg: TrainConfig,
           grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """One call's gradients (in ``train_params`` order, consumed) into the
    state: with ``grad_accum`` k > 1 a running mean, acc += (g - acc) /
    (n + 1), and the update on the k-th call (optax.MultiSteps); else the
    update at once. Under the state's group the gradients, or the running
    means, are all-reduced first. Then the EMA,
    and the step count. Returns the applied gradients' global norm, or
    None on a call that does not update."""
    k = cfg.grad_accum
    norm = None
    if k > 1:
        if state.accum is None:
            state.accum = [torch.zeros_like(g) for g in grads]
        n = state.micro
        torch._foreach_sub_(grads, state.accum)
        torch._foreach_add_(state.accum, grads, alpha=1.0 / (n + 1))
        state.micro = n + 1
        if state.micro == k:
            norm = _apply_update(state, cfg, state.accum)
            torch._foreach_zero_(state.accum)
            state.micro = 0
    else:
        norm = _apply_update(state, cfg, grads)
    if state.ema_params is not None:
        ema_update(state.ema_params, state.train_params, state.step,
                   cfg.ema_decay)
    state.step += 1
    return norm
