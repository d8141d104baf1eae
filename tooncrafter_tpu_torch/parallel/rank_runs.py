"""The programs that the multi-rank tests and ``chip_smoke.py``'s phase 5
spawn on each rank (``parallel/spawn.run_ranks``): data-parallel training
steps and rank-sharded serving, each returning what its caller holds
against one process. They live in the port (spawned children import them
afresh) and import nothing of JAX.

Each takes a ``spec`` dict of plain values and CPU tensors; weights come
as a state dict (``state_dict``), or from ``utils.weights.init_random_``
with a generator seeded ``init_device_seed`` on the rank's device (the
model built there): the same on every rank and in a caller that draws
them so. ``pass_dropout_`` makes a model's dropout pass its input through,
for the checks that hold runs with different dropout streams together.
``n_model`` (default 1) in a spec makes the mesh (world / n_model,
n_model): the UNet's transformer blocks are then sharded over the model
axis (``parallel/tensor.py``), and what a rank returns of the weights,
gradients and optimizer state is gathered whole.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List

import torch
from torch import nn


def param_digest(tensors: List[torch.Tensor]) -> str:
    """sha256 of the tensors' bytes in their logical order, in list order
    (copied to the host in flat buckets): equal digests are equal tensors
    bit for bit."""
    from tooncrafter_tpu_torch.parallel import mesh as M

    h = hashlib.sha256()
    for bucket in M.buckets([t.detach() for t in tensors]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        h.update(memoryview(flat.view(torch.uint8).cpu().numpy()))
    return h.hexdigest()


class _Clock:
    """Seconds spent between calls, summed by label (the device
    synchronised at each call)."""

    def __init__(self, device):
        self.device = device
        self.spent: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.spent[label] = self.spent.get(label, 0.0) + now - self.t
        self.t = now


def pass_dropout_(model: nn.Module) -> None:
    """Replace every active ``nn.Dropout`` with one that passes its input
    through but keeps its p, so the UNet still takes its training branch:
    runs that cannot share masks (the card and the CPU, ranks seeded apart)
    then see the same (no) masks."""
    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if type(child) is nn.Dropout and child.p > 0:
                setattr(mod, name, _PassDropout(child.p))


class _PassDropout(nn.Dropout):
    def forward(self, x):
        return x


def _model(spec, device):
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.weights import init_random_

    if "init_device_seed" in spec:
        with torch.device(device):
            model = ToonCrafter(spec["config"])
        init_random_(model, torch.Generator(device).manual_seed(
            spec["init_device_seed"]))
    else:
        model = ToonCrafter(spec["config"])
        model.load_state_dict(spec["state_dict"], strict=True)
        model.to(device)
    if device.type == "cuda":
        model.config = dataclasses.replace(model.config,
                                           compute_dtype=torch.bfloat16)
    return model


def _cpu(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in d.items()}


def owned_state(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """This rank's optimizer state by trainable name, on the CPU (under a
    group, that of the ``ZeroRedundancyOptimizer``'s local optimizer);
    under a model group of a data group of one, every tensor whole."""
    local = getattr(state.optimizer, "optim", state.optimizer)
    # in trainables order: the local optimizer's follows the owner split's
    # sort by size, which differs between model ranks of unequal shards
    out = {n: {k: (v.detach().cpu().clone() if torch.is_tensor(v) else v)
               for k, v in local.state[p].items()}
           for n, p in state.train_params.items() if p in local.state}
    if state.model_group is None:
        return out
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.parallel import tensor as TP
    if M.rank_world(state.group)[1] != 1:
        raise ValueError("owned_state gathers over the model group only "
                         "where one data rank owns every tensor")
    lays = TP.layouts(state.model)
    flat = {(n, k): v for n, st in out.items() for k, v in st.items()
            if torch.is_tensor(v) and v.ndim}
    whole = TP.gather_tensors(flat, {k: lays[k[0]] for k in flat
                                     if k[0] in lays}, state.model_group)
    for (n, k), v in whole.items():
        out[n][k] = v
    return out


def whole_params(state, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Trainables (or their EMA, or gradients) by name, on the CPU, whole:
    gathered over the state's model group where there is one (every rank
    of it calls this)."""
    from tooncrafter_tpu_torch.parallel import tensor as TP

    if state.model_group is not None:
        tensors = TP.gather_tensors(tensors, TP.layouts(state.model),
                                    state.model_group)
    return _cpu(tensors)


def train(d, spec) -> dict:
    """Data-parallel training on this rank's rows of ``spec['batch']`` (a
    global batch, CPU tensors; equal rows a rank):

      * ``first_draws`` (global): the first step's loss and its reduced
        gradients (``grads``, every trainable by name; rank 0 returns them);
      * for each (label, steps[, TrainConfig overrides]) of ``profiles``
        (the optimizer profile is the label unless overridden): from the
        initial weights, ``steps`` steps with EMA on draws from one
        generator seeded ``gen_seed`` (the same on every rank; or every step
        on ``profile_draws``, the global batch's), a digest of the
        trainables after each step and, on rank 0 with ``return_params``,
        the trainables after the last;
      * ``save_dir``: after the first profile, a checkpoint written by
        every rank, and this rank's owned optimizer state and the EMA;
      * ``owned``: the names of the trainables this rank's optimizer owns;
      * ``restore_dir``: a fresh state of the first profile restored from
        it, its trainables, owned optimizer state and EMA.

    ``pass_dropout`` makes the dropout modules pass their input through.
    Returns, besides, each profile's step seconds, the peak memory (GiB,
    on CUDA) and the kernel launches over all steps."""
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.training import checkpoints as CKPT
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    from tooncrafter_tpu_torch.parallel import tensor as TP

    dev = d.device
    clock = _Clock(dev)
    mesh = M.make_mesh(n_model=spec.get("n_model", 1), device_type=dev.type)
    model = _model(spec, dev)
    if spec.get("pass_dropout"):
        pass_dropout_(model)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    clock("build")
    drank, dworld = M.rank_world(M.data_group(mesh))
    b = spec["batch"]["video"].shape[0] // dworld
    rows = slice(drank * b, (drank + 1) * b)
    batch = {k: v[rows].to(dev) for k, v in spec["batch"].items()}
    tcfg = T.TrainConfig(**spec.get("train_config", {}))
    out = {"rank": d.rank, "world": d.world, "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.shape)), "profiles": {}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kc.reset_launch_counts()

    def config(profile):
        over = {"optimizer": profile[0], **(profile[2] if len(profile) > 2
                                            else {})}
        return dataclasses.replace(tcfg, **over)

    def fresh(pcfg):
        TP.unshard_(model, init)
        return T.make_train_state(model, pcfg, use_ema=True, group=mesh)[0]

    if "first_draws" in spec:
        state = fresh(tcfg)
        clock("state")
        draws = {k: v.to(dev) for k, v in spec["first_draws"].items()}
        metrics, grads = T.loss_and_grads(model, tcfg, state, batch,
                                          draws=draws)
        clock("first loss and backward")
        T.reduce_grads_(state, grads)
        clock("first all-reduce")
        out["first_loss"] = float(T.mean_metrics(metrics, state.group)["loss"])
        whole = whole_params(state, {n: g.detach().float() for n, g in
                                     zip(state.train_params, grads)})
        if d.rank == 0:
            out["grads"] = whole
        out["grads_digest"] = param_digest(grads)
        clock("digest")
        del grads
    for i, profile in enumerate(spec.get("profiles", ())):
        name, steps = profile[:2]
        pcfg = config(profile)
        state = fresh(pcfg)
        clock("state")
        step_fn = T.make_train_step(model, state.optimizer, pcfg)
        gen = torch.Generator(dev).manual_seed(spec.get("gen_seed", 0))
        pdraws = spec.get("profile_draws")
        if pdraws is not None:
            pdraws = {k: v.to(dev) for k, v in pdraws.items()}
        digests, seconds, losses = [], [], []
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step_fn(state, batch, gen, pdraws)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            clock("steps")
            losses.append(float(metrics["loss"]))
            digests.append(param_digest(list(state.train_params.values())))
            clock("digest")
        rec = {"digests": digests, "seconds": seconds, "losses": losses}
        if spec.get("return_params"):
            params = whole_params(state, state.train_params)
            if d.rank == 0:
                rec["params"] = params
        out["profiles"][name] = rec
        local = getattr(state.optimizer, "optim", state.optimizer)
        mine = {id(p) for g in local.param_groups for p in g["params"]}
        out["owned"] = [n for n, p in state.train_params.items()
                        if id(p) in mine]
        if i == 0 and spec.get("save_dir"):
            CKPT.save_train_state(spec["save_dir"], state.step, state)
            out["saved"] = {"ema": whole_params(state, state.ema_params)}
            if state.model_group is None or dworld == 1:
                out["saved"]["opt"] = owned_state(state)
            clock("checkpoint")
    if spec.get("restore_dir"):
        state = fresh(config(spec["profiles"][0]) if spec.get("profiles")
                      else tcfg)
        _, step = CKPT.restore_train_state(spec["restore_dir"], state)
        out["restored"] = {"step": step,
                           "params": whole_params(state, state.train_params),
                           "opt": owned_state(state),
                           "ema": whole_params(state, state.ema_params)}
    out["launches"] = kc.launch_counts()
    out["clock"] = clock.spent
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def serve(d, spec) -> dict:
    """``BatchedPipeline`` over the ranks: every rank builds the model
    (``spec``'s weights, bf16 on CUDA), takes rank 0's weights and runs
    its slice of ``spec['inputs']`` (video, tokens, null_tokens, fs: the
    whole batch, CPU tensors) with per-item generators of ``seed`` (or
    from ``x_T``). Returns the gathered clips (rank 0, CPU numpy), a
    digest of them (every rank), this rank's clip count, seconds, peak
    memory (GiB, on CUDA) and kernel launches."""
    from tooncrafter_tpu_torch.models.diffusion import Pipeline
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.parallel.serving import BatchedPipeline
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    dev = d.device
    mesh = M.make_mesh(n_model=spec.get("n_model", 1), device_type=dev.type)
    model = _model(spec, dev)
    if dev.type == "cuda":
        model.to_compute_dtype()
    model.eval()
    kw = dict(spec.get("pipeline", {}))
    guidance = GuidanceConfig(**kw.pop("guidance", {}))
    srv = BatchedPipeline(Pipeline(model, guidance=guidance, **kw), mesh,
                          shard_params=spec.get("n_model", 1) > 1)
    srv.place_params()
    video, tokens, null, fs = (t.to(dev) for t in spec["inputs"])
    x_T = spec.get("x_T")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    clips = srv(video, tokens, null, fs, seed=spec.get("seed", 0),
                x_T=None if x_T is None else x_T.to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mine = M.batch_slice(video.shape[0],
                         *M.rank_world(M.data_group(mesh)))
    out = {"rank": d.rank, "clips_here": mine.stop - mine.start,
           "seconds": seconds, "launches": kc.launch_counts(),
           "digest": param_digest([clips]),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if d.rank == 0:
        out["clips"] = clips.cpu().numpy()
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def relative_l2(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                ) -> float:
    """|a - b| / |b| over every tensor of b, concatenated, in float64."""
    fa = torch.cat([a[k].double().flatten() for k in b])
    fb = torch.cat([b[k].double().flatten() for k in b])
    return float((fa - fb).norm() / fb.norm().clamp_min(1e-300))



def unet_forward(d, spec) -> dict:
    """One UNet call with the UNet's transformer blocks sharded over the
    model axis of a (world / ``n_model``, ``n_model``) mesh: every rank
    builds the model (``spec``'s weights, the same on every rank) in its
    config's compute dtype (bf16 on CUDA), keeps its shard, checks that the state dict gathered from every
    rank's shards is its own whole one bit for bit, and runs
    ``spec['inputs']`` (x, timesteps,
    context, fs: CPU tensors) with ``cfg_groups``. Returns the output (rank
    0, CPU fp32), its digest (every rank), whether the gather matched, a
    few local weight shapes, the seconds and the kernel launches of the
    call."""
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.parallel import tensor as TP
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    dev = d.device
    mesh = M.make_mesh(n_model=spec["n_model"], device_type=dev.type)
    model = _model(spec, dev).to_compute_dtype().eval()
    whole = {k: v.detach().clone() for k, v in model.state_dict().items()}
    TP.shard_(model, mesh)
    gathered = TP.gather_state_dict(model)
    same = (list(gathered) == list(whole)
            and all(torch.equal(gathered[k], whole[k]) for k in whole))
    del gathered, whole
    x, ts, ctx, fs = (t.to(dev) for t in spec["inputs"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model.unet(x, ts, ctx, fs, cfg_groups=spec.get("cfg_groups", 1))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kc.launch_counts()
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()
              if k in spec.get("report_shapes", ())}
    res = {"rank": d.rank, "gather_equal": same, "seconds": seconds,
           "launches": launches, "digest": param_digest([out]),
           "shapes": shapes,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if d.rank == 0:
        res["out"] = out.float().cpu()
    return res


def cli_train(d, argv) -> dict:
    """``cli/train.py`` with ``argv`` on this rank, in the group the rank
    has joined (as under torchrun). Returns the rank."""
    from tooncrafter_tpu_torch.cli import train as cli

    cli.main(list(argv))
    return {"rank": d.rank}


def mesh_layout(d, n_data, n_model) -> dict:
    """``make_mesh(n_data, n_model)`` on this rank: the mesh's shape and
    the global ranks of this rank's data and model groups (None: no model
    group)."""
    import torch.distributed as dist

    from tooncrafter_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(n_data, n_model, device_type=d.device.type)
    mg = M.model_group(mesh)
    return {"shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "data": dist.get_process_group_ranks(M.data_group(mesh)),
            "model": None if mg is None else dist.get_process_group_ranks(mg)}

