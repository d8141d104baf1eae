"""Entry points of the port's compile-style checks: one UNet forward, and a
multi-rank dry run (the counterpart of the root ``__graft_entry__.py``,
which is JAX code).

    from tooncrafter_tpu_torch import graft_entry
    fn, args = graft_entry.entry("cuda"); fn(*args)
    graft_entry.dryrun_multidevice(2)          # ranks sharing the card
    graft_entry.dryrun_multidevice(2, "cpu")   # ranks on the CPU

``entry(device)`` returns ``(fn, args)``: one denoising forward of a UNet at
the flagship 320x512x16 topology with reduced channels (128 model channels,
64-channel heads, a 256-wide context, bf16, batch 2, 16x40x64 latents)
under the fan-in-scaled fill (``utils/synth.py``). On ``"meta"`` the module
and the inputs are fake tensors (``FakeTensorMode``): ``fn(*args)`` then
evaluates the output's shape and dtype and computes nothing, as
``jax.eval_shape`` does for the JAX entry.

``dryrun_multidevice(n)`` spawns n ranks over gloo (sharing the card, or
on the CPU when asked with ``device="cpu"``) at the tiny config on the JAX
dry run's mesh: (n / 2, 2) where n is even and at least 4 (a model axis of
2: the UNet's transformer blocks sharded, ``parallel/tensor.py``), else
(n, 1). One training step with EMA, the validation step with and without
EMA, and ``BatchedPipeline(shard_params=True)`` DDIM-2 with CFG 7.5 and
rescale 0.7 over a batch of one clip a data rank.
"""

from __future__ import annotations

import dataclasses

import torch


def entry(device="cuda"):
    """(fn, (x, ts, ctx, fs)): the UNet forward at the JAX entry's config
    on ``device`` ("cuda", "cpu", or "meta" for fake tensors)."""
    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.synth import synth_

    cfg = dataclasses.replace(ModelConfig(), model_channels=128,
                              num_head_channels=64, context_dim=256,
                              compute_dtype=torch.bfloat16)
    with torch.device("meta"):
        unet = ToonCrafter(cfg).unet  # only the UNet takes part
    fake = str(device) == "meta"
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        dev = torch.device("cpu")
    else:
        import contextlib
        mode = contextlib.nullcontext()
        dev = torch.device(device)
    t = cfg.video_length
    with mode:
        unet = synth_(unet.to_empty(device=dev)).eval()
        x = torch.zeros((2, t, cfg.latent_h, cfg.latent_w, 8),
                        dtype=torch.bfloat16, device=dev)
        ts = torch.zeros((2,), device=dev)
        ctx = torch.zeros((2, 77 + t * cfg.resampler_queries,
                           cfg.context_dim), dtype=torch.bfloat16, device=dev)
        fs = torch.full((2,), 10.0, device=dev)

    @torch.no_grad()
    def fn(x, ts, ctx, fs):
        return unet(x, ts, ctx, fs)

    return fn, (x, ts, ctx, fs)


def _dryrun_rank(d, n_model: int = 1) -> dict:
    """One rank of ``dryrun_multidevice``: its data rank's clip of a zero
    batch of one clip a data rank, the UNet sharded over ``n_model``."""
    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.parallel.serving import BatchedPipeline
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.weights import init_random_

    dev = d.device
    mesh = M.make_mesh(n_model=n_model, device_type=dev.type)
    drank, n_data = M.rank_world(M.data_group(mesh))
    cfg = ModelConfig().tiny()
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    torch.manual_seed(drank)  # dropout's stream: seed + data rank
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(0))
    tcfg = T.TrainConfig(learning_rate=1e-4)
    state, opt = T.make_train_state(model, tcfg, use_ema=True, group=mesh)
    b, t = n_data, cfg.video_length
    h_px, w_px = cfg.latent_h * 8, cfg.latent_w * 8
    full = {"video": torch.zeros((b, t, h_px, w_px, 3), device=dev),
            "tokens": torch.zeros((b, 77), dtype=torch.long, device=dev),
            "null_tokens": torch.zeros((b, 77), dtype=torch.long,
                                       device=dev),
            "fs": torch.full((b,), 10, device=dev),
            "fps": torch.full((b,), 8.0, device=dev)}
    mine = slice(drank, drank + 1)
    batch = {k: v[mine] for k, v in full.items()}
    _, metrics = T.make_train_step(model, opt, tcfg)(
        state, batch, torch.Generator(dev).manual_seed(1))
    if state.step != 1:
        raise RuntimeError(f"step count {state.step} after one step")
    val = T.make_val_step(model, tcfg)(state, batch,
                                       torch.Generator(dev).manual_seed(2))
    if "val/loss_ema" not in val:
        raise RuntimeError("no EMA validation loss")
    with torch.no_grad():  # serve the EMA weights (eval_param_tree)
        for k, e in state.ema_params.items():
            state.train_params[k].copy_(e)
    model.eval()
    if dev.type == "cuda":
        model.to_compute_dtype()
    srv = BatchedPipeline(Pipeline(model, ddim_steps=2, guidance=GuidanceConfig(
        cfg_scale=7.5, guidance_rescale=0.7)), mesh, shard_params=True)
    srv.place_params()
    out = srv(full["video"], full["tokens"], full["null_tokens"],
              full["fs"].float(), seed=3)
    if tuple(out.shape) != tuple(full["video"].shape):
        raise RuntimeError(f"served {tuple(out.shape)} for "
                           f"{tuple(full['video'].shape)}")
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "loss": float(metrics["loss"]), "val": float(val["val/loss"]),
            "val_ema": float(val["val/loss_ema"]),
            "decode_checksum": float(out.abs().mean())}


def dryrun_multidevice(n: int, device: str = "cuda",
                       timeout: float = 300.0) -> dict:
    """Spawn ``n`` ranks (gloo; sharing the card, or on the CPU with
    ``device="cpu"``), run the dry run, print its line and return rank 0's
    values. Raises if there is no card for ``"cuda"``, a rank fails or a
    value is not finite."""
    import math

    from tooncrafter_tpu_torch.parallel.spawn import run_ranks

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multidevice: no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")

    n_model = 2 if n % 2 == 0 and n >= 4 else 1  # the JAX dry run's rule
    res = run_ranks(_dryrun_rank, n, device, args=(n_model,),
                    timeout=timeout, threads=1 if device == "cpu" else None)
    r0 = res[0]
    vals = [r0[k] for k in ("loss", "val", "val_ema", "decode_checksum")]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"dryrun_multidevice: a value is not finite: {r0}")
    print(f"dryrun_multidevice OK on {n} ranks (mesh {r0['mesh']}), "
          f"loss={r0['loss']:.4f}, "
          f"val={r0['val']:.4f}, val_ema={r0['val_ema']:.4f}, "
          f"decode_checksum={r0['decode_checksum']:.5f}", flush=True)
    return r0

