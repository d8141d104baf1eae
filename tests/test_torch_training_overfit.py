"""The overfit criterion of tests/test_training_convergence.py on the
port's tiny model (tooncrafter_tpu_torch.training), fp32 on the CPU: one
batch and one draw repeated for 40 steps with the LambdaLR warmup; the
warmup's step-0 update is zero (the loss repeats within 1e-5), the loss
falls at least 10x, and the EMA shadow ends between the init and the raw
weights.
"""

import numpy as np
import pytest
import torch

from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.training import trainer as T
from tooncrafter_tpu_torch.utils.weights import init_random_

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

WARMUP = {"target": "utils.lr_scheduler.LambdaLRScheduler",
          "params": {"num_warmup_steps": 2}}


def _batch(c, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.uniform(-1, 1, (b, c.video_length, c.latent_h * 8,
                                     c.latent_w * 8, 3)).astype(np.float32),
        "tokens": rng.integers(0, 49408, (b, 77)),
        "null_tokens": np.zeros((b, 77), np.int64),
        "fs": np.array([10, 3][:b], np.int32),
        "fps": np.array([8.0, 24.0][:b], np.float32),
    }


def test_overfit_one_batch():
    """tests/test_training_convergence.py::test_overfit_one_batch on the
    port: 40 steps on one batch with one draw."""
    cfg = ModelConfig().tiny()
    model = ToonCrafter(cfg)
    init_random_(model, torch.Generator().manual_seed(0))
    tcfg = T.TrainConfig(learning_rate=2e-3, weight_decay=0.0,
                         uncond_prob=0.0, rand_cond_frame=False,
                         scheduler=WARMUP)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    step_fn = T.make_train_step(model, opt, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    draws = T.sample_draws(model, batch["video"],
                           torch.Generator().manual_seed(7), False)
    losses = []
    for _ in range(40):
        torch.manual_seed(0)  # the same dropout masks every step
        state, metrics = step_fn(state, batch, draws=draws)
        losses.append(float(metrics["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
    assert state.step == 40

    def dist(a, b):
        return float(torch.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a)))
    raw = {k: p.detach() for k, p in state.train_params.items()}
    start = {k: init[k] for k in raw}
    d_init = dist(state.ema_params, start)
    d_raw = dist(state.ema_params, raw)
    assert d_init > 0.0, "EMA never moved"
    assert d_raw < d_init, "EMA should be closer to raw than to init"
    assert d_raw < dist(start, raw)
