"""The port's training path (tooncrafter_tpu_torch.training) against the
JAX package's at the tiny config in fp32 on the CPU.

  * The loss and the gradient of every trainable tensor (UNet and image
    projector) against ``jax.value_and_grad`` of the JAX ``diffusion_loss``
    with train=False: the test rebuilds the JAX step's draws from its key
    (posterior noise, ``rand``, ``cond_frame``, ``ts``, ``noise``,
    ``offset``) and hands them to the port; weights are the port's seeded
    init with its all-zero tensors replaced by seeded noise, carried to the
    JAX tree by the checkpoint mapping's layout transforms (the inverse of
    ``utils.weights.from_jax_params``, which maps the JAX gradients back).
    Bars: loss within 1e-5 relative; each gradient within 2e-3 of its
    largest magnitude and the whole gradient's cosine >= 0.99999 (fp32
    through the UNet, the VAE, both CLIP towers and the resampler: sums in
    other orders).
  * AdamW, the EMA and the scheduler YAML against optax over 3 updates on
    the same gradients (rtol 1e-5, fp32); ``grad_accum`` against
    ``optax.MultiSteps`` on the same micro-gradients.
  * A checkpoint round trip with keep-K, and the weights-only export.

The overfit criterion is in tests/test_torch_training_overfit.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.training import trainer as JT
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.training import checkpoints as CKPT
from tooncrafter_tpu_torch.training import trainer as T
from tooncrafter_tpu_torch.utils import checkpoint as ckpt
from tooncrafter_tpu_torch.utils.weights import from_jax_params, init_random_

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

WARMUP = {"target": "utils.lr_scheduler.LambdaLRScheduler",
          "params": {"num_warmup_steps": 2}}
COSINE = {"target": "torch.optim.lr_scheduler.CosineAnnealingLR",
          "params": {"decay_steps": 5, "warm_up_steps": 1,
                     "final_factor": 0.1}}


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


def _jax_draws(key, c, b, sched_steps):
    """The JAX diffusion_loss's draws from its key (trainer.py:123-166)."""
    rngs = jax.random.split(key, 8)
    t, h, w, zc = c.video_length, c.latent_h, c.latent_w, c.z_channels
    return {
        "posterior": jax.random.normal(rngs[0], (b * t, h, w, zc),
                                       jnp.float32),
        "rand": jax.random.uniform(rngs[1], (b,)),
        "cond_frame": jax.random.randint(rngs[2], (), 0, t),
        "ts": jax.random.randint(rngs[3], (b,), 0, sched_steps),
        "noise": jax.random.normal(rngs[4], (b, t, h, w, zc), jnp.float32),
        "offset": jax.random.normal(rngs[6], (b, t, 1, 1, zc), jnp.float32),
    }


def _jax_tree(model):
    """The port's weights as the JAX package's parameter tree."""
    sd = model.state_dict()
    tree = {}
    for tower, entries in ckpt.full_mapping(model.config).items():
        for jpath, tkey, fn in entries:
            if tkey in sd:
                node = tree.setdefault(tower, {})
                for k in jpath[:-1]:
                    node = node.setdefault(k, {})
                node[jpath[-1]] = jnp.asarray(fn(sd[tkey].numpy()))
    return tree


@pytest.fixture(scope="module")
def models():
    pm = ToonCrafter(ModelConfig().tiny(noise_strength=0.1))
    gen = torch.Generator().manual_seed(5)
    init_random_(pm, gen)
    with torch.no_grad():
        for p in pm.parameters():
            if not p.any():
                p.normal_(0.0, 0.05, generator=gen)
    jm = JaxToonCrafter(JaxConfig().tiny(noise_strength=0.1))
    return jm, _jax_tree(pm), pm


def test_loss_and_gradients_match_jax(models):
    jm, params, pm = models
    c = jm.config
    b = 2
    batch = _batch(c, b)
    key = jax.random.PRNGKey(3)
    train, frozen = JT.split_trainable(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(tp):
        return JT.diffusion_loss(jm, tp, frozen, jb, key, uncond_prob=0.3,
                                 train=False)
    (ref_loss, _), ref_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(train)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_draws(key, c, b, jm.schedule.num_timesteps)
             .items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams, _ = T.split_trainable(pm)
    for p in tparams.values():
        p.grad = None
    loss, metrics = T.diffusion_loss(pm, tb, uncond_prob=0.3, train=False,
                                     draws=draws)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads),
                          pm.config)
    assert set(ref) == set(tparams)
    got = np.concatenate([tparams[k].grad.numpy().ravel() for k in ref])
    want = np.concatenate([ref[k].numpy().ravel() for k in ref])
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.99999, cos
    for k, r in ref.items():
        g = tparams[k].grad.numpy()
        scale = max(float(np.abs(r.numpy()).max()), 1e-8)
        err = float(np.abs(g - r.numpy()).max()) / scale
        assert err <= 2e-3, (k, err)


# ---------------------------------------------------------------------------
# optimizer, EMA, schedule, accumulation
# ---------------------------------------------------------------------------

def _small_state(cfg, params_np, use_ema=True):
    train = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params_np.items()}
    opt, sched = T.make_optimizer(cfg, list(train.values()))
    ema = ({k: p.detach().clone() for k, p in train.items()} if use_ema
           else None)
    return T.TrainState(step=0, model=None, train_params=train,
                        frozen_params={}, optimizer=opt, scheduler=sched,
                        ema_params=ema)


def _small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _grads(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(8, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("sched,clip", [(WARMUP, 0.0), (COSINE, 0.0),
                                        (None, 1.5)])
def test_adamw_ema_and_schedule_match_optax(sched, clip):
    cfg = T.TrainConfig(learning_rate=1e-2, weight_decay=1e-2,
                        grad_clip=clip, scheduler=sched, ema_decay=0.9)
    jcfg = JT.TrainConfig(learning_rate=1e-2, weight_decay=1e-2,
                          grad_clip=clip, scheduler=sched, ema_decay=0.9)
    p0 = _small_params()
    opt = JT.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate, jema = opt.init(jparams), jparams
    state = _small_state(cfg, p0)
    for i, g in enumerate(_grads(3)):
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = JT.ema_update(jema, jparams, i, 0.9)
        T.update(state, cfg, [torch.tensor(g[k])
                              for k in state.train_params])
        for k in p0:
            np.testing.assert_allclose(
                state.train_params[k].detach().numpy(), jparams[k],
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(state.ema_params[k].numpy(), jema[k],
                                       rtol=1e-5, atol=1e-6)
    assert state.step == 3


def test_grad_accum_matches_multisteps():
    cfg = T.TrainConfig(learning_rate=1e-2, grad_accum=2,
                        scheduler=WARMUP)
    jcfg = JT.TrainConfig(learning_rate=1e-2, grad_accum=2,
                          scheduler=WARMUP)
    p0 = _small_params(2)
    opt = JT.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jparams)
    state = _small_state(cfg, p0, use_ema=False)
    for i, g in enumerate(_grads(6, seed=4)):
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        T.update(state, cfg, [torch.tensor(g[k])
                              for k in state.train_params])
        for k in p0:
            np.testing.assert_allclose(
                state.train_params[k].detach().numpy(), jparams[k],
                rtol=1e-5, atol=1e-6)
        if i % 2 == 0:  # a micro-step leaves the weights as they were
            assert state.micro == 1


def test_unported_optimizers_raise():
    for name in ("adamw_lowmem", "adafactor"):
        with pytest.raises(NotImplementedError):
            T.make_optimizer(T.TrainConfig(optimizer=name),
                             [torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(ValueError):
        T.make_optimizer(T.TrainConfig(optimizer="nope"),
                         [torch.nn.Parameter(torch.zeros(2))])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_keep(tmp_path):
    cfg = T.TrainConfig(learning_rate=1e-2, grad_accum=2, scheduler=WARMUP)
    state = _small_state(cfg, _small_params())
    grads = _grads(5)
    for g in grads[:3]:  # one update, then a micro-step pending
        T.update(state, cfg, [torch.tensor(g[k])
                              for k in state.train_params])
    for step in range(1, 5):
        CKPT.save_train_state(str(tmp_path), step, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.pt",
                                            "step_00000004.pt"]
    saved = {k: p.detach().clone() for k, p in state.train_params.items()}
    fresh = _small_state(cfg, _small_params(9))
    fresh, step = CKPT.restore_train_state(str(tmp_path), fresh)
    assert step == 4 and fresh.step == state.step == 3
    assert fresh.micro == 1
    for k in saved:
        torch.testing.assert_close(fresh.train_params[k].detach(), saved[k])
        torch.testing.assert_close(fresh.ema_params[k], state.ema_params[k])
    # both continue alike: the pending micro-step completes an update
    for s in (state, fresh):
        T.update(s, cfg, [torch.tensor(grads[3][k])
                          for k in s.train_params])
    for k in saved:
        torch.testing.assert_close(fresh.train_params[k].detach(),
                                   state.train_params[k].detach())
    assert CKPT.restore_train_state(str(tmp_path / "none"), fresh)[1] == 0
    CKPT.save_params(str(tmp_path / "w.pt"), T.eval_param_tree(state))
    loaded = CKPT.load_params(str(tmp_path / "w.pt"))
    for k, e in state.ema_params.items():
        torch.testing.assert_close(loaded[k], e)
