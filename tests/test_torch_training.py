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
    ``optax.MultiSteps`` on the same micro-gradients. The 'adamw_lowmem'
    and 'adafactor' profiles the same way over 4 updates, on a factored
    4-D weight (given to optax in the JAX layout (kh, kw, I, O)), a 2-D
    weight below the factoring size and a bias: adafactor at rtol 1e-5;
    adamw_lowmem at rtol 1e-5 plus, per update, one bf16 ulp (2^-7
    relative) of its lr-scaled normalized first moment, and its bf16 mu
    equal to optax's bit for bit without a clip (with one, the global
    norm's summation order moves g by an ulp, which flips a bf16 rounding
    of mu in ~0.1% of the elements; the bound above covers those).
  * A checkpoint round trip with keep-K, and the weights-only export; for
    each low-memory profile, resuming equals continuing (bf16 mu stays
    bf16, the factored rows and columns keep their shapes).

The overfit criterion is in tests/test_torch_training_overfit.py.
"""

import collections
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
    _assert_grads_match({k: p.grad.numpy() for k, p in tparams.items()},
                        ref_grads, pm)


def _assert_grads_match(got, ref_grads, pm):
    """Every trainable's gradient against the JAX tree's: the whole
    gradient's cosine >= 0.99999, each within 2e-3 of its largest
    magnitude."""
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads),
                          pm.config)
    assert set(ref) == set(got)
    flat = np.concatenate([got[k].ravel() for k in ref])
    want = np.concatenate([ref[k].numpy().ravel() for k in ref])
    cos = float(flat @ want / (np.linalg.norm(flat) * np.linalg.norm(want)))
    assert cos >= 0.99999, cos
    for k, r in ref.items():
        scale = max(float(np.abs(r.numpy()).max()), 1e-8)
        err = float(np.abs(got[k] - r.numpy()).max()) / scale
        assert err <= 2e-3, (k, err)


def test_training_branch_gradients_match_jax(models, monkeypatch):
    """train=True: the ResBlocks and TemporalConvBlocks on their unfused
    (training) branch, each conv through its kernel's Function (here the
    plain version forward, the XLA form's gradient back); dropout held out
    of both sides (the port's nn.Dropout as in eval, the JAX side's
    flax.linen.Dropout an identity), so the same draws give the same loss.
    The bars of test_loss_and_gradients_match_jax."""
    import flax.linen as fnn

    monkeypatch.setattr(torch.nn.Dropout, "forward",
                        lambda self, x: torch.nn.functional.dropout(
                            x, self.p, training=False))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jm, params, pm = models
    c = jm.config
    b = 2
    batch = _batch(c, b, seed=4)
    key = jax.random.PRNGKey(7)
    train, frozen = JT.split_trainable(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(tp):
        return JT.diffusion_loss(jm, tp, frozen, jb, key, uncond_prob=0.3,
                                 train=True)
    (ref_loss, _), ref_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(train)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_draws(key, c, b, jm.schedule.num_timesteps)
             .items()}
    tparams, _ = T.split_trainable(pm)
    for p in tparams.values():
        p.grad = None
    functions = collections.Counter()
    hooks = [m.register_forward_hook(
        lambda mod, args, out: functions.update([type(mod).__name__]))
        for m in pm.unet.modules() if type(m).__name__ == "ResBlock"]
    loss, _ = T.diffusion_loss(pm, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                               uncond_prob=0.3, train=True, draws=draws)
    for h in hooks:
        h.remove()
    assert functions["ResBlock"] and all(
        m.unfused for m in pm.unet.modules()
        if type(m).__name__ == "ResBlock")
    seen = collections.Counter()
    stack = [loss.grad_fn]
    while stack:  # the convs' Functions are in the graph
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen[fn] += 1
        stack += [n for n, _ in fn.next_functions]
    kinds = collections.Counter(type(fn).__name__ for fn in seen)
    assert kinds["_TconvFunctionBackward"] == 4 * functions["ResBlock"]
    loss.backward()
    got = {k: p.grad.numpy() for k, p in tparams.items()}
    for p in tparams.values():  # the fixture's model is shared
        p.grad = None
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads_match(got, ref_grads, pm)


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


def _profile_params(seed=0):
    """A factored 4-D conv weight (O, I, 3, 3), a 2-D weight below the
    factoring size and a bias."""
    rng = np.random.default_rng(seed)
    return {"conv": (rng.normal(size=(160, 128, 3, 3)) * 0.05).astype(
                np.float32),
            "w": rng.normal(size=(96, 64)).astype(np.float32),
            "b": rng.normal(size=(64,)).astype(np.float32)}


def _jax_layout(k, v):
    """The conv weight as the JAX package holds it: (kh, kw, I, O)."""
    return np.transpose(v, (2, 3, 1, 0)) if k == "conv" else v


def _grads(n, seed=1, like=None):
    rng = np.random.default_rng(seed)
    like = like or _small_params()
    return [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in like.items()} for _ in range(n)]


def _lowmem_slack(state, lr):
    """One bf16 ulp (2^-7 relative) of each parameter's normalized first
    moment after an update, scaled by that update's ``lr``."""
    out = {}
    for k, p in state.train_params.items():
        st = state.optimizer.state[p]
        n = float(st["step"])
        u = (st["mu"].float().abs() / (1 - 0.9 ** n)
             / ((st["nu"] / (1 - 0.999 ** n)).sqrt() + 1e-8))
        out[k] = lr * 2.0 ** -7 * float(u.max())
    return out


@pytest.mark.parametrize("opt_name,sched,clip", [
    ("adamw", WARMUP, 0.0), ("adamw", COSINE, 0.0), ("adamw", None, 1.5),
    ("adamw_lowmem", COSINE, 0.0), ("adamw_lowmem", WARMUP, 1.5),
    ("adafactor", COSINE, 0.0), ("adafactor", WARMUP, 1.5)])
def test_adamw_ema_and_schedule_match_optax(opt_name, sched, clip):
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, grad_clip=clip,
              scheduler=sched, ema_decay=0.9, optimizer=opt_name)
    cfg, jcfg = T.TrainConfig(**kw), JT.TrainConfig(**kw)
    p0 = _small_params() if opt_name == "adamw" else _profile_params()
    opt = JT.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(_jax_layout(k, v)) for k, v in p0.items()}
    jstate, jema = opt.init(jparams), jparams
    state = _small_state(cfg, p0)
    slack = dict.fromkeys(p0, 0.0)
    steps = 3 if opt_name == "adamw" else 4
    for i, g in enumerate(_grads(steps, like=p0)):
        upd, jstate = opt.update(
            {k: jnp.asarray(_jax_layout(k, v)) for k, v in g.items()},
            jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = JT.ema_update(jema, jparams, i, 0.9)
        lr = state.optimizer.param_groups[0]["lr"]
        T.update(state, cfg, [torch.tensor(g[k])
                              for k in state.train_params])
        if opt_name == "adamw_lowmem":
            for k, v in _lowmem_slack(state, lr).items():
                slack[k] += v
        for k in p0:
            np.testing.assert_allclose(
                _jax_layout(k, state.train_params[k].detach().numpy()),
                jparams[k], rtol=1e-5, atol=max(1e-6, slack[k]))
            np.testing.assert_allclose(
                _jax_layout(k, state.ema_params[k].numpy()), jema[k],
                rtol=1e-5, atol=max(1e-6, slack[k]))
    assert state.step == steps
    if opt_name == "adamw_lowmem":
        jmu = optax.tree.get(jstate, "mu")
        for k, p in state.train_params.items():
            mu = state.optimizer.state[p]["mu"]
            assert mu.dtype == torch.bfloat16
            want = np.asarray(jmu[k]).astype(np.float32)
            got = _jax_layout(k, mu.float().numpy())
            frac = float((got != want).mean())
            assert frac <= (0.0 if clip == 0 else 5e-3), (k, frac)


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


@pytest.mark.parametrize("opt_name", ["adamw_lowmem", "adafactor"])
def test_profile_checkpoint_resume_equals_continuing(tmp_path, opt_name):
    cfg = T.TrainConfig(learning_rate=1e-2, scheduler=COSINE,
                        optimizer=opt_name)
    p0 = _profile_params()
    grads = _grads(4, like=p0)
    state = _small_state(cfg, p0)
    for g in grads[:2]:
        T.update(state, cfg, [torch.tensor(g[k])
                              for k in state.train_params])
    CKPT.save_train_state(str(tmp_path), 2, state)
    fresh, step = CKPT.restore_train_state(
        str(tmp_path), _small_state(cfg, _profile_params(9)))
    assert step == 2 and fresh.step == 2
    conv = fresh.train_params["conv"]
    st = fresh.optimizer.state[conv]
    if opt_name == "adamw_lowmem":
        assert st["mu"].dtype == torch.bfloat16
        assert st["nu"].dtype == torch.float32
    else:  # rows: means over O (the largest dim), columns: over I
        assert st["v_row"].shape == (128, 3, 3)
        assert st["v_col"].shape == (160, 3, 3)
        assert "v" in fresh.optimizer.state[fresh.train_params["w"]]
    for g in grads[2:]:
        for s in (state, fresh):
            T.update(s, cfg, [torch.tensor(g[k]) for k in s.train_params])
    for k, p in state.train_params.items():
        torch.testing.assert_close(fresh.train_params[k].detach(),
                                   p.detach(), rtol=0, atol=0)
        for name, t in state.optimizer.state[p].items():
            got = fresh.optimizer.state[fresh.train_params[k]][name]
            assert got.dtype == t.dtype
            torch.testing.assert_close(got, t, rtol=0, atol=0)
