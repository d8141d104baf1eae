"""The port's sampler extras against tooncrafter_tpu's on the CPU in fp32:
``ddim_sample`` with a temperature and with the mask/x0 blend (clean and
noised), ``stochastic_encode``, ``ddim_decode_from`` and ``ddpm_sample``.

Both sides run the same stub denoiser, a fixed linear map built from numpy
(the latent and concat channels, the timestep, the context and fs). The
noise is the JAX side's: the test replays the JAX function's key sequence
and hands each draw to the port in the order the port draws (its ``R``
swapped for a queue). Tolerance: max |port - jax|
<= 1e-5 of max |jax|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import schedule as JS
from tooncrafter_tpu.sampling import ddim as jddim
from tooncrafter_tpu.sampling import ddpm as jddpm
from tooncrafter_tpu.utils import rngs as JR
from tooncrafter_tpu_torch.ops import schedule as S
from tooncrafter_tpu_torch.sampling import ddim as pddim
from tooncrafter_tpu_torch.sampling import ddpm as pddpm
from tooncrafter_tpu_torch.utils import rngs as R

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TOL = 1e-5
SHAPE = (2, 3, 4, 4, 4)  # (B, T, h, w, C)
CC = 4  # concat channels


def _close(port, ref):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    scale = float(np.abs(ref).max())
    assert np.isfinite(port).all() and err <= TOL * scale, (err, scale)


def _stub():
    rng = np.random.default_rng(0)
    c = SHAPE[-1]
    w = (rng.normal(size=(c + CC, c)) * 0.3).astype(np.float32)
    tb = rng.normal(size=(c,)).astype(np.float32)

    def jax_fn(x, ts, ctx, fs):
        col = lambda v: v.reshape((-1, 1, 1, 1, 1))
        return (jnp.einsum("bthwc,cd->bthwd", x, w)
                + col(ts / 1000.0) * tb + col(ctx.mean(axis=(1, 2)) * 0.5)
                + col(fs * 0.01))

    def torch_fn(x, ts, ctx, fs):
        col = lambda v: v.reshape((-1, 1, 1, 1, 1))
        return (x @ torch.from_numpy(w) + col(ts / 1000.0) * torch.from_numpy(
            tb) + col(ctx.mean(dim=(1, 2)) * 0.5) + col(fs * 0.01))
    return jax_fn, torch_fn


def _inputs(n_branches, seed=1):
    rng = np.random.default_rng(seed)
    b = SHAPE[0]
    x_T = rng.normal(size=SHAPE).astype(np.float32)
    ctx = rng.normal(size=(n_branches, b, 5, 6)).astype(np.float32)
    concat = rng.normal(size=SHAPE[:-1] + (CC,)).astype(np.float32)
    fs = np.array([10.0, 24.0], np.float32)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[:, 0] = 1.0
    return x_T, ctx, concat, fs, x0, mask


class _Replay:
    """Stands in for the port sampler's ``utils/rngs``: each draw is the
    next of the JAX function's draws."""

    def __init__(self, draws):
        self.draws = list(draws)

    @staticmethod
    def is_batched(gen):
        return False

    def normal(self, gen, shape, device=None, dtype=torch.float32):
        d = self.draws.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return torch.from_numpy(np.array(d, np.float32)).to(dtype)


def _ddim_draws(key, ddim, temperature, mask, clean_cond):
    """The draws the port makes, taken from the JAX loop's key sequence:
    per step the mask's q_sample noise, then the step noise where
    sigma > 0."""
    draws = []
    for i in reversed(range(ddim.num_steps)):
        key, nkey = JR.split(key)
        if mask:
            key, mkey = JR.split(key)
            if not clean_cond:
                draws.append(JR.normal(mkey, SHAPE))
        if ddim.sigmas[i] * np.float32(temperature) > 0:
            draws.append(JR.normal(nkey, SHAPE))
    return draws


def _schedules(parameterization="v"):
    # eps on a zero-terminal-SNR schedule divides by sqrt(alpha) = 0
    kw = dict(parameterization=parameterization,
              rescale_betas_zero_snr=parameterization == "v")
    return JS.build_schedule(**kw), S.build_schedule(**kw)


@pytest.mark.parametrize("case", [
    dict(parameterization="v", eta=1.0, temperature=0.5),
    dict(parameterization="eps", eta=1.0, temperature=1.7),
    dict(parameterization="v", eta=0.0, mask=True, clean_cond=True),
    dict(parameterization="v", eta=0.0, mask=True, clean_cond=False),
    dict(parameterization="v", eta=1.0, temperature=0.7, mask=True,
         clean_cond=False),
], ids=["temperature", "temperature-eps", "mask-clean", "mask-noised",
        "mask-noised-temperature"])
def test_ddim_sample_matches_jax(case, monkeypatch):
    jsched, psched = _schedules(case["parameterization"])
    steps, temp = 6, case.get("temperature", 1.0)
    jd = JS.build_ddim_schedule(jsched, steps, eta=case["eta"])
    pd = S.build_ddim_schedule(psched, steps, eta=case["eta"])
    g = dict(cfg_scale=7.5, guidance_rescale=0.7)
    x_T, ctx, concat, fs, x0, mask = _inputs(2)
    use_mask = case.get("mask", False)
    clean = case.get("clean_cond", False)
    key = jax.random.PRNGKey(5)
    jfn, tfn = _stub()
    ref = jddim.ddim_sample(
        jfn, jsched, jd, jnp.asarray(x_T), jnp.asarray(ctx),
        jnp.asarray(concat), jnp.asarray(fs), key,
        jddim.GuidanceConfig(**g), temperature=temp,
        mask=jnp.asarray(mask) if use_mask else None,
        x0=jnp.asarray(x0) if use_mask else None, clean_cond=clean)
    replay = _Replay(_ddim_draws(key, jd, temp, use_mask, clean))
    monkeypatch.setattr(pddim, "R", replay)
    t = torch.from_numpy
    out = pddim.ddim_sample(
        tfn, psched, pd, t(x_T), t(ctx), t(concat), t(fs),
        pddim.GuidanceConfig(**g), None, temperature=temp,
        mask=t(mask) if use_mask else None,
        x0=t(x0) if use_mask else None, clean_cond=clean)
    assert not replay.draws
    _close(out.numpy(), ref)


def test_ddim_decode_from_matches_jax(monkeypatch):
    jsched, psched = _schedules()
    jd = JS.build_ddim_schedule(jsched, 8, eta=1.0)
    pd = S.build_ddim_schedule(psched, 8, eta=1.0)
    x_T, ctx, concat, fs, _, _ = _inputs(1, seed=2)
    key, t_start = jax.random.PRNGKey(9), 4
    jfn, tfn = _stub()
    ref = jddim.ddim_decode_from(
        jfn, jsched, jd, jnp.asarray(x_T), jnp.asarray(ctx),
        jnp.asarray(concat), jnp.asarray(fs), key,
        jddim.GuidanceConfig(cfg_scale=1.0), t_start)
    replay = _Replay(_ddim_draws(key, _cut(pd, t_start), 1.0, False,
                                 False))
    monkeypatch.setattr(pddim, "R", replay)
    t = torch.from_numpy
    out = pddim.ddim_decode_from(
        tfn, psched, pd, t(x_T), t(ctx), t(concat), t(fs),
        pddim.GuidanceConfig(cfg_scale=1.0), t_start)
    assert not replay.draws
    _close(out.numpy(), ref)


def _cut(ddim, t_start):
    """The sub-schedule of the steps below ``t_start``."""
    return dataclasses.replace(ddim, **{
        f.name: getattr(ddim, f.name)[:t_start]
        for f in dataclasses.fields(ddim)
        if getattr(ddim, f.name) is not None})


def test_stochastic_encode_matches_jax_and_is_per_item(monkeypatch):
    jsched, psched = _schedules()
    jd = JS.build_ddim_schedule(jsched, 10, eta=0.0, spacing="uniform")
    pd = S.build_ddim_schedule(psched, 10, eta=0.0, spacing="uniform")
    x0 = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jddim.stochastic_encode(jd, jnp.asarray(x0), 5, key)
    with monkeypatch.context() as m:
        m.setattr(pddim, "R", _Replay([JR.normal(key, SHAPE)]))
        out = pddim.stochastic_encode(pd, torch.from_numpy(x0), 5)
    _close(out.numpy(), ref)
    # per-item generators: an item's noise does not depend on the batch
    both = pddim.stochastic_encode(pd, torch.from_numpy(x0), 5,
                                   R.per_item_generators(0, [0, 1]))
    for i in range(2):
        alone = pddim.stochastic_encode(pd, torch.from_numpy(x0[i:i + 1]),
                                        5, R.per_item_generators(0, [i]))
        torch.testing.assert_close(both[i:i + 1], alone, rtol=0, atol=0)


@pytest.mark.parametrize("parameterization,clip", [
    ("v", False), ("eps", False), ("x0", True), ("v", True)])
def test_ddpm_sample_matches_jax(parameterization, clip, monkeypatch):
    kw = dict(timesteps=20, parameterization=parameterization)
    jsched, psched = JS.build_schedule(**kw), S.build_schedule(**kw)
    x_T, ctx, concat, fs, _, _ = _inputs(1, seed=6)
    key = jax.random.PRNGKey(11)
    jfn, tfn = _stub()
    ref = jddpm.ddpm_sample(jfn, jsched, jnp.asarray(x_T), jnp.asarray(ctx),
                            jnp.asarray(concat), jnp.asarray(fs), key,
                            clip_denoised=clip)
    draws = []
    for t in range(psched.num_timesteps - 1, -1, -1):
        key, nkey = jax.random.split(key)
        if t > 0:  # the port draws no noise for the last step
            draws.append(jax.random.normal(nkey, SHAPE))
    replay = _Replay(draws)
    monkeypatch.setattr(pddpm, "R", replay)
    t_ = torch.from_numpy
    out = pddpm.ddpm_sample(tfn, psched, t_(x_T), t_(ctx), t_(concat),
                            t_(fs), None, clip_denoised=clip)
    assert not replay.draws
    _close(out.numpy(), ref)
