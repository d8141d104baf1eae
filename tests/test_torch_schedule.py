"""The port's schedule math against tooncrafter_tpu/ops/schedule.py: the
numpy constants must agree exactly (same float64 recipe, same float32
storage); the two tensor functions within fp32 rounding (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import schedule as JS
from tooncrafter_tpu_torch.ops import schedule as S

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "log_one_minus_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1",
          "posterior_mean_coef2", "lvlb_weights", "scale_arr")


@pytest.mark.parametrize("kw", [
    {},
    {"rescale_betas_zero_snr": False, "parameterization": "eps",
     "use_dynamic_rescale": False},
    {"beta_schedule": "cosine", "parameterization": "x0"},
])
def test_schedule_arrays_equal_jax(kw):
    ours, ref = S.build_schedule(**kw), JS.build_schedule(**kw)
    for f in FIELDS:
        a, e = getattr(ours, f), getattr(ref, f)
        if e is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, e, err_msg=f)


@pytest.mark.parametrize("spacing", ["uniform_trailing", "uniform", "quad"])
@pytest.mark.parametrize("steps", [50, 7])
@pytest.mark.parametrize("eta", [1.0, 0.0])
def test_ddim_schedule_equals_jax(spacing, steps, eta):
    ours = S.build_ddim_schedule(S.build_schedule(), steps, eta, spacing)
    ref = JS.build_ddim_schedule(JS.build_schedule(), steps, eta, spacing)
    for f in ("timesteps", "alphas", "alphas_prev", "sigmas",
              "sqrt_one_minus_alphas", "scale_arr", "scale_arr_prev"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f),
                                      err_msg=f)


def test_uniform_trailing_quirks():
    # trailing spacing ends at the last DDPM step and starts one below c
    t50 = S.make_ddim_timesteps("uniform_trailing", 50, 1000)
    assert t50[-1] == 999 and t50[0] == 19 and len(t50) == 50
    t7 = S.make_ddim_timesteps("uniform_trailing", 7, 1000)
    assert t7[-1] == 999 and len(t7) == 7
    assert S.make_ddim_timesteps("uniform", 50, 1000)[0] == 1


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        S.make_beta_schedule("nope", 10)
    with pytest.raises(NotImplementedError):
        S.make_ddim_timesteps("nope", 10, 1000)


def test_rescale_noise_cfg_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(0)
    cfg = rng.normal(size=(2, 4, 3, 5, 4)).astype(np.float32) * 3
    txt = rng.normal(size=(2, 4, 3, 5, 4)).astype(np.float32)
    ours = S.rescale_noise_cfg(torch.from_numpy(cfg), torch.from_numpy(txt),
                               0.7).numpy()
    ref = np.asarray(JS.rescale_noise_cfg(jnp.asarray(cfg), jnp.asarray(txt),
                                          0.7))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    # a zero-variance prediction stays finite
    z = S.rescale_noise_cfg(torch.zeros(1, 4), torch.zeros(1, 4), 0.7)
    assert torch.isfinite(z).all()
    # the fp32 phase t*freq near t=999 has an ulp of 6.1e-5, so the two
    # frameworks' cos/sin may differ by that much there
    ts = np.array([0.0, 1.0, 17.5, 999.0], np.float32)
    for dim in (64, 65, 320):
        np.testing.assert_allclose(
            S.timestep_embedding(torch.from_numpy(ts), dim).numpy(),
            np.asarray(JS.timestep_embedding(jnp.asarray(ts), dim)),
            rtol=0, atol=1e-4)
