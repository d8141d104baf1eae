"""The port's metrics and LPIPS against tooncrafter_tpu's on the CPU in
fp32: ``psnr``, ``ssim``, ``video_psnr`` and the ``lpips`` hook, and the
LPIPS head with random weights routed through both packages'
``load_lpips_params`` (the pretrained weights are not in the repo), with
``lpips_mapping`` covering every tensor. Inputs from numpy with a seed.
Tolerances: PSNR, SSIM and the feature-hook distance within 1e-5 relative
(fp32 reductions in another order); LPIPS rtol 2e-4 (tests/test_lpips.py's:
13 random 3x3 convs deep).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.models import lpips as jlp
from tooncrafter_tpu.utils import metrics as JM
from tooncrafter_tpu_torch.models import lpips as plp
from tooncrafter_tpu_torch.utils import metrics as M

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)
    return a, b


def test_psnr_ssim_video_psnr_match_jax():
    a, b = _pair((2, 3, 24, 20, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(M.psnr(ta, tb).numpy(),
                               np.asarray(JM.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(M.video_psnr(ta, tb).numpy(),
                               np.asarray(JM.video_psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(M.ssim(ta, tb).numpy(),
                               np.asarray(JM.ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(M.ssim(ta[0, 0], tb[0, 0])),
                               float(JM.ssim(a[0, 0], b[0, 0])), rtol=1e-5)
    assert float(M.psnr(ta, ta).min()) > 100
    np.testing.assert_allclose(M.ssim(ta, ta).numpy(), 1.0, atol=1e-5)


def test_lpips_hook_requires_an_extractor():
    a, b = _pair((1, 8, 8, 3), seed=1)
    with pytest.raises(ValueError, match="weights"):
        M.lpips(torch.from_numpy(a), torch.from_numpy(b))
    fe = lambda x: [x, x[:, ::2, ::2]]
    np.testing.assert_allclose(
        M.lpips(torch.from_numpy(a), torch.from_numpy(b), fe).numpy(),
        np.asarray(JM.lpips(jnp.asarray(a), jnp.asarray(b), fe)), rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    """Random VGG16 and lin weights under the torch keys (tamed so 13
    random convs stay finite)."""
    rng = np.random.default_rng(2)
    vgg, cin = {}, 3
    for item in plp._VGG16_LAYOUT:
        if item == "M":
            continue
        idx, ch = item
        vgg[f"features.{idx}.weight"] = (rng.normal(size=(ch, cin, 3, 3))
                                         * 0.2 / np.sqrt(cin)).astype(
            np.float32)
        vgg[f"features.{idx}.bias"] = (rng.normal(size=(ch,)) * 0.1).astype(
            np.float32)
        cin = ch
    lins = {f"lin{i}.model.1.weight": rng.uniform(
        -0.2, 1, (1, c, 1, 1)).astype(np.float32)
        for i, c in enumerate(plp.TAP_CHANNELS)}
    return vgg, lins


def test_lpips_matches_jax(weights):
    vgg, lins = weights
    a, b = _pair((2, 32, 32, 3), seed=3)
    want = np.asarray(jlp.LPIPS().apply(
        {"params": jlp.load_lpips_params(vgg, lins)}, a, b))
    params = plp.load_lpips_params(vgg, lins)
    got = M.lpips(torch.from_numpy(a), torch.from_numpy(b),
                  params=params).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    same = M.lpips(torch.from_numpy(a), torch.from_numpy(a), params=params)
    assert float(same.abs().max()) == 0.0


def test_lpips_mapping_covers_every_tensor(weights):
    vgg, lins = weights
    keys = {k for _, k, _ in plp.lpips_mapping()}
    assert keys == set(plp.LPIPS().state_dict()) == set(vgg) | set(lins)
    # the same (parameter path, key) pairs as the TPU package's table
    assert ([e[:2] for e in plp.lpips_mapping()]
            == [e[:2] for e in jlp.lpips_mapping()])
    for (_, key, fn), (_, _, jfn) in zip(plp.lpips_mapping(),
                                         jlp.lpips_mapping()):
        w = {**vgg, **lins}[key]
        np.testing.assert_array_equal(fn(w), jfn(w))
    # missing lin heads default to ones; a missing VGG16 tensor raises
    sd = plp.load_lpips_params(vgg, {})
    assert all(float(sd[f"lin{i}.model.1.weight"].min()) == 1.0
               for i in range(len(plp.TAP_CHANNELS)))
    with pytest.raises(KeyError, match="VGG16"):
        plp.load_lpips_params({}, lins)
