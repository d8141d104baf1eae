"""Which kernel the port launches at every ResBlock conv and temporal conv of
the training branch of the 320x512 and 576x1024 training models, against
what the JAX package's training branch takes there.

As tests/test_torch_selectors_1024.py: the port's model is built from
configs/training_512_v1.0.yaml and configs/training_1024_v1.0.yaml on the
meta device, its CUDA launches stubbed, and its UNet driven through one
training forward with grad enabled (the YAML's batch of clips x 16 frames,
the ResBlocks and TemporalConvBlocks on their unfused branch, dropout 0.1);
spies record each conv site and the launch counter that moved. The JAX side
is its selectors at the same shapes, as they decide on a TPU.

  * The ResBlock convs: the JAX package's ``SpatialConv3x3`` without a
    prologue goes through ``_impl`` with an identity affine: F(2x4) (#14)
    on ``_TABLE24``, F(2x2) (#13) on ``_TABLE``, XLA elsewhere (#15 only
    under TC_SPATIAL_CONV_PALLAS). The port takes the same name at the same
    sites and ``F.conv2d`` where the JAX package runs XLA.
  * The temporal convs: the port's kernel at every shape; the JAX package's
    rule ``_use_kernel`` declines the 1280-wide levels (no pixel tile both
    divides P and fits its VMEM budget), where it runs XLA: the deliberate
    difference, the same function.

A training step with 'dots' checkpointing runs each forward launch twice
(the recomputation keeps no Function's output).
"""

import collections
import os

import pytest
import torch

from test_torch_selectors_1024 import (_spy, _stub_launches, _tconv_key,
                                       jax_choice)
from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu_torch.config import load_yaml, model_config_from_yaml
from tooncrafter_tpu_torch.models import unet as unet_mod
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import temporal_conv as tc
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")

# launches of one training forward of the UNet at the YAML's batch (two
# clips at 512, one at 1024: the FF's resident / streamed split moves with
# the token count)
TRAIN_LAUNCHES = {
    "512": {"_flash_mh_packed": 10, "_flash_mh": 5, "_pallas_ff": 20,
            "_pallas_ff_streamed": 13, "_fused_tpair_call": 17,
            "_pallas_tconv": 88, "winograd_gn_silu_conv3x3": 17},
    "1024": {"_flash_mh": 10, "_flash_bh_with_lse": 5, "_pallas_ff": 22,
             "_pallas_ff_streamed": 11, "_fused_tpair_call": 17,
             "_pallas_tconv": 88, "winograd_gn_silu_conv3x3": 9,
             "winograd24_gn_silu_conv3x3": 6},
}
# the (H, W, Cin, Cout) of the convs a kernel takes
KERNEL_SITES = {
    "512": {(20, 32, 640, 640), (20, 32, 1280, 640), (20, 32, 1920, 640),
            (10, 16, 1280, 1280), (10, 16, 1920, 1280),
            (10, 16, 2560, 1280)},
    "1024": {(36, 64, 640, 640), (18, 32, 1280, 1280), (18, 32, 1920, 1280),
             (18, 32, 2560, 1280)},
}


@pytest.fixture(scope="module", params=sorted(TRAIN_LAUNCHES))
def sites(request):
    path = os.path.join(CONFIGS, f"training_{request.param}_v1.0.yaml")
    cfg = model_config_from_yaml(path)
    bsz = load_yaml(path)["data"]["params"]["batch_size"]
    with torch.device("meta"):
        model = ToonCrafter(cfg)
    model.unet.train()
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    meta = dict(device="meta")
    log = []
    with pytest.MonkeyPatch.context() as mp, torch.enable_grad():
        _stub_launches(mp)
        _spy(mp, unet_mod, "spatial_conv3x3", "conv",
             lambda x, affine, conv, *a, **k: tuple(x.shape[1:]) + (
                 conv.weight.shape[0],), log)
        _spy(mp, tc, "temporal_conv3", "tconv", _tconv_key, log)
        kc.reset_launch_counts()
        out = model.unet(
            torch.empty(bsz, t, h, w, cfg.unet_in_channels, **meta),
            torch.empty(bsz, **meta),
            torch.empty(bsz, 77 + t * cfg.resampler_queries,
                        cfg.context_dim, **meta),
            torch.empty(bsz, **meta))
        counts = kc.launch_counts()
    kc.reset_launch_counts()
    assert out.requires_grad
    return {"config": request.param, "log": log, "counts": counts,
            "unfused": all(m.unfused for m in model.unet.modules()
                           if isinstance(m, unet_mod.ResBlock))}


@pytest.fixture
def on_tpu(monkeypatch):
    monkeypatch.setattr(_dispatch, "on_tpu", lambda: True)


def _rows(sites, kind):
    return [(key, moved) for k, key, moved in sites["log"] if k == kind]


def test_training_launches_per_forward(sites):
    assert sites["unfused"]
    counts = {k: v for k, v in sites["counts"].items() if v}
    assert counts == TRAIN_LAUNCHES[sites["config"]]
    kinds = collections.Counter(k for k, _, _ in sites["log"])
    assert kinds == {"conv": 44, "tconv": 88}  # 22 ResBlocks


def test_resblock_convs_take_the_jax_choice(sites, on_tpu):
    rows = _rows(sites, "conv")
    for key, moved in rows:
        assert moved == jax_choice("conv", key), key
    assert {key for key, moved in rows if moved != "plain"} == KERNEL_SITES[
        sites["config"]]
    f24 = {key for key, moved in rows
           if moved == "winograd24_gn_silu_conv3x3"}
    assert f24 == ({(36, 64, 640, 640)} if sites["config"] == "1024"
                   else set())


def test_temporal_convs_take_the_kernel_everywhere(sites, on_tpu):
    rows = _rows(sites, "tconv")
    assert rows and all(moved == "_pallas_tconv" for _, moved in rows)
    # no prologue, no residual (added after conv4), no sums
    assert {key[4:] for key, _ in rows} == {(False, False, False)}
    plain = {key[1:4] for key, _ in rows
             if jax_choice("tconv", key) == "plain"}
    assert plain and {c for _, c, _ in plain} == {1280}
    assert all(jax_choice("tconv", key) == "_pallas_tconv"
               for key, _ in rows if key[2] != 1280)
