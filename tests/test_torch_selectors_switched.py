"""Which kernel the port launches at each temporal attention, conv and
GroupNorm site of the 320x512 model with the JAX package's three opt-in
switches on (TC_TATTN_PAIR=0, TC_SPATIAL_CONV_PALLAS=1,
TOONCRAFTER_FUSED_GN=1), against the JAX package's selectors under the same
switches, and the launches per UNet call.

As tests/test_torch_selectors_1024.py: the port's model is built from
configs/inference_512_v1.0.yaml on the meta device in bf16 (the card's
dtype: the GroupNorm rule counts a sample's bytes in it), its CUDA launches
stubbed, and driven through one UNet call (2 CFG branches x 16 frames of the
40x64 latent), one per-frame encode of a 320x512 frame and one 16-frame
dual-ref decode, then one UNet call in training mode; spies record each
site and the launch counter that moved. The JAX side is its selectors on
the same shapes as they decide on a TPU.

The GroupNorm sites are pinned by where the JAX package reads no producer
sums (its ``GroupNormAct`` without ``stats``): in inference only the
encoder's norm_out (the init attention's norm takes 26 MB a sample, past
the 4 MiB rule); in training every ResBlock and transformer norm and the
TemporalConvBlocks' norms, where a sample fits 4 MiB.
"""

import collections
import os

import pytest
import torch

from test_torch_selectors_1024 import (_spies, _stub_launches, tconv_by_shape,
                                       tconv_table)
from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu.ops import fused_norms as jfn
from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu.ops import winograd as jwg
from tooncrafter_tpu_torch.config import model_config_from_yaml
from tooncrafter_tpu_torch.models import unet as unet_mod
from tooncrafter_tpu_torch.models import vae as vae_mod
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

YAML_512 = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "inference_512_v1.0.yaml")

# launches per UNet call (2 CFG branches x 16 frames at 40x64) with the
# three switches on; a DDIM-50 request runs 50 calls
UNET_LAUNCHES_SWITCHED = {
    "_flash_mh_packed": 10, "_flash_mh": 5, "_pallas_ff": 20,
    "_pallas_ff_streamed": 13, "_fused_tattn_call": 34, "_pallas_tconv": 88,
    "winograd_gn_silu_conv3x3": 33, "_pallas_fused_conv": 11}
# launches of #16 in one UNet call in training mode
TRAIN_GN_LAUNCHES = 89


def _switches(mp, jax_too: bool):
    for mod, attr, val in ((ta, "_PAIR", False),
                           (sc, "_SPATIAL_CONV_PALLAS", True),
                           (fn, "_FUSED_GN", True)):
        mp.setattr(mod, attr, val)
    if jax_too:
        for mod, attr, val in ((jta, "_PAIR", False),
                               (jsc, "_SPATIAL_CONV_PALLAS", True),
                               (jfn, "_FUSED_GN", True)):
            mp.setattr(mod, attr, val)
        mp.setattr(_dispatch, "on_tpu", lambda: True)


def _spy(mp, owner, attr, kind, key, log):
    fn_ = getattr(owner, attr)

    def spied(*args, **kwargs):
        before = kc.launch_counts()
        out = fn_(*args, **kwargs)
        moved = [k for k, v in kc.launch_counts().items() if v != before[k]]
        log.append((kind, key(*args, **kwargs), moved))
        return out
    mp.setattr(owner, attr, spied)


def _walk(mp):
    cfg = model_config_from_yaml(YAML_512)
    assert (cfg.latent_h, cfg.latent_w) == (40, 64)
    with torch.device("meta"):
        model = ToonCrafter(cfg).to(torch.bfloat16)
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    meta = dict(device="meta", dtype=torch.bfloat16)
    _stub_launches(mp)
    stub_conv = sc._launch_conv
    mp.setattr(sc, "_launch_conv",
               lambda *a, round_first=True: stub_conv(*a))
    mp.setattr(ta, "_launch_single", lambda x, *a: torch.empty_like(x))
    mp.setattr(ta, "_launch_ptc", lambda q, *a: torch.empty_like(q))
    mp.setattr(fn, "_launch_gn", lambda x, *a: torch.empty_like(x))
    log = []
    _spies(mp, log)
    _spy(mp, ta, "_fused_tattn_call", "single",
         lambda x, stage, heads, *a, **k: (x.shape[1], x.shape[2],
                                           x.shape[3], heads), log)
    _spy(mp, ta, "temporal_attention_ptc", "ptc",
         lambda q, *a, **k: tuple(q.shape), log)
    _spy(mp, vae_mod, "spatial_conv3x3", "vaeconv",
         lambda x, affine, conv, *a, **k: tuple(x.shape[1:]) + (
             conv.weight.shape[0],), log)
    _spy(mp, norms.GroupNorm, "forward", "gn",
         lambda self, x, *a, chained=False, **k: (
             tuple(x.shape), self.act, chained, self.one_pass), log)
    out = {}
    with torch.no_grad():
        kc.reset_launch_counts()
        model.eval()
        unet_in = (torch.empty(2, t, h, w, cfg.unet_in_channels, **meta),
                   torch.empty(2, device="meta"),
                   torch.empty(2, 77 + t * cfg.resampler_queries,
                               cfg.context_dim, **meta),
                   torch.empty(2, device="meta"))
        model.unet(*unet_in)
        out["unet_counts"] = kc.launch_counts()
        out["unet"], log[:] = list(log), []
        vae = model.first_stage_model
        _, taps = vae.encode(torch.empty(1, 8 * h, 8 * w, 3, **meta))
        refs = [tap.unsqueeze(0).expand((1, 2) + tap.shape[1:])
                for tap in taps]
        vae.decoder(torch.empty(1, t, h, w, cfg.z_channels, **meta), refs)
        out["vae"], log[:] = list(log), []
        kc.reset_launch_counts()
        model.unet.train()
        model.unet(*unet_in)
        out["train_counts"] = kc.launch_counts()
        out["train"] = list(log)
    kc.reset_launch_counts()
    return out


@pytest.fixture(scope="module")
def sites():
    with pytest.MonkeyPatch.context() as mp:
        _switches(mp, jax_too=False)
        return _walk(mp)


@pytest.fixture
def jax_switched(monkeypatch):
    _switches(monkeypatch, jax_too=True)


def _moved(log, kind):
    return [(key, moved) for k, key, moved in log if k == kind]


def test_unet_launches_per_call(sites):
    counts = {k: v for k, v in sites["unet_counts"].items() if v}
    assert counts == UNET_LAUNCHES_SWITCHED


def test_temporal_blocks_take_the_jax_route(sites, jax_switched):
    """Every temporal block: the JAX package is on its fast layout and its
    ``ln=`` path takes ``_fused_tattn_call`` (never the pair under the
    switch, and #11 nowhere: its rule never holds where the single-stage
    rule fails)."""
    rows = _moved(sites["unet"], "single")
    assert len(rows) == 2 * 17
    for (t, p, c, heads), moved in rows:
        d = c // heads
        assert not jta.use_pair_kernel(t, p, d, c, c)
        assert jta.use_fused_kernel(t, p, d, c, c)
        assert moved == ["_fused_tattn_call"]
    assert not _moved(sites["unet"], "pair")
    assert not _moved(sites["unet"], "ptc")
    assert {key[1] for key, _ in rows} == {2560, 640, 160, 40}


def test_phase2_checks_the_temporal_stages_at_every_launched_shape(sites):
    """``kernel_check.TATTN_512`` (#10) and ``TPAIR_512`` (#9, the same
    blocks on the default route) hold every (P, C) the 320x512 UNet
    launches a temporal self-attention stage at."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    launched = {(p, c) for (t, p, c, _), _ in _moved(sites["unet"], "single")}
    assert launched == {(p, c) for _, p, c in kc.TATTN_512}
    assert launched == {(p, c) for _, p, c in kc.TPAIR_512}


def _jax_conv(key):
    if jwg.table_entry24(*key):
        return "winograd24_gn_silu_conv3x3"
    if jwg.table_entry(*key):
        return "winograd_gn_silu_conv3x3"
    return "_pallas_fused_conv" if jsc._use_kernel(*key) else None


def test_convs_take_15_exactly_where_jax_does(sites, jax_switched):
    rows = _moved(sites["unet"], "conv")
    assert len(rows) == 44
    for key, moved in rows:
        # the port's kernel runs where the JAX package runs XLA too, named
        # F(2x2) there, as with the switch off
        assert moved == (_jax_conv(key) or "winograd_gn_silu_conv3x3"), key
    assert {k for k, m in rows if m == "_pallas_fused_conv"} == {
        (40, 64, 320, 320), (40, 64, 640, 320), (20, 32, 320, 640),
        (10, 16, 640, 1280)}
    vae = _moved(sites["vae"], "vaeconv")
    assert vae
    for key, moved in vae:
        want = _jax_conv(key)
        assert moved == ([want] if want else []), key
    assert {k for k, m in vae if m} == {(40, 64, 512, 512)}


# #12's launches by (P, C, residual, out_scale, sums) in one UNet call and
# one decode of the 512 model (a request runs 50 UNet calls and 2 decodes;
# the switches leave the temporal conv's sites as they are): ResBlocks 5,
# 5, 5 and 7 a level; the decoder's 14 TimeStacks
TCONV_BY_SHAPE_512 = tconv_table(
    {(2560, 320): 5, (640, 640): 5, (160, 1280): 5, (40, 1280): 7},
    {(2560, 512): 5, (10240, 512): 3, (40960, 256): 3, (163840, 128): 3})


def test_tconv_launches_by_shape(sites):
    for part, want in TCONV_BY_SHAPE_512.items():
        assert tconv_by_shape(sites[part]) == want, part


def test_group_norm_sites(sites):
    """#16 exactly where the JAX package applies a GroupNormAct without
    producer sums and a sample fits 4 MiB."""
    infer = [(key, m) for key, m in _moved(sites["unet"] + sites["vae"],
                                           "gn")]
    launched = [key for key, m in infer if m == ["_pallas_gn"]]
    # the encoder's norm_out (40x64x512 per image)
    assert launched == [((1, 40, 64, 512), True, False, True)]
    # the init attention's norm: no sums on either side, but 26 MB a sample
    init = [key for key, m in infer if key[0] == (2, 16, 40, 64, 320)
            and not key[2]]
    assert init and fn._MAX_VMEM_SAMPLE_BYTES < 16 * 40 * 64 * 320 * 2
    train = _moved(sites["train"], "gn")
    for (shape, act, chained, one_pass), moved in train:
        per_sample = 2
        for d in shape[1:]:
            per_sample *= d
        assert not chained and one_pass
        fits = per_sample <= jfn._MAX_VMEM_SAMPLE_BYTES
        assert moved == (["_pallas_gn"] if fits else []), shape
    assert sites["train_counts"]["_pallas_gn"] == TRAIN_GN_LAUNCHES
    assert collections.Counter(
        act for (_, act, _, _), m in train if m) == {True: 72, False: 17}
