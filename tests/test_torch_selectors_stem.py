"""CFG stem sharing on the full-width models: the launches of one UNet call
with ``cfg_groups=2`` (a CFG pair over one clip, as ``ToonCrafter.denoise``
calls it) against the same call with ``cfg_groups=1``, for the 320x512 and
576x1024 models built on the meta device in bf16, their CUDA launches
stubbed (as tests/test_torch_selectors_1024.py builds them).

The stem (the init attention and the first ResBlock, before the first
cross-attending SpatialTransformer) launches its kernels on one clip's rows
instead of two, the same number of times; every other launch is unchanged;
and the stem's shapes and epilogues are the rows ``kernel_check.STEM_512``
and ``STEM_1024`` that phase 2 of chip_smoke.py holds each kernel to.
"""

import collections
import os

import pytest
import torch

from test_torch_selectors_1024 import _stub_launches
from tooncrafter_tpu_torch.config import model_config_from_yaml
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops import temporal_conv as tc
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _record(mp, log):
    """Wrap the stubbed launches to log (kernel, shape and epilogue)."""
    conv, tconv = sc._launch_conv, tc._launch_tconv
    tpair, ffl = ta._launch_tpair, ff._launch_ff

    def conv_rec(x, a, b, w9, bias, res, silu, stats, **kw):
        log.append(("conv", tuple(x.shape) + (w9.shape[0],)))
        return conv(x, a, b, w9, bias, res, silu, stats)

    def tconv_rec(x, w3, bias, a, b, res, scale, silu, stats):
        log.append(("tconv", tuple(x.shape[:3]) + (x.shape[3],
                                                   res is not None,
                                                   scale is not None, stats)))
        return tconv(x, w3, bias, a, b, res, scale, silu, stats)

    def tpair_rec(x, *a):
        log.append(("tpair", tuple(x.shape)))
        return tpair(x, *a)

    def ff_rec(x2, *a):
        log.append(("ff", tuple(x2.shape)))
        return ffl(x2, *a)
    mp.setattr(sc, "_launch_conv", conv_rec)
    mp.setattr(tc, "_launch_tconv", tconv_rec)
    mp.setattr(ta, "_launch_tpair", tpair_rec)
    mp.setattr(ff, "_launch_ff", ff_rec)


def _walk(yaml):
    cfg = model_config_from_yaml(os.path.join(CONFIGS, yaml))
    with torch.device("meta"):
        model = ToonCrafter(cfg).to(torch.bfloat16)
    model.eval()
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    meta = dict(device="meta", dtype=torch.bfloat16)
    args = (torch.empty(2, t, h, w, cfg.unet_in_channels, **meta),
            torch.empty(2, device="meta"),
            torch.empty(2, 77 + t * cfg.resampler_queries, cfg.context_dim,
                        **meta),
            torch.empty(2, device="meta"))
    logs = {}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        _stub_launches(mp)
        log = []
        _record(mp, log)
        for g in (1, 2):
            model.unet(*args, cfg_groups=g)
            logs[g], log[:] = collections.Counter(log), []
    return logs


def _stem_rows(stem):
    """kernel_check's stem rows as the walk logs them."""
    rows = collections.Counter()
    for _, n, c in stem["ff"]:
        rows[("ff", (n, c))] = 1
    for _, (b, t, p, c), res, scale, stats in stem["tconv"]:
        rows[("tconv", (b, t, p, c, res, scale, stats))] = 1
    for _, (n, h, w, cin, cout) in stem["conv"]:
        rows[("conv", (n, h, w, cin, cout))] = 1
    for _, p, c in stem["tpair"]:
        rows[("tpair", (1, 16, p, c))] = 1
    return rows


@pytest.mark.parametrize("yaml,stem", [
    ("inference_512_v1.0.yaml", kc.STEM_512),
    ("inference_1024_v1.0.yaml", kc.STEM_1024)])
def test_the_stem_runs_on_one_clip(yaml, stem):
    logs = _walk(yaml)
    whole, shared = logs[1], logs[2]
    assert sum(whole.values()) == sum(shared.values())
    for kind in ("conv", "tconv", "tpair", "ff"):
        assert (sum(v for (k, _), v in whole.items() if k == kind)
                == sum(v for (k, _), v in shared.items() if k == kind)), kind
    added, removed = shared - whole, whole - shared
    # each stem launch at half the rows replaces one at the full batch
    assert sum(added.values()) == sum(removed.values()) > 0
    assert set(added) == set(_stem_rows(stem))
    # the stem: the init attention (one pair, one FF) and the first
    # ResBlock (two convs, three temporal convs with sums, one with the
    # residual and sums)
    by_kind = collections.Counter()
    for (kind, _), n in added.items():
        by_kind[kind] += n
    assert by_kind == {"tpair": 1, "ff": 1, "conv": 2, "tconv": 4}
    # (the FF's rows span the clips' frames and pixels)
    assert {(kind, (shape[0] // 2,) + shape[1:])
            for kind, shape in removed} == set(added)
