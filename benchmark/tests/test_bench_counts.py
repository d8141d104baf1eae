"""The frozen counters: the model-FLOP count (the plain reference on the
meta device) against FlopCounterMode over the port's plain path, and the
per-block operations and bytes against utils/kernel_check's formulas."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts
from benchmark.reference import model as RM
from benchmark.tests import _tiny

torch.set_num_threads(1)


def _port(cfg):
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from benchmark.traffic import i2v

    model = ToonCrafter(i2v.model_config(cfg, "cpu"))
    return model.eval().requires_grad_(False)


def test_request_flops_match_the_port_plain_path():
    from benchmark.traffic import i2v

    cfg = _tiny.config()
    mix = {"ddim_steps": 3}
    b, t, h, w = 2, cfg["video_length"], cfg["latent_h"], cfg["latent_w"]
    model = _port(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        video = torch.zeros(b, t, h * 8, w * 8, 3)
        z, refs = model.encode_first_stage(
            video, noise=torch.zeros(b * t, h, w, 4), chunk_size=1)
        from tooncrafter_tpu_torch.models.diffusion import (
            Pipeline, middle_frame_splice)
        pipe = Pipeline(model)
        tok = torch.zeros(b, 77, dtype=torch.long)
        ctx = pipe.conditioning(tok, tok, video[:, 0])
        xin = torch.zeros(2 * b, t, h, w, 8)
        for _ in range(mix["ddim_steps"]):
            model.unet(xin, torch.zeros(2 * b),
                       ctx.reshape((2 * b,) + ctx.shape[2:]),
                       torch.zeros(2 * b), cfg_groups=2)
        middle_frame_splice(model, z, refs)
    port = fc.get_total_flops()
    ours = i2v.request_flops(cfg, mix, b)
    assert abs(ours - port) <= 0.01 * port, (ours, port)


def test_unet_flops_count_the_stem_once():
    cfg = _tiny.config()
    t, h, w = cfg["video_length"], cfg["latent_h"], cfg["latent_w"]

    def call(groups):
        def fn():
            ref = RM.ToonCrafterRef(cfg)
            ref.unet(torch.zeros(4, t, h, w, 8), torch.zeros(4),
                     torch.zeros(4, 77 + t * cfg["resampler_queries"],
                                 cfg["context_dim"]), torch.zeros(4),
                     cfg_groups=groups)
        return counts.model_flops(fn)

    assert call(2) < call(1)


def test_block_counts_follow_kernel_check():
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    gen = torch.Generator().manual_seed(0)
    n, t, h, w, cin, cout, emb = 8, 4, 6, 10, 64, 96, 128
    conv1 = kc.conv_cases("cpu", gen, shapes=(("a", (n, h, w, cin, cout)),))
    conv2 = kc.conv_cases("cpu", gen, shapes=(("b", (n, h, w, cout, cout)),))
    want = (conv1[0].flops + conv2[0].flops + 2.0 * n * emb * cout
            + 4 * kc.tconv_flops(n // t, t, h * w, cout)
            + 2.0 * n * h * w * cin * cout)
    flops, nbytes = counts.resblock(n, h, w, cin, cout, t, emb)
    assert flops == want
    # input and output once in bf16, at least
    assert nbytes >= 2.0 * n * h * w * (cin + cout)

    s, c, lctx, dctx = 60, 64, 77 + 16, 96
    ff = kc.ff_cases("cpu", gen, shapes=(("f", n * s, c),))[0].flops
    self_attn = kc.ones_cases("cpu", gen, shapes=(("o", n, s, c, 1),))[0]
    cross = 4.0 * n * s * lctx * c        # kc.dual_cases' formula
    lin = 2.0 * n * s * c * c
    want = (ff + self_attn.flops + cross + lin * 8
            + 4.0 * n * lctx * dctx * c)
    flops, nbytes = counts.spatial_transformer(n, s, c, lctx, dctx)
    assert flops == want
    assert nbytes >= 2.0 * (2 * n * s * c + n * lctx * dctx)


def test_least_time_is_the_larger_bound():
    assert counts.least_s(989e12, 0) == 1.0
    assert counts.least_s(0, 3.35e12) == 1.0
