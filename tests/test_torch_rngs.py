"""The --bs contract of the port (utils/rngs.py), as
tests/test_fps_and_batching.py pins it for the JAX package: every clip draws
its posterior, x_T and step noise from its own generator, keyed by its
global index, so a batch of two reproduces two single-clip runs and the
inference CLI writes the same videos at --bs 2 as at --bs 1.

Bars: the Pipeline at 2e-5 (fp32 on the CPU; batched and single convs and
matmuls sum in other orders), the CLI's clips within 1 after uint8, as the
JAX test holds them. The frames are compared as the CLI hands them to the
video writer: the two runs differ at fp32 rounding level, which flips a
rare uint8 rounding by 1, and the lossy mp4 codec turns such a flip into a
difference of several units in the decoded file.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from tooncrafter_tpu_torch.cli import inference as cli
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.utils import rngs as R
from tooncrafter_tpu_torch.utils import video_io
from tooncrafter_tpu_torch.utils.weights import init_random_

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_per_item_draws_are_each_items_own():
    gens = R.per_item_generators(123, [0, 1, 2])
    batched = R.normal(gens, (3, 4, 5))
    for i, g in enumerate(R.per_item_generators(123, [0, 1, 2])):
        torch.testing.assert_close(batched[i], torch.randn(4, 5, generator=g),
                                   rtol=0, atol=0)
    # an item's stream depends on (seed, index) only
    again = R.normal(R.per_item_generators(123, [2]), (1, 4, 5))
    torch.testing.assert_close(again[0], batched[2], rtol=0, atol=0)
    assert not torch.equal(batched[0], batched[1])
    other_seed = R.normal(R.per_item_generators(124, [0]), (1, 4, 5))
    assert not torch.equal(other_seed[0], batched[0])
    assert R.item_seed(123, 7) == R.item_seed(123, 7) != R.item_seed(7, 123)
    with pytest.raises(ValueError, match="per-item"):
        R.normal(gens, (2, 4))


def test_one_generator_draws_the_whole_batch():
    a = R.normal(torch.Generator().manual_seed(5), (2, 3))
    torch.testing.assert_close(
        a, torch.randn(2, 3, generator=torch.Generator().manual_seed(5)),
        rtol=0, atol=0)


@pytest.fixture(scope="module")
def tiny_model():
    model = ToonCrafter(ModelConfig().tiny()).eval()
    init_random_(model, torch.Generator().manual_seed(0))
    return model


def test_pipeline_bs2_matches_two_bs1_runs(tiny_model):
    """eta 1 and a sampled posterior: every draw is per clip."""
    cfg = tiny_model.config
    rng = np.random.default_rng(1)
    t, h, w = cfg.video_length, cfg.latent_h * 8, cfg.latent_w * 8
    video = torch.from_numpy(
        rng.uniform(-1, 1, (2, t, h, w, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 49408, (2, 77)))
    null = torch.zeros_like(tokens)
    fs = torch.full((2,), 10.0)
    pipe = Pipeline(tiny_model, ddim_steps=2, eta=1.0, perframe_ae=True,
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7))
    out2 = pipe(video, tokens, null, fs,
                generator=R.per_item_generators(9, [0, 1]))
    for i in range(2):
        out1 = pipe(video[i:i + 1], tokens[i:i + 1], null[i:i + 1],
                    fs[i:i + 1], generator=R.per_item_generators(9, [i]))
        torch.testing.assert_close(out2[i], out1[0], rtol=2e-5, atol=2e-5)
    # and the draws do reach the clip: other keys give another clip
    other = pipe(video[:1], tokens[:1], null[:1], fs[:1],
                 generator=R.per_item_generators(9, [5]))
    assert (other[0] - out2[0]).abs().max().item() > 1e-3


TINY_YAML = {"model": {"params": {
    "unet_config": {"params": {
        "model_channels": 64, "num_res_blocks": 1, "channel_mult": [1, 2],
        "attention_resolutions": [1, 2], "num_head_channels": 32,
        "context_dim": 64, "temporal_length": 4}},
    "first_stage_config": {"params": {"ddconfig": {
        "z_channels": 4, "ch": 32, "ch_mult": [1, 2, 2, 2],
        "num_res_blocks": 1}}},
    "cond_stage_config": {"params": {"width": 64, "heads": 4, "layers": 2}},
    "img_cond_stage_config": {"params": {"width": 64, "heads": 4,
                                         "layers": 2, "image_size": 28}},
    "image_proj_stage_config": {"params": {"depth": 1, "heads": 4,
                                           "num_queries": 4}},
}}}


def test_cli_bs2_writes_the_videos_of_bs1(tmp_path, monkeypatch):
    """The port's CLI on the JAX test's tiny config, --device cpu."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY_YAML))
    written = {}
    write = video_io.write_video

    def recording(path, video, fps=8):
        written[path] = video_io.to_uint8(video).astype(np.int16)
        return write(path, video, fps)
    monkeypatch.setattr(video_io, "write_video", recording)
    outs = {}
    for bs in (1, 2):
        savedir = tmp_path / f"out_bs{bs}"
        cli.main(["--config", str(cfg_path),
                  "--prompt_dir", os.path.join(REPO, "prompts", "512_interp"),
                  "--savedir", str(savedir), "--interp", "--height", "32",
                  "--width", "32", "--video_length", "4", "--ddim_steps", "2",
                  "--seed", "123", "--bs", str(bs), "--device", "cpu"])
        outs[bs] = sorted((savedir / "samples_separate").iterdir())
    assert [p.name for p in outs[1]] == [p.name for p in outs[2]]
    assert len(outs[1]) >= 2
    clips = {bs: [written[str(p)] for p in outs[bs]] for bs in (1, 2)}
    for p, f1, f2 in zip(outs[1], clips[1], clips[2]):
        assert f1.shape == (4, 32, 32, 3)
        assert np.max(np.abs(f1 - f2)) <= 1, p.name
    # the two prompts got different noise (and images): different clips
    assert np.abs(clips[2][0] - clips[2][1]).max() > 1
