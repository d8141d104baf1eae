"""The port's smoke CLI (``cli/smoke.py``) on the CPU in fp32 beside
tooncrafter_tpu's: the same tiny configuration, the same request layout
and output shape, a finite clip written. The two draw their random
weights and noise from different generators, so their clips are not
compared; the pipeline they run (the splice, CFG 7.5 + rescale 0.7) is
held to the JAX package's at 40 dB in tests/test_torch_pipeline.py. The
CLI refuses to start without a card unless the CPU is asked for."""

import os

import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu_torch.cli import smoke

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def test_smoke_cli_on_the_cpu(tmp_path):
    c = JaxConfig().tiny()  # the JAX smoke's configuration
    out = smoke.main(["--device", "cpu", "--steps", "2",
                      "--out", str(tmp_path / "clip")])
    assert tuple(out.shape) == (1, c.video_length, c.latent_h * 8,
                                c.latent_w * 8, 3)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert any(p.startswith("clip") for p in os.listdir(tmp_path))


def test_smoke_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        smoke.main(["--steps", "1"])
