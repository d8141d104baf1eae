"""The port's serving backend (``cli/serve.py``) on the CPU in fp32 at the
tiny YAML of tests/test_serve.py: a request writes its clip, a second one
with the same knobs reuses the cached Pipeline and, with the same seed,
reproduces the clip bit for bit; the single-image ``"repeat"`` mode runs
(and writes PNG frames where neither OpenCV nor Pillow is installed); the
request's input clip equals the layout the JAX class feeds its pipeline
(captured from ``tooncrafter_tpu.cli.serve.Image2Video.get_image``; both
resize in fp32: within 1e-5); the gradio UI is import-gated; the backend
refuses to start without a card unless the CPU is asked for.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tooncrafter_tpu_torch.cli import serve
from tooncrafter_tpu_torch.utils import video_io

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TINY = {"model": {
    "target": "lvdm.models.ddpm3d.LatentVisualDiffusion",
    "params": {
        "unet_config": {
            "target": "lvdm.modules.networks.openaimodel3d.UNetModel",
            "params": {"model_channels": 64, "num_res_blocks": 1,
                       "channel_mult": [1, 2],
                       "attention_resolutions": [1, 2],
                       "num_head_channels": 32, "context_dim": 64,
                       "temporal_length": 4}},
        "first_stage_config": {
            "target": "lvdm.models.autoencoder.AutoencoderKL_Dualref",
            "params": {"embed_dim": 4, "ddconfig": {
                "z_channels": 4, "ch": 32, "ch_mult": [1, 2, 2, 2],
                "num_res_blocks": 1}}},
        "cond_stage_config": {
            "target": "lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder",
            "params": {"width": 64, "heads": 4, "layers": 2}},
        "img_cond_stage_config": {
            "target": "lvdm.modules.encoders.condition."
                      "FrozenOpenCLIPImageEmbedderV2",
            "params": {"width": 64, "heads": 4, "layers": 2,
                       "image_size": 28}},
        "image_proj_stage_config": {
            "target": "lvdm.modules.encoders.resampler.Resampler",
            "params": {"depth": 1, "heads": 4, "num_queries": 4}},
    }}}


@pytest.fixture(scope="module")
def backend(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(yaml.safe_dump(TINY))
    with pytest.warns(UserWarning, match="bpe_path"):
        return serve.Image2Video(
            config_path=str(p), result_dir=str(tmp_path_factory.mktemp("out")),
            resolution=(32, 32), video_length=4, device="cpu")


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (48, 64, 3), dtype=np.uint8),
            rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))


def test_interp_request_writes_clip_and_reuses_pipeline(backend):
    img_a, img_b = _images()
    path = backend.get_image(img_a, "walk cycle", steps=2, image_b=img_b)
    assert os.path.exists(path)
    key = (2, 7.5, 1.0, "interp")
    pipe = backend._pipelines[key]
    first = backend.last_clip
    assert first.shape == (4, 32, 32, 3) and np.isfinite(first).all()
    path2 = backend.get_image(img_a, "walk cycle", steps=2, image_b=img_b)
    assert os.path.exists(path2) and path2 != path
    assert backend._pipelines[key] is pipe and len(backend._pipelines) == 1
    np.testing.assert_array_equal(backend.last_clip, first)
    backend.get_image(img_a, "walk cycle", steps=2, image_b=img_b, seed=124)
    assert not np.array_equal(backend.last_clip, first)


def test_repeat_request_without_opencv_or_pillow(backend, monkeypatch):
    monkeypatch.setattr(video_io, "_cv2", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    img_a, _ = _images(1)
    path = backend.get_image(img_a, "", steps=2, eta=0.0)
    assert (2, 7.5, 0.0, "repeat") in backend._pipelines
    frames = sorted(os.listdir(path))
    assert frames == [f"frame_{i:04d}.png" for i in range(4)]
    assert np.isfinite(backend.last_clip).all()


def test_request_input_matches_jax_layout(backend, tmp_path):
    from tooncrafter_tpu.cli.serve import Image2Video as JaxImage2Video

    class Capture:
        def __call__(self, params, video, tokens, null_tokens, fs, rng):
            self.video = np.asarray(video)
            return jnp.zeros(video.shape)

    jax_backend = JaxImage2Video.__new__(JaxImage2Video)
    jax_backend.cfg = backend.cfg
    jax_backend.resolution = backend.resolution
    jax_backend.result_dir = str(tmp_path)
    jax_backend.tokenizer = None
    jax_backend.params = None
    img_a, img_b = _images(2)
    for image_b, mode in ((img_b, "interp"), (None, "repeat")):
        cap = Capture()
        jax_backend._jitted = {(2, 7.5, 1.0, mode): cap}
        jax_backend.get_image(img_a, "", steps=2, image_b=image_b)
        got = backend.request_video(img_a, image_b).numpy()
        assert got.shape == cap.video.shape == (1, 4, 32, 32, 3)
        np.testing.assert_allclose(got, cap.video, rtol=0, atol=1e-5)


def test_gradio_gate_raises_without_gradio():
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="gradio"):
        serve.build_gradio_app(object())


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.Image2Video(device="cuda")
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--device", "cuda"])
