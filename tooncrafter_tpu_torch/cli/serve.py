"""The serving backend of the PyTorch port (tooncrafter_tpu/cli/serve.py).

``Image2Video`` is the model-resident counterpart of the reference's
gradio backend (``scripts/gradio/i2v_test_application.py``): the model is
built once on the card and stays there, and a request moves only its two
input frames to the card and its clip back. One ``Pipeline`` is kept per
(steps, cfg_scale, eta, mode). ``build_gradio_app`` is the reference's
Blocks UI, import-gated: the backend works without gradio.

    python -m tooncrafter_tpu_torch.cli.serve --config \\
        configs/inference_512_v1.0.yaml [--ckpt_path ...] [--bpe_path ...] \\
        [--port 7860] [--device cpu]

It runs on one CUDA device (bf16) and refuses to start without one unless
``--device cpu`` is passed (fp32). Each request's noise comes from its own
generator on the model's device, seeded from (seed, 0) as the inference
CLI seeds a clip (``utils/rngs.per_item_generators``); torch's streams are
not the TPU package's, so a seed gives another clip than there.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from tooncrafter_tpu_torch.cli import resolve_device


class Image2Video:
    def __init__(self, ckpt_path: Optional[str] = None,
                 config_path: Optional[str] = None,
                 bpe_path: Optional[str] = None,
                 result_dir: str = "./gradio_results",
                 resolution=(320, 512), video_length: int = 16,
                 device: str = "cuda"):
        from tooncrafter_tpu_torch.cli.inference import build_model
        from tooncrafter_tpu_torch.utils.tokenizer import ClipTokenizer

        self.device = resolve_device(device)
        self.model = build_model(config_path, ckpt_path, resolution[0],
                                 resolution[1], video_length, 0, self.device)
        self.cfg = self.model.config
        self.resolution = tuple(resolution)
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)
        if bpe_path:
            self.tokenizer = ClipTokenizer(bpe_path=bpe_path)
        else:
            warnings.warn(
                "no bpe_path: prompts will be IGNORED (zero tokens for both "
                "cond and uncond) - smoke mode only", stacklevel=2)
            self.tokenizer = None
        self._pipelines = {}
        self._served = 0
        self.last_clip: Optional[np.ndarray] = None

    def _pipeline(self, steps: int, cfg_scale: float, eta: float,
                  mode: str = "interp"):
        from tooncrafter_tpu_torch.models.diffusion import Pipeline
        from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig

        key = (steps, cfg_scale, eta, mode)
        if key not in self._pipelines:
            self._pipelines[key] = Pipeline(
                self.model, ddim_steps=steps, eta=eta,
                guidance=GuidanceConfig(cfg_scale=cfg_scale,
                                        guidance_rescale=0.7),
                mode=mode)
        return self._pipelines[key]

    def request_video(self, image_a: np.ndarray,
                      image_b: Optional[np.ndarray] = None) -> torch.Tensor:
        """(H, W, 3) uint8 RGB frames -> the (1, T, h, w, 3) clip in [-1, 1]
        on the model's device: each frame resized and center-cropped, the
        first held for the first half, the second (or the first again) for
        the rest."""
        from tooncrafter_tpu_torch.ops.resize import center_crop_resize

        h, w = self.resolution
        t = self.cfg.video_length

        def prep(img):
            x = torch.as_tensor(np.asarray(img), dtype=torch.float32,
                                device=self.device) / 127.5 - 1.0
            return center_crop_resize(x[None], h, w)

        fa = prep(image_a)
        fb = prep(image_b) if image_b is not None else fa
        half = t // 2
        return torch.cat([fa.expand(half, h, w, 3),
                          fb.expand(t - half, h, w, 3)])[None]

    def get_image(self, image_a: np.ndarray, prompt: str,
                  steps: int = 50, cfg_scale: float = 7.5, eta: float = 1.0,
                  fs: int = 10, seed: int = 123,
                  image_b: Optional[np.ndarray] = None) -> str:
        """image_a, image_b: (H, W, 3) uint8 RGB; ``"interp"`` between them,
        or ``"repeat"`` of image_a without image_b. Returns the clip's
        path (an mp4, or a folder of PNG frames without OpenCV)."""
        from tooncrafter_tpu_torch.utils import rngs as R
        from tooncrafter_tpu_torch.utils.video_io import write_video

        t0 = time.time()
        dev = self.device
        interp = image_b is not None
        video = self.request_video(image_a, image_b)
        if self.tokenizer is not None:
            tokens = torch.as_tensor(np.asarray(self.tokenizer([prompt])),
                                     device=dev)
            null_tokens = torch.as_tensor(np.asarray(self.tokenizer([""])),
                                          device=dev)
        else:
            tokens = torch.zeros((1, 77), dtype=torch.long, device=dev)
            null_tokens = tokens
        pipe = self._pipeline(int(steps), float(cfg_scale), float(eta),
                              mode="interp" if interp else "repeat")
        out = pipe(video, tokens, null_tokens,
                   torch.full((1,), float(fs), device=dev),
                   generator=R.per_item_generators(seed, [0], dev))
        self.last_clip = out[0].float().cpu().numpy()
        self._served += 1
        name = f"i2v_{int(time.time())}_{self._served}.mp4"
        path = write_video(os.path.join(self.result_dir, name),
                           self.last_clip, fps=8)
        print(f"request served in {time.time() - t0:.2f}s -> {path}")
        return path


def build_gradio_app(backend: Image2Video):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed; the Image2Video "
                           "backend works standalone") from e

    with gr.Blocks() as demo:
        gr.Markdown("## ToonCrafter (PyTorch, CUDA) - cartoon interpolation")
        with gr.Row():
            img_a = gr.Image(label="start frame")
            img_b = gr.Image(label="end frame")
        prompt = gr.Textbox(label="prompt")
        with gr.Row():
            steps = gr.Slider(1, 60, value=50, step=1, label="DDIM steps")
            cfg = gr.Slider(1.0, 15.0, value=7.5, step=0.5, label="CFG")
            eta = gr.Slider(0.0, 1.0, value=1.0, step=0.1, label="ETA")
            fs = gr.Slider(5, 20, value=10, step=1, label="FS")
            seed = gr.Slider(0, 50000, value=123, step=1, label="seed")
        out = gr.Video(label="result")
        btn = gr.Button("Generate")
        btn.click(
            fn=lambda a, p, s, c, e, f, sd, b: backend.get_image(
                a, p, int(s), float(c), float(e), int(f), int(sd), b),
            inputs=[img_a, prompt, steps, cfg, eta, fs, seed, img_b],
            outputs=[out])
        demo.queue(max_size=12)
    return demo


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--bpe_path", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="cuda (one card, bf16) or cpu (fp32)")
    args = p.parse_args(argv)
    backend = Image2Video(args.ckpt_path, args.config, args.bpe_path,
                          device=args.device)
    app = build_gradio_app(backend)
    app.launch(server_port=args.port)


if __name__ == "__main__":
    main()
