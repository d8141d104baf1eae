"""Training observability: metric logging, throughput, device memory, and
sampled videos (tooncrafter_tpu/training/callbacks.py).

  * ``MetricLogger``: one JSON object per logged step in
    ``<logdir>/metrics.jsonl``.
  * ``ThroughputTracker``: seconds per step and samples per second.
  * ``device_memory_stats``: bytes in use and the peak, from
    ``torch.cuda.memory_stats`` (empty without a card).
  * ``VideoSampleLogger``: every N steps, the port's ``Pipeline`` on a
    fixed probe batch with the EMA weights, written as mp4.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricLogger:
    def __init__(self, logdir: str, flush_every: int = 20):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._n = 0
        self.flush_every = flush_every

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class ThroughputTracker:
    """Seconds between calls and samples per second."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._t = None

    def step(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._t is not None:
            dt = now - self._t
            out = {"step_time_s": dt, "samples_per_sec": self.batch_size / dt}
        self._t = now
        return out


def device_memory_stats(device=None) -> Dict[str, float]:
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"hbm_bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                                0)),
            "hbm_peak_bytes": float(stats.get("allocated_bytes.all.peak", 0))}


class VideoSampleLogger:
    """Every ``every_steps``: the full sampling pipeline (DDIM, 2-branch
    CFG, the middle-frame splice) on the probe batch's first clip, with the
    EMA weights, written as mp4 (``write``: False samples without writing,
    for the other ranks of a tensor-parallel model group)."""

    def __init__(self, model, logdir: str, every_steps: int = 500,
                 ddim_steps: int = 25, cfg_scale: float = 7.5,
                 write: bool = True):
        self.model = model
        self.dir = os.path.join(logdir, "samples")
        self.write = write
        if write:
            os.makedirs(self.dir, exist_ok=True)
        self.every = every_steps
        self.ddim_steps = ddim_steps
        self.cfg_scale = cfg_scale

    def maybe_log(self, step: int, state, probe_batch,
                  generator: Optional[torch.Generator] = None
                  ) -> Optional[str]:
        if step % self.every != 0:
            return None
        from tooncrafter_tpu_torch.models.diffusion import Pipeline
        from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
        from tooncrafter_tpu_torch.training.trainer import autocast, ema_scope
        from tooncrafter_tpu_torch.utils.video_io import write_video

        b = {k: probe_batch[k][:1] for k in ("video", "tokens", "null_tokens",
                                              "fs")}
        pipe = Pipeline(self.model, ddim_steps=self.ddim_steps,
                        guidance=GuidanceConfig(cfg_scale=self.cfg_scale),
                        mode="repeat",
                        perframe_ae=self.model.config.perframe_ae)
        self.model.eval()
        with ema_scope(state), autocast(self.model, b["video"].device):
            out = pipe(b["video"], b["tokens"], b["null_tokens"],
                       b["fs"].float(), generator=generator)
        if not self.write:
            return None
        path = os.path.join(self.dir, f"step_{step:08d}.mp4")
        return write_video(path, out[0].float().cpu().numpy())
