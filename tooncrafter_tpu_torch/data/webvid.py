"""WebVid-style video-clip dataset and a threaded prefetching loader
(tooncrafter_tpu/data/webvid.py, with the same semantics):

  * CSV metadata read with the ``csv`` module (columns ``videoid``,
    ``page_dir``, ``name``); videos at ``{data_dir}/{page_dir}/{videoid}.mp4``;
  * a random frame stride in [1, frame_stride] with ``random_fs``, shrunk
    until the clip fits the video;
  * skip-and-retry over the table on unreadable or short videos;
  * resize to cover, center crop, normalize to [-1, 1] by the native host
    preprocessing (``tooncrafter_tpu_torch.native``: bilinear, threaded
    over frames, the JAX dataset's default path; built at first use);
  * a sample is {'video': (T,H,W,3) float32, 'caption', 'path', 'fps',
    'frame_stride'}.

``PrefetchLoader`` decodes on worker threads while the card trains,
reshuffles every epoch from (seed, epoch), and gives each host a disjoint
shard of every epoch.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from tooncrafter_tpu_torch import native
from tooncrafter_tpu_torch.utils import video_io


class WebVidDataset:
    def __init__(self, meta_path: str, data_dir: str, video_length: int = 16,
                 frame_stride: int = 6, resolution=(320, 512),
                 random_fs: bool = True, fps_max: Optional[float] = None,
                 fixed_fps: Optional[float] = None, seed: int = 0):
        with open(meta_path, newline="") as f:
            self.meta = list(csv.DictReader(f))
        self.data_dir = data_dir
        self.video_length = video_length
        self.frame_stride = frame_stride
        self.random_fs = random_fs
        self.resolution = tuple(resolution)
        self.fps_max = fps_max
        self.fixed_fps = fixed_fps
        self.seed = seed
        # random.Random is not thread-safe and the loader calls __getitem__
        # from several threads: each thread gets its own stream
        self._tls = threading.local()

    @property
    def rng(self) -> random.Random:
        r = getattr(self._tls, "rng", None)
        if r is None:
            r = random.Random(f"{self.seed}:{threading.get_ident()}")
            self._tls.rng = r
        return r

    def __len__(self):
        return len(self.meta)

    def _path(self, row) -> str:
        return os.path.join(self.data_dir, str(row["page_dir"]),
                            f"{row['videoid']}.mp4")

    def __getitem__(self, index: int) -> Dict:
        # built (or refused) here, not inside the retries of a bad sample
        native.library()
        for _ in range(20):  # advance through the table on bad samples
            row = self.meta[index % len(self.meta)]
            path = self._path(row)
            try:
                meta = video_io.video_metadata(path)
                n = meta["frames"]
                fs = (self.rng.randint(1, self.frame_stride)
                      if self.random_fs else self.frame_stride)
                required = fs * (self.video_length - 1) + 1
                while required > n and fs > 1:  # shrink the stride to fit
                    fs -= 1
                    required = fs * (self.video_length - 1) + 1
                if required > n:
                    raise ValueError(f"too short: {n} frames")
                start = self.rng.randint(0, n - required)
                frames = video_io.read_video_frames(
                    path, list(range(start, start + required, fs)))
                video = native.preprocess_clip(frames, *self.resolution)
                fps = (meta["fps"] / fs if self.fixed_fps is None
                       else self.fixed_fps)
                if self.fps_max:
                    fps = min(fps, self.fps_max)
                return {"video": video, "caption": str(row.get("name", "")),
                        "path": path, "fps": np.float32(fps),
                        "frame_stride": np.int32(fs)}
            except Exception:
                index += 1
        raise RuntimeError("20 consecutive unreadable samples")


class PrefetchLoader:
    """Thread-pooled shuffling batch loader with bounded prefetch; a last
    batch short of ``batch_size`` is dropped.

    ``shard=(index, count)`` gives each training host a disjoint slice of
    every epoch: all hosts shuffle the full table with the same (seed,
    epoch) stream, keep ``order[index::count]`` and cut every shard to the
    common length, so each host yields as many batches."""

    def __init__(self, dataset, batch_size: int, tokenizer=None,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 0,
                 shard=None):
        self.ds = dataset
        self.bs = batch_size
        self.tokenizer = tokenizer
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        index, count = (0, 1) if shard is None else shard
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} not in [0, {count})")
        self.shard_index = int(index)
        self.shard_count = int(count)
        self._epoch = 0

    def _collate(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        batch = {
            "video": np.stack([s["video"] for s in samples]),
            "fs": np.stack([s["frame_stride"] for s in samples]),
            "fps": np.stack([s["fps"] for s in samples]),
            "captions": [s["caption"] for s in samples],
        }
        if self.tokenizer is not None:
            batch["tokens"] = np.asarray(self.tokenizer(batch["captions"]))
            batch["null_tokens"] = np.tile(np.asarray(self.tokenizer([""])),
                                           (len(samples), 1))
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.ds)))
        random.Random(f"{self.seed}:{self._epoch}").shuffle(order)
        self._epoch += 1
        if self.shard_count > 1:
            common = len(order) // self.shard_count
            order = order[self.shard_index::self.shard_count][:common]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        lock = threading.Lock()
        cursor = [0]

        def worker():
            while not stop.is_set():
                with lock:
                    i = cursor[0]
                    if i + self.bs > len(order):
                        break
                    cursor[0] += self.bs
                try:
                    q.put(self._collate([self.ds[j]
                                         for j in order[i:i + self.bs]]))
                except Exception as exc:  # surface loader errors
                    q.put(exc)
                    break
            q.put(None)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < len(threads):
                item = q.get()
                if item is None:
                    finished += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
