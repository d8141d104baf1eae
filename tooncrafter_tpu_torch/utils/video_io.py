"""Host-side video and image I/O of the port's CLI.

OpenCV (``cv2``) writes and reads mp4; without it a clip is written as PNG
frames, through Pillow where it is installed, else by the standard
library's ``zlib`` (``png_bytes``). Images are read with Pillow. Both are
imported only when a function needs them, so the package imports without
either: the CLI needs Pillow to read its input images, and writes its
clips with neither.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _require_cv2(what: str):
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError(f"{what} needs OpenCV (cv2), which is not "
                           "installed")
    return cv2


def to_uint8(video: np.ndarray) -> np.ndarray:
    """(T,H,W,3) float in [-1,1] -> uint8 RGB (NaN-safe)."""
    v = np.nan_to_num(np.asarray(video, np.float32), nan=0.0,
                      posinf=1.0, neginf=-1.0)
    v = np.clip(v, -1.0, 1.0)
    return ((v + 1.0) * 127.5).astype(np.uint8)


def write_video(path: str, video: np.ndarray, fps: int = 8) -> str:
    """video: (T,H,W,3) float [-1,1] or uint8 RGB. Writes mp4 (falls back
    to per-frame PNGs if no codec is available). Returns the written path."""
    if video.dtype != np.uint8:
        video = to_uint8(video)
    t, h, w, _ = video.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None:
        for fourcc_name in ("avc1", "mp4v"):
            fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
            vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
            if vw.isOpened():
                for frame in video:
                    vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                vw.release()
                return path
            vw.release()
    base = os.path.splitext(path)[0]
    os.makedirs(base, exist_ok=True)
    for i, frame in enumerate(video):
        _write_png(os.path.join(base, f"frame_{i:04d}.png"), frame)
    return base


def png_bytes(frame: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB frame as an 8-bit truecolor PNG, each row
    unfiltered, compressed by zlib."""
    h, w, _ = frame.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(frame, np.uint8).reshape(
                               h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _write_png(path: str, frame: np.ndarray):
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(path, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        return
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(png_bytes(frame))
        return
    Image.fromarray(frame).save(path)


def write_video_grid(path: str, videos: np.ndarray, fps: int = 8) -> str:
    """(N,T,H,W,3) batch -> one mp4 with the clips side by side."""
    grid = np.concatenate(list(videos), axis=2)  # stack along width
    return write_video(path, grid, fps=fps)


def read_video_frames(path: str, indices: Optional[Sequence[int]] = None
                      ) -> np.ndarray:
    """Decode selected frames (or all) as (T,H,W,3) uint8 RGB."""
    cv2 = _require_cv2("video decode")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = []
    if indices is None:
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    else:
        for idx in indices:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, f = cap.read()
            if not ok:
                raise IOError(f"cannot read frame {idx} of {path}")
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def video_metadata(path: str):
    cv2 = _require_cv2("video metadata")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    meta = {
        "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        "fps": float(cap.get(cv2.CAP_PROP_FPS)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
    }
    cap.release()
    return meta


def load_image(path: str) -> np.ndarray:
    """-> (H,W,3) float32 in [-1,1]."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return img / 127.5 - 1.0
