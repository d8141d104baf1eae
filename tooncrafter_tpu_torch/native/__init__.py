"""The native host preprocessing of the video data path: a threaded C++
library (``preprocess.cpp``, the same source as the JAX package's
``native/``) bound with ctypes.

``preprocess_clip`` resizes each uint8 frame to cover the output by
bilinear sampling, crops its center and maps it to [-1, 1] in fp32;
``to_uint8_clip`` maps [-1, 1] back to uint8, rounding half up. The
library is built at first use with ``g++ -O3 -fPIC -std=c++17 -pthread
-march=native -shared`` (the JAX package's Makefile's flags; ``$CXX``
overrides the compiler) into ``build/native/`` at the root of the checkout,
named by a hash of the source, the flags and the host's CPU (``-march=native``
code runs only where it was built). A failed build raises: there is no
fallback. ``_plain_preprocess`` and ``_plain_to_uint8`` are numpy versions
of the same sampling and rounding in fp32, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-march=native",
         "-shared")

_LIB: Optional[ctypes.CDLL] = None


def _cpu_key() -> bytes:
    """The host's CPU model and feature flags, which ``-march=native``
    compiles for."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            key += "".join(line for line in f
                           if line.startswith(("model name", "flags")))[:4096]
    except OSError:
        pass
    return key.encode()


def lib_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_cpu_key())
    return build_dir / f"libpreprocess_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless it is built already; raise if g++ fails."""
    path = lib_path(source, build_dir)
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        err = proc.stderr[-4000:] if proc.returncode else None
    except OSError as exc:  # no compiler
        err = str(exc)
    if err is not None:
        raise RuntimeError(f"building the native preprocessing failed: "
                           f"{' '.join(cmd)}\n{err}")
    os.replace(tmp, path)
    return path


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.preprocess_clip.argtypes = [vp, i, i, i, vp, i, i, i]
    lib.preprocess_clip.restype = i
    lib.to_uint8_clip.argtypes = [vp, i, i, i, vp, i]
    lib.to_uint8_clip.restype = i
    return lib


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def preprocess_clip(frames: np.ndarray, out_h: int, out_w: int,
                    num_threads: int = 0) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, out_h, out_w, 3) fp32 in [-1, 1]: bilinear
    resize to cover, center crop, normalize; frames over ``num_threads``
    threads (0: every core)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    out = np.empty((t, out_h, out_w, 3), np.float32)
    rc = library().preprocess_clip(
        frames.ctypes.data, t, h, w, out.ctypes.data, out_h, out_w,
        num_threads)
    if rc != 0:
        raise ValueError(f"preprocess_clip refused {frames.shape} -> "
                         f"{(out_h, out_w)}")
    return out


def to_uint8_clip(video: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """(T, H, W, 3) fp32 in [-1, 1] -> uint8, clipped, rounded half up."""
    video = np.ascontiguousarray(video, np.float32)
    t, h, w, _ = video.shape
    out = np.empty(video.shape, np.uint8)
    rc = library().to_uint8_clip(video.ctypes.data, t, h, w,
                                          out.ctypes.data, num_threads)
    if rc != 0:
        raise ValueError(f"to_uint8_clip refused {video.shape}")
    return out


def _axis(n_out: int, n_src: int, inv, off):
    """Source indices and weights of one axis, in fp32 as the library."""
    s = np.arange(n_out, dtype=np.float32) * inv + off
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_src - 1)
    i1 = np.minimum(n_src - 1, i0 + 1)
    f = np.clip(s - i0.astype(np.float32), np.float32(0), np.float32(1))
    return i0, i1, f.astype(np.float32)


def _plain_preprocess(frames: np.ndarray, out_h: int,
                      out_w: int) -> np.ndarray:
    """The library's sampling in numpy fp32 (half-pixel centers, edge
    clamped): the plain version of ``preprocess_clip``."""
    f32 = np.float32
    t, sh, sw, _ = frames.shape
    scale = max(f32(out_h) / f32(sh), f32(out_w) / f32(sw))
    inv = f32(1) / scale
    half = f32(0.5)
    y_off = (f32(sh) - f32(out_h) * inv) * half + half * inv - half
    x_off = (f32(sw) - f32(out_w) * inv) * half + half * inv - half
    y0, y1, fy = _axis(out_h, sh, inv, y_off)
    x0, x1, fx = _axis(out_w, sw, inv, x_off)
    src = frames.astype(f32)
    fx, fy = fx[None, None, :, None], fy[None, :, None, None]
    top = src[:, y0][:, :, x0] * (f32(1) - fx) + src[:, y0][:, :, x1] * fx
    bot = src[:, y1][:, :, x0] * (f32(1) - fx) + src[:, y1][:, :, x1] * fx
    v = top * (f32(1) - fy) + bot * fy
    return (v * (f32(1) / f32(127.5)) - f32(1)).astype(f32)


def _plain_to_uint8(video: np.ndarray) -> np.ndarray:
    v = (np.clip(video.astype(np.float32), -1, 1) + np.float32(1)) \
        * np.float32(127.5)
    return np.minimum(v + np.float32(0.5), np.float32(255)).astype(np.uint8)
