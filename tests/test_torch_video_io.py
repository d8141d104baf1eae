"""The port's clip writer where neither OpenCV nor Pillow is installed: the
PNG frames are encoded with the standard library's zlib. Each frame is
decoded here by a reader that uses zlib alone (chunk CRCs, IHDR, the
unfiltered rows) and by Pillow, and must give the clip's uint8 pixels
exactly."""

import os
import struct
import sys
import zlib

import numpy as np
import torch

from tooncrafter_tpu_torch.utils import video_io

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body), kind
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks][0] == b"IHDR" and chunks[-1][0] == b"IEND"
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[0][1])
    assert (depth, color, interlace) == (8, 2, 0)
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()  # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def test_png_frames_without_opencv_or_pillow(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    clip = rng.uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(np.float32)
    want = video_io.to_uint8(clip)
    with monkeypatch.context() as m:
        m.setattr(video_io, "_cv2", lambda: None)
        m.setitem(sys.modules, "PIL", None)
        out = video_io.write_video(str(tmp_path / "clip.mp4"), clip)
    assert out == str(tmp_path / "clip")
    from PIL import Image
    for i in range(3):
        path = os.path.join(out, f"frame_{i:04d}.png")
        np.testing.assert_array_equal(_read_png(path), want[i])
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want[i])
