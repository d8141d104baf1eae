"""The port's native host preprocessing (tooncrafter_tpu_torch.native)
against the JAX package's (tooncrafter_tpu.native, built by its own
Makefile) and against its numpy plain version, on the CPU.

Both libraries come from the same source with the same flags, so their
outputs are equal bit for bit; the plain version does the same fp32
arithmetic in numpy, to 1e-5 (the compiler may contract a product and a
sum into one rounding). The library is built into the git-ignored
``build/`` and a failed build raises.
"""

import os
import re

import numpy as np
import pytest

from tooncrafter_tpu import native as jnative
from tooncrafter_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "tooncrafter_tpu", "native")

# (T, H, W) -> (out_h, out_w): down, up, cover on either axis, odd sizes
CASES = [((3, 45, 70), (32, 48)), ((2, 20, 24), (40, 40)),
         ((2, 64, 40), (32, 48)), ((1, 31, 17), (9, 13))]


@pytest.fixture(scope="module")
def jax_lib():
    assert jnative.available(), "the JAX package's library did not build"
    return jnative


def test_same_source_and_flags():
    assert open(native.SOURCE, "rb").read() == open(
        os.path.join(JAX_NATIVE, "preprocess.cpp"), "rb").read()
    make = open(os.path.join(JAX_NATIVE, "Makefile")).read()
    flags = re.search(r"CXXFLAGS \?= (.*)", make).group(1).split()
    assert "-shared" in make and tuple(flags + ["-shared"]) == native.FLAGS
    path = native.lib_path()
    assert os.path.relpath(path, REPO).startswith("build" + os.sep)
    assert "build/" in open(os.path.join(REPO, ".gitignore")).read().split()


@pytest.mark.parametrize("shape,out", CASES)
def test_preprocess_equals_the_jax_library_and_the_plain_version(
        jax_lib, shape, out):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    got = native.preprocess_clip(frames, *out)
    assert got.shape == (shape[0],) + out + (3,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_lib.preprocess_clip(frames, *out))
    np.testing.assert_allclose(got, native._plain_preprocess(frames, *out),
                               rtol=0, atol=1e-5)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_to_uint8_equals_the_jax_library_and_the_plain_version(jax_lib):
    v = np.random.default_rng(5).uniform(-1.3, 1.3, (3, 5, 7, 3)).astype(
        np.float32)
    v[0, 0, 0] = (-1.0, 1.0, 0.0)
    got = native.to_uint8_clip(v)
    np.testing.assert_array_equal(got, jax_lib.to_uint8_clip(v))
    np.testing.assert_array_equal(got, native._plain_to_uint8(v))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native preprocessing"):
        native.build(native.SOURCE, tmp_path / "build")


def test_the_data_path_takes_the_library_not_cv2():
    src = open(os.path.join(REPO, "tooncrafter_tpu_torch", "data",
                            "webvid.py")).read()
    assert "cv2" not in src and "native.preprocess_clip" in src
