"""The port's own copies of the framework-free helpers against the JAX
package's originals: the checkpoint mapping tables (every key, path and
layout transform), the CLIP tokenizer, and the checkpoint loader."""

import os

import numpy as np
import pytest
import torch

from tooncrafter_tpu import config as jax_config
from tooncrafter_tpu.utils import checkpoint as jax_ckpt
from tooncrafter_tpu.utils.tokenizer import ClipTokenizer as JaxTokenizer
from tooncrafter_tpu_torch import config as port_config
from tooncrafter_tpu_torch.utils import checkpoint as ckpt
from tooncrafter_tpu_torch.utils.tokenizer import ClipTokenizer

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGES = os.path.join(REPO, "tests", "goldens", "clip_bpe_merges.txt")


def _configs(which):
    if which == "tiny":
        from tooncrafter_tpu.models.diffusion import ModelConfig
        return ModelConfig().tiny(), port_config.ModelConfig().tiny()
    path = os.path.join(REPO, "configs", which)
    return (jax_config.model_config_from_yaml(path),
            port_config.model_config_from_yaml(path))


@pytest.mark.parametrize("which", ["tiny", "inference_512_v1.0.yaml"])
@pytest.mark.parametrize("dualref", [True, False])
def test_full_mapping_equals_the_jax_package(which, dualref):
    jcfg, pcfg = _configs(which)
    want = jax_ckpt.full_mapping(jcfg, dualref=dualref)
    got = ckpt.full_mapping(pcfg, dualref=dualref)
    assert list(got) == list(want)
    w = np.arange(2 * 3 * 3 * 5 * 7, dtype=np.float32)
    shapes = {1: (7,), 2: (5, 7), 3: (5, 7, 1), 4: (5, 7, 3, 3),
              5: (5, 7, 3, 1, 1)}
    for tower in want:
        assert [(p, k) for p, k, _ in got[tower]] == \
            [(p, k) for p, k, _ in want[tower]], tower
        for (_, key, fn_p), (_, _, fn_j) in zip(got[tower], want[tower]):
            assert fn_p.__name__ == fn_j.__name__, key
    # each transform moves the same axes as the JAX package's
    for name in ("t_linear", "t_conv2d", "t_conv1x1", "t_conv1d1",
                 "t_conv3d", "t_none"):
        for shape in shapes.values():
            x = w[:int(np.prod(shape))].reshape(shape)
            try:
                ref = getattr(jax_ckpt, name)(x)
            except (ValueError, IndexError):
                continue
            np.testing.assert_array_equal(getattr(ckpt, name)(x), ref)


def test_tokenizer_copy_matches_the_jax_package():
    texts = ["A cartoon fox jumps over the moon!",
             "  two   frames,  one&amp;clip  ", "Ünïcode — 42 ways",
             "x" * 400, ""]
    np.testing.assert_array_equal(ClipTokenizer(bpe_path=MERGES)(texts),
                                  JaxTokenizer(bpe_path=MERGES)(texts))


def test_tokenizer_names_regex_when_it_is_missing(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_regex(name, *a, **k):
        if name == "regex":
            raise ImportError("No module named 'regex'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_regex)
    with pytest.raises(ImportError, match="'regex' package"):
        ClipTokenizer(bpe_path=MERGES)


def test_load_torch_state_dict_reads_each_dialect(tmp_path):
    w = torch.arange(6, dtype=torch.float16).reshape(2, 3)
    for name, obj in (
            ("lightning", {"state_dict": {"model.framestride_embed.w": w}}),
            ("deepspeed", {"module": {"_forward_module.model."
                                      "framestride_embed.w": w}}),
            ("plain", {"model.fps_embedding.w": w})):
        path = tmp_path / f"{name}.ckpt"
        torch.save(obj, path)
        sd = ckpt.load_torch_state_dict(str(path))
        assert list(sd) == ["model.fps_embedding.w"], name
        assert sd["model.fps_embedding.w"].dtype == torch.float32
        torch.testing.assert_close(sd["model.fps_embedding.w"], w.float())
        jsd = jax_ckpt.load_torch_state_dict(str(path))
        np.testing.assert_array_equal(sd["model.fps_embedding.w"].numpy(),
                                      jsd["model.fps_embedding.w"])
