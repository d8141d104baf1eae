"""The port's ModelConfig and YAML reader against tooncrafter_tpu's: the
same field names and defaults (``tiny()`` included), and the same values
read from every shipped YAML. ``compute_dtype`` differs by framework only."""

import dataclasses
import glob
import os

import pytest

from tooncrafter_tpu.config import model_config_from_yaml as jax_from_yaml
from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu_torch.config import ModelConfig, model_config_from_yaml
import torch  # noqa: E402

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "compute_dtype"}


def test_fields_and_defaults_equal_jax():
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert _values(ModelConfig()) == _values(JaxConfig())
    assert _values(ModelConfig().tiny()) == _values(JaxConfig().tiny())


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yaml"))))
def test_yaml_reader_equals_jax(path):
    assert _values(model_config_from_yaml(path)) == _values(
        jax_from_yaml(path))


def test_unknown_targets_raise():
    from tooncrafter_tpu_torch.config import model_config_from_dict
    with pytest.raises(ValueError, match="model target"):
        model_config_from_dict({"model": {"target": "x.Y"}})
