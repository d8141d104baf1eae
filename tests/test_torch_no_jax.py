"""The PyTorch port stands without JAX, and its CUDA wrappers never fall
back to a plain version for a tensor that is not on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops import cross_attention as ca
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import stats as st
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops import temporal_conv as tc
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A meta-path finder makes jax, flax and the JAX package unimportable, then
# every module of the port is imported (the CLIs, the serving backend and
# the inference-side modules included), the tiny pipeline runs, a tiny
# training step runs and the training CLI's dry run starts.
_NO_JAX = """
import importlib
import os
import pkgutil
import sys
import tempfile

BLOCKED = ("jax", "flax", "tooncrafter_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import torch
import tooncrafter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tooncrafter_tpu_torch.__path__, "tooncrafter_tpu_torch.")]
for want in ("cli.inference", "cli.train", "training.trainer",
             "training.checkpoints", "training.callbacks",
             "training.lr_schedule", "training.optim", "data.webvid",
             "cli.serve",
             "cli.smoke", "sampling.ddpm", "models.lpips",
             "utils.metrics", "parallel.mesh", "parallel.serving",
             "parallel.tensor",
             "utils.synth", "graft_entry", "native"):
    assert "tooncrafter_tpu_torch." + want in names, names
for name in names:
    importlib.import_module(name)
from tooncrafter_tpu_torch.config import ModelConfig, model_config_from_yaml
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.utils.weights import init_random_
model = ToonCrafter(ModelConfig().tiny()).eval()
init_random_(model, torch.Generator().manual_seed(0))
pipe = Pipeline(model, ddim_steps=1)
out = pipe(torch.zeros(1, 4, 32, 32, 3), torch.zeros(1, 77, dtype=torch.long),
           torch.zeros(1, 77, dtype=torch.long), torch.full((1,), 10.0),
           generator=torch.Generator().manual_seed(0))
assert out.shape == (1, 4, 32, 32, 3) and torch.isfinite(out).all()
assert model_config_from_yaml("configs/inference_512_v1.0.yaml").perframe_ae
from tooncrafter_tpu_torch.cli import train as train_cli
from tooncrafter_tpu_torch.training import trainer as T
tcfg = T.TrainConfig()
state, opt = T.make_train_state(model, tcfg, use_ema=True)
batch = {"video": torch.zeros(1, 4, 32, 32, 3),
         "tokens": torch.zeros(1, 77, dtype=torch.long),
         "null_tokens": torch.zeros(1, 77, dtype=torch.long),
         "fs": torch.full((1,), 10.0), "fps": torch.full((1,), 8.0)}
state, metrics = T.make_train_step(model, opt, tcfg)(
    state, batch, torch.Generator().manual_seed(0))
assert state.step == 1 and torch.isfinite(metrics["loss"])
with tempfile.TemporaryDirectory() as tmp:
    import yaml
    raw = yaml.safe_load(open("configs/tiny_smoke.yaml"))
    meta = os.path.join(tmp, "meta.csv")
    open(meta, "w").write("videoid,page_dir,name\\n")
    raw["data"] = {"params": {"train": {"params": {"meta_path": meta}}}}
    cfg = os.path.join(tmp, "train.yaml")
    yaml.safe_dump(raw, open(cfg, "w"))
    train_cli.main(["--config", cfg, "--logdir", tmp, "--device", "cpu"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), (
        r.stdout[-2000:], r.stderr[-3000:])


_FORBIDDEN = ("import jax", "from jax", "import flax", "from flax",
              "import tooncrafter_tpu ", "import tooncrafter_tpu.",
              "import tooncrafter_tpu,", "from tooncrafter_tpu.",
              "from tooncrafter_tpu import")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    pkg = os.path.join(REPO, "tooncrafter_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_import_no_jax():
    for path in _port_sources():
        for line in open(path):
            # the trailing space lets "import tooncrafter_tpu " match a
            # bare import while "import tooncrafter_tpu_torch" passes
            s = line.strip() + " "
            assert not s.startswith(_FORBIDDEN), (path, line)


@pytest.fixture
def kernel_library_absent(monkeypatch):
    """Treat non-CPU tensors as CUDA tensors and make the kernel build
    fail as it does where nvcc is missing."""
    def no_nvcc(*a, **k):
        raise FileNotFoundError("nvcc not found")
    monkeypatch.setattr(_launch, "is_cuda", lambda t: t.device.type != "cpu")
    for mod in kc.MODULES:
        monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(ta, "_PTC_LIB", None)
    monkeypatch.setattr(_build, "load_library", no_nvcc)
    kc.reset_launch_counts()
    yield
    assert not any(kc.launch_counts().values())


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


def _meta_f32(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.float32)


@pytest.mark.parametrize("call", [
    lambda: fa._flash_mh_packed(_meta(2, 512, 960), 5, 0.125),
    lambda: fa._flash_mh(_meta(2, 160, 128), _meta(2, 160, 128),
                         _meta(2, 160, 128), 2, 0.125),
    lambda: fa._flash_bh_with_lse(_meta(8, 4096, 64), _meta(8, 8192, 64),
                                  _meta(8, 8192, 64), 0.125),
    lambda: fa._flash_bh_single(_meta(1, 2560, 512), _meta(1, 2560, 512),
                                _meta(1, 2560, 512), 512 ** -0.5),
    lambda: fa.flash_attention_packed(_meta(2, 640, 1920), 10),
    lambda: fa.flash_attention(_meta(1, 4096, 8, 64), _meta(1, 8192, 8, 64),
                               _meta(1, 8192, 8, 64)),
    lambda: fa._flash_bwd_bh(*(_meta(2, 160, 64) for _ in range(5)),
                             _meta_f32(2, 160), 0.125),
    lambda: ff.fused_geglu_ff(_meta(64, 320), _meta(2560, 320),
                              _meta(2560), _meta(320, 1280), _meta(320)),
    lambda: tc._pallas_tconv(_meta(2, 4, 64, 64), _meta(64, 3, 64),
                             _meta(64)),
    lambda: sc.winograd_gn_silu_conv3x3(
        _meta(2, 8, 8, 64), _meta_f32(2, 64), _meta_f32(2, 64),
        _meta(64, 64, 3, 3), _meta(64)),
    lambda: sc.winograd24_gn_silu_conv3x3(
        _meta(2, 36, 64, 64), _meta_f32(2, 64), _meta_f32(2, 64),
        _meta(64, 64, 3, 3), _meta(64), _meta(2, 36, 64, 64), True, True),
    lambda: sc._pallas_fused_conv(
        _meta(2, 8, 8, 64), _meta_f32(2, 64), _meta_f32(2, 64),
        _meta(64, 64, 3, 3), _meta(64)),
    lambda: ta._fused_tattn_call(
        _meta(2, 16, 40, 320), (_meta_f32(320), _meta_f32(320),
                                *(_meta(320, 320) for _ in range(4)),
                                _meta(320)), 5, 0.125),
    lambda: ta._ptc_kernel_call(*(_meta(2, 16, 40, 320) for _ in range(3)),
                                5, 0.125),
    lambda: fn._pallas_gn(_meta(2, 8, 8, 64), _meta_f32(64), _meta_f32(64)),
    lambda: ca._dual_kernel_call(_meta(2, 2560, 320), _meta(2, 77, 320),
                                 _meta(2, 77, 320), _meta(2, 16, 320),
                                 _meta(2, 16, 320), 0.7, 5, 0.125),
    lambda: st._pallas_sums(_meta(2, 2560, 320)),
    lambda: st.channel_sums(_meta(2, 16, 16, 128)),
    lambda: fa._flash_mh_ones(_meta(2, 160, 128), _meta(2, 160, 128),
                              _meta(2, 160, 128), 2, 0.125),
])
def test_cuda_wrappers_raise_without_their_kernel(kernel_library_absent,
                                                  call):
    with pytest.raises(FileNotFoundError, match="nvcc"):
        call()


def test_cuda_wrappers_check_their_operands(kernel_library_absent):
    # wrong dtype and misaligned strides are refused before any launch
    with pytest.raises(TypeError, match="bfloat16"):
        fa._flash_mh(*(torch.empty(1, 160, 128, device="meta")
                       for _ in range(3)), 2, 0.125)
    odd = torch.empty(1, 160, 131, device="meta",
                      dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="strides"):
        fa._flash_mh(odd, odd, odd, 2, 0.125)
    with pytest.raises(ValueError, match="CPU tensors"):
        fa._flash_mh(_meta(1, 160, 128), torch.empty(1, 160, 128),
                     _meta(1, 160, 128), 2, 0.125)
    # the kernels of the op functions no model reaches (#17, #18, #5)
    f32 = lambda *shape: torch.empty(*shape, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        fa._flash_mh_ones(f32(1, 160, 128), f32(1, 160, 128),
                          f32(1, 160, 128), 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fa._flash_mh_ones(*(_meta(1, 160, 256) for _ in range(3)), 2, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        ca._dual_kernel_call(f32(1, 128, 128), *(f32(1, n, 128) for n in (
            77, 77, 16, 16)), 0.5, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        ca._dual_kernel_call(_meta(1, 128, 128), *(_meta(1, n, 128) for n in (
            77, 77, 16, 16)), 0.5, 4, 0.125)
    with pytest.raises(ValueError, match="strides"):
        ca._dual_kernel_call(odd, *(_meta(1, n, 128) for n in (
            77, 77, 16, 16)), 0.5, 2, 0.125)
    with pytest.raises(TypeError, match="channel sums"):
        st._pallas_sums(torch.empty(2, 256, 128, device="meta",
                                    dtype=torch.float64))
    with pytest.raises(ValueError, match="C % 8"):
        st._pallas_sums(_meta(2, 256, 12))
