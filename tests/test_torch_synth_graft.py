"""The port's fan-in-scaled fill (tooncrafter_tpu_torch.utils.synth) and its
graft entry (tooncrafter_tpu_torch.graft_entry) on the CPU.

  * ``synth_`` on the tiny model equals the JAX package's ``synth_params``
    on the tiny model's parameter shapes, carried to the port's state dict
    by ``utils.weights.from_jax_params``, tensor for tensor and bit for bit
    (bf16 values; the norms kept fp32).
  * ``entry("meta")`` evaluates one UNet forward at the JAX entry's config
    on fake tensors: the (2, 16, 40, 64, 4) latent, as the JAX entry's
    ``jax.eval_shape`` gives.
  * ``dryrun_multidevice(4, "cpu")`` runs on the JAX dry run's (2, 2) mesh
    (a model axis of 2 at four ranks): the UNet's transformer blocks
    sharded, its line printed with finite values.
"""

import math
import re

import jax
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.utils.synth import synth_params
from tooncrafter_tpu_torch import graft_entry
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.utils.synth import synth_
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def test_synth_matches_the_jax_fill():
    jm = JaxToonCrafter(JaxConfig().tiny())
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    ref = from_jax_params(synth_params(shapes), ModelConfig().tiny())
    pm = synth_(ToonCrafter(ModelConfig().tiny()))
    got = pm.state_dict()
    norms = {f"{m}.{n}" for m, mod in pm.named_modules()
             if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm))
             for n, _ in mod.named_parameters()}
    assert set(got) == set(ref) and norms
    for k, r in ref.items():
        assert torch.equal(got[k].float(), r), k
        want = torch.float32 if k in norms else torch.bfloat16
        assert got[k].dtype == want, (k, got[k].dtype)
    # the layouts where torch's fan-in is not shape[:-1]
    unet = pm.unet
    conv = unet.input_blocks[0][0]
    assert torch.equal(conv.weight.float(), torch.full_like(
        conv.weight.float(), float(torch.tensor(
            0.5 / conv.weight[0].numel(), dtype=torch.bfloat16))))


def test_entry_on_fake_tensors_gives_the_latent():
    fn, args = graft_entry.entry("meta")
    out = fn(*args)
    assert tuple(out.shape) == (2, 16, 40, 64, 4)
    assert args[0].dtype == torch.bfloat16


def test_dryrun_multidevice_on_four_ranks_shards_the_model(capsys):
    vals = graft_entry.dryrun_multidevice(4, "cpu")
    line = capsys.readouterr().out
    assert re.search(r"dryrun_multidevice OK on 4 ranks \(mesh \{'data': 2, "
                     r"'model': 2\}", line), line
    assert vals["mesh"] == {"data": 2, "model": 2}
    for k in ("loss", "val", "val_ema", "decode_checksum"):
        assert f"{k}=" in line and math.isfinite(vals[k]), (k, line)
