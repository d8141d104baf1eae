"""The small model and short traffic the CPU tests run the harness at:
configs/tiny_smoke.yaml (every tower shrunk, the 512 model's topology)."""

import dataclasses
import time

import torch

from benchmark import run as R
from benchmark.harness import core

MIX = {"ddim_steps": 4}


def config() -> dict:
    from tooncrafter_tpu_torch.config import model_config_from_yaml

    c = model_config_from_yaml(str(core.ROOT / "configs" / "tiny_smoke.yaml"))
    out = {}
    for f in dataclasses.fields(c):
        if f.name != "compute_dtype":
            v = getattr(c, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


TRAINING = {"use_checkpoint": True, "remat_policy": "dots"}


def config_for(cell: str) -> dict:
    """The tiny model, with the training YAML's remat where the cell
    trains."""
    mix = core.mix_of(core.cell_of(core.manifest(), cell))
    return {**config(), **(TRAINING if mix["kind"] == "train" else {})}


def context(cell: str, seed: int = 4294967311, **mix) -> R.Context:
    man = core.manifest()
    m = {**core.mix_of(core.cell_of(man, cell)), **MIX, **mix}
    return R.Context(config_for(cell), m, seed, 0.5, False, "cpu",
                     time.monotonic())


def run(cell: str, seed: int = 4294967311, trace: int = 0, **mix):
    torch.set_num_threads(1)
    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    "0.5", "--trace", str(trace)])
    return R.run_cell(args, "cpu", time.monotonic(), config=config_for(cell),
                      mix_changes={**MIX, **mix})
