"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by name
from BENCHMARK.json (``benchmark/harness/core.py``). Needs a CUDA device:
without one, or with fewer than the cell asks for, it exits with 2 and
prints no result. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones, read from one more request (or pair of
steps) profiled after the measured window.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a traffic loop is given."""

    config: dict
    mix: dict
    seed: int
    seconds: float
    traced: bool
    device: str
    t_start: float

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return torch.cuda.max_memory_allocated()

    def empty_cache(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def fp32(self):
        """float32 products without TF32, for the reference."""
        import torch
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def config_for(man: dict, cell: dict, mix: dict) -> dict:
    """The cell's model sizes: the configuration's ``model`` with the
    entries of the section the traffic names (``overrides``), as a
    training YAML changes the inference one's."""
    c = core.config_of(man, cell["config"])
    return {**c["model"], **c.get(mix.get("overrides", ""), {})}


def run_cell(args, device: str, t_start: float, config=None,
             mix_changes=None) -> tuple:
    """(Run, manifest): the cell's loop driven once on ``device``;
    ``config`` replaces the cell's configuration and ``mix_changes``
    entries of its traffic (a test's small model and few steps)."""
    man = core.manifest()
    cell = core.cell_of(man, args.workload)
    mix = {**core.mix_of(cell), **(mix_changes or {})}
    cfg = config if config is not None else config_for(man, cell, mix)
    ctx = Context(cfg, mix, args.seed, args.seconds, bool(args.trace),
                  device, t_start)
    run = core.traffic_loop(mix["kind"]).run(ctx)
    return run, man


def main(argv=None) -> int:
    t_start = core.process_start()
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton"))
    import torch

    man = core.manifest()
    cell = core.cell_of(man, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        core.log(f"needs {cell['chips']} CUDA device(s); found {found}")
        return 2
    run, man = run_cell(args, "cuda", t_start)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"modules of JAX or the JAX package loaded: {bad}")
        return 3
    line = core.result(run, man, args.workload, bool(args.trace),
                       core.device_record(run, bool(args.trace)))
    core.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
