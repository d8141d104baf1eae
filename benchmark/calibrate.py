"""The readings the comparison's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

For each of ``--seeds``: the system under test serves one request of the
cell (its batch, resolution and DDIM steps) with that seed's inputs and
noise, and the numbers of ``check`` are taken against the float32
reference, as a run takes them. For each of ``--control-seeds``: the
control, the reference with fp8 products and a bfloat16 sampler state, is
put in the program's place and judged the same way. One JSON line a seed;
the lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as R  # noqa: E402
from benchmark.harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None,
                   help="a fault planted in the program (training: "
                   "half_batch)")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        core.log("needs a CUDA device")
        return 2
    man = core.manifest()
    cell = core.cell_of(man, a.workload)
    mix = core.mix_of(cell)
    ctx = R.Context(R.config_for(man, cell, mix), mix, 0, 0.0, False,
                    "cuda", time.monotonic())
    out = open(a.out, "a") if a.out else None

    def emit(row):
        line = json.dumps({"workload": a.workload, **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    ints = lambda s: [int(x) for x in s.split(",") if x]
    core.traffic_loop(ctx.mix["kind"]).calibrate(
        ctx, ints(a.seeds), ints(a.control_seeds), emit, a.fault)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
