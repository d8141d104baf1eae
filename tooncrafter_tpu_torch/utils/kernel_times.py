"""Phase-2 cases of a few kernels, checked against their plain versions and
timed, without the rest of ``chip_smoke.py``: a quick look at one kernel
family, or two checkouts in turns on one card.

    python -m tooncrafter_tpu_torch.utils.kernel_times [--kernels tpair,tattn]
        [--shapes '{"tpair": [["1024 init_attn", 9216, 512]]}']

``--kernels``: any of ``tpair`` (``kernel_check.TPAIR_512`` and
``TPAIR_1024``), ``tattn`` (``TATTN_512``), ``ff`` (``FF_512``), ``gn``
(the one-pass GroupNorm, ``GN_512`` and ``GN_L2``), ``sums`` (the
channel sums, ``STATS_512``), ``ptc`` (the T-attention core,
``PTC_512``) and ``dual`` (the dual cross-attention, ``ATTN2_512``);
``--shapes`` replaces a family's shapes by (label, P, C) or (label, N, C)
rows, (label, [N, HW, C], silu) for ``gn``, (label, [N, S, C], count) for
``sums``, (label, T, P, inner, heads) for ``ptc``, (label, Sq, C) for
``dual``. Each line: the case's check (``ok``) and its mean device time over 20
warm calls (CUDA events). The package comes from the working directory, so
running this file from another checkout's root (``cd DIR && python
PATH/kernel_times.py``) times that checkout's kernels with its own
``kernel_check``. Needs a CUDA device; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="tpair,tattn,ff")
    ap.add_argument("--shapes", default="{}")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    from tooncrafter_tpu_torch.utils import kernel_check as kc

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the GPU",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kc.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {k: tuple(tuple(row) for row in v)
              for k, v in json.loads(args.shapes).items()}
    families = {
        "tpair": lambda: kc.tpair_cases(dev, gen, shapes.get(
            "tpair", kc.TPAIR_512 + kc.TPAIR_1024)),
        "tattn": lambda: kc.tattn_cases(dev, gen, shapes.get(
            "tattn", kc.TATTN_512)),
        "ff": lambda: kc.ff_cases(dev, gen, shapes.get("ff", kc.FF_512)),
        "gn": lambda: kc.gn_cases(dev, gen, shapes["gn"] if "gn" in shapes
                                  else kc.GN_512 + kc.GN_L2),
        "sums": lambda: kc.stats_cases(dev, gen, shapes.get(
            "sums", kc.STATS_512)),
        "ptc": lambda: kc.ptc_cases(dev, gen, shapes.get("ptc",
                                                          kc.PTC_512)),
        "dual": lambda: kc.dual_cases(dev, gen, shapes.get(
            "dual", kc.ATTN2_512)),
    }
    with kc.fp32_reference():
        for name in args.kernels.split(","):
            for case in families[name]():
                row = kc.run_case(case, None, timed=False)
                ms = kc.cuda_ms(case.kernel, 20)
                print(f"{case.name} {case.label}: ms={ms:.4f} "
                      f"ok={row['ok']}", flush=True)
                del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
