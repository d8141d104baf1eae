"""Where the FF's time goes on the card: its three kernels
(``csrc/fused_ff.cu``: the LayerNorm, the projection with the gate, the
out-GEMM with the bias and residual) at every FF shape of ``kernel_check``
(``FF_512``, ``FF_1024``), each kernel's device time from a torch.profiler
trace of a few calls beside the least time the card could take for its
part, and the whole call's time from CUDA events.

    python -m tooncrafter_tpu_torch.utils.ff_breakdown

Needs a CUDA device. Prints the card's name and power limit first, then
one line per shape.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict

import torch

# the kernels' names in a trace, and the part each computes
PARTS = (("ln", "ln_kernel"), ("proj", "gemm_kernel<0"),
         ("out", "gemm_kernel<1"))
CALLS = 5


def part_bounds(n: int, c: int, d: int) -> Dict[str, float]:
    """Least ms of each part (LayerNorm + residual, as the UNet calls it):
    each input read once, each output written once, bf16."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    return {
        "ln": kc.bound(0.0, 2.0 * 2 * n * c + 8.0 * c)[0],
        "proj": kc.bound(4.0 * n * c * d,
                         2.0 * (n * c + 2 * d * c + 2 * d + n * d))[0],
        "out": kc.bound(2.0 * n * d * c,
                        2.0 * (n * d + d * c + c + 2 * n * c))[0]}


def device_ms(fn) -> Dict[str, float]:
    """Mean device ms per call of each part over CALLS traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part, _ in PARTS}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", 0.0)
        for part, key in PARTS:
            if key in event.key.replace(" ", ""):
                out[part] += us / CALLS / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the breakdown runs only on the GPU",
              file=sys.stderr)
        return 2
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shapes in (kc.FF_512, kc.FF_1024):
        for label, n, c in shapes:
            case, = kc.ff_cases(dev, gen, ((label, n, c),))
            total = kc.cuda_ms(case.kernel, 20)
            parts = device_ms(case.kernel)
            bounds = part_bounds(n, c, 4 * c)
            print(f"ff_breakdown {label} N={n} C={c}: ms={total:.4f} "
                  + " ".join(f"{p}_ms={parts[p]:.4f} (bound {bounds[p]:.4f})"
                             for p, _ in PARTS), flush=True)
            del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
