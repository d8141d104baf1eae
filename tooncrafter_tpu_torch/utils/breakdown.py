"""Where a fused call's time goes on the card: the kernels of one call at
every shape of ``kernel_check``, each kernel's device time from a
torch.profiler trace of a few calls beside the least time the card could
take for its part, and the whole call's time from CUDA events.

    python -m tooncrafter_tpu_torch.utils.breakdown --kernel ff
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel tconv

``ff``: the FF's three kernels (``csrc/fused_ff.cu``: the LayerNorm, the
projection with the gate, the out-GEMM with the bias and residual) at
``FF_512`` and ``FF_1024``. ``tconv``: the temporal conv's two kernels
(``csrc/temporal_conv.cu``: the z pass into the zero-framed buffer, the
three-tap GEMM with its epilogue) at ``TCONV_512`` and ``TCONV_1024``.
Needs a CUDA device. Prints the card's name and power limit first, then
one line per shape.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Dict, Tuple

import torch

# per kernel: its parts, each (name, the kernel's name in a trace)
PARTS = {
    "ff": (("ln", "fused_ff::ln_kernel"), ("proj", "fused_ff::gemm_kernel<0"),
           ("out", "fused_ff::gemm_kernel<1")),
    "tconv": (("zpass", "tconv::zpass_kernel"),
              ("gemm", "tconv::gemm_kernel")),
}
CALLS = 5


def ff_bounds(n: int, c: int, d: int) -> Dict[str, float]:
    """Least ms of each FF part (LayerNorm + residual, as the UNet calls
    it): each input read once, each output written once, bf16."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    return {
        "ln": kc.bound(0.0, 2.0 * 2 * n * c + 8.0 * c)[0],
        "proj": kc.bound(4.0 * n * c * d,
                         2.0 * (n * c + 2 * d * c + 2 * d + n * d))[0],
        "out": kc.bound(2.0 * n * d * c,
                        2.0 * (n * d + d * c + c + 2 * n * c))[0]}


def tconv_bounds(bsz: int, t: int, p: int, c: int, res: bool,
                 stats: bool) -> Dict[str, float]:
    """Least ms of each temporal conv part: the z pass reads x and writes
    the framed z (T + 2 frames) once; the GEMM reads the framed z once and
    writes y (reading the residual), with the products of the taps."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    x, affine = 2.0 * bsz * t * p * c, 8.0 * bsz * c
    framed = 2.0 * bsz * (t + 2) * p * c
    call = kc.tconv_bytes(bsz, t, p, c, res, stats)  # x, y, res, w, affine
    return {"zpass": kc.bound(0.0, x + framed + affine)[0],
            "gemm": kc.bound(kc.tconv_flops(bsz, t, p, c),
                             call - x - affine + framed)[0]}


def device_ms(fn, parts: Tuple[Tuple[str, str], ...]) -> Dict[str, float]:
    """Mean device ms per call of each part over CALLS traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part, _ in parts}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", 0.0)
        for part, key in parts:
            if key in event.key.replace(" ", ""):
                out[part] += us / CALLS / 1e3
    return out


def shapes(kernel: str, dev, gen):
    """(label, case, each part's bound) at every shape of ``kernel``."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    if kernel == "ff":
        for label, n, c in kc.FF_512 + kc.FF_1024:
            case, = kc.ff_cases(dev, gen, ((label, n, c),))
            yield f"{label} N={n} C={c}", case, ff_bounds(n, c, 4 * c)
    else:
        for row in kc.TCONV_512 + kc.TCONV_1024:
            label, (bsz, t, p, c), res, _, stats = row
            case, = kc.tconv_cases(dev, gen, (row,))
            yield (f"{label} B={bsz} T={t} P={p} C={c}", case,
                   tconv_bounds(bsz, t, p, c, res, stats))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(PARTS), required=True)
    args = ap.parse_args(argv)
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
    parts = PARTS[args.kernel]
    for label, case, bounds in shapes(args.kernel, dev, gen):
        total = kc.cuda_ms(case.kernel, 20)
        got = device_ms(case.kernel, parts)
        whole = kc.bound(case.flops, case.nbytes, case.peak)[0]
        print(f"{args.kernel}_breakdown {label}: ms={total:.4f} (bound "
              f"{whole:.4f}) "
              + " ".join(f"{p}_ms={got[p]:.4f} (bound {bounds[p]:.4f})"
                         for p, _ in parts), flush=True)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
