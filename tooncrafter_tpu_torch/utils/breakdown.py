"""Where a fused call's time goes on the card: the kernels of one call at
every shape of ``kernel_check``, each kernel's device time from a
torch.profiler trace of a few calls beside the least time the card could
take for its part, and the whole call's time from CUDA events.

    python -m tooncrafter_tpu_torch.utils.breakdown --kernel ff
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel tconv
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel tpair
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel gn
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel sums
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel ptc
    python -m tooncrafter_tpu_torch.utils.breakdown --kernel dual

``ff``: the FF's three kernels (``csrc/fused_ff.cu``: the LayerNorm, the
projection with the gate, the out-GEMM with the bias and residual) at
``FF_512`` and ``FF_1024``. ``tconv``: the temporal conv's two kernels
(``csrc/temporal_conv.cu``: the z pass into the zero-framed buffer, the
three-tap GEMM with its epilogue) at ``TCONV_512`` and ``TCONV_1024``.
``tpair``: the temporal attention pair's kernels (``csrc/temporal_attention.cu``:
the LayerNorm, the q|k|v GEMM with the attention in its epilogue, the
out-GEMM with the bias and residual, each twice a call) at ``TPAIR_512``
and ``TPAIR_1024``. ``gn``: the one-pass GroupNorm's one cluster launch
(``csrc/group_norm_silu.cu``) at ``GN_512`` and ``GN_L2``. ``sums``: the
channel sums' one launch (``csrc/channel_sums.cu``) at ``STATS_512``.
``ptc``: the T-attention core's one launch (``csrc/temporal_ptc.cu``) at
``PTC_512``; ``dual``: the dual cross-attention's one launch
(``csrc/dual_cross_attention.cu``, a Python float gate) at ``ATTN2_512``.
``--shapes`` replaces those rows ((label, [N, HW, C], silu), (label, [N,
S, C], count), (label, T, P, inner, heads) and (label, Sq, C)), and the
package comes from the working directory, so
``cd DIR && python PATH/breakdown.py --kernel gn`` times the kernels of the
checkout in DIR (every kernel of a call is its device time). Each
line also gives the kernels a call launches in the trace
(``kernels_a_call``) and the wrapper's host time per call (``host_us``: the
enqueue of a few calls in a row, no synchronisation between them); where
the host time exceeds the device time, the call's time is the host's.
Needs a CUDA device. Prints the card's name and power limit first, then
one line per shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, Tuple

import torch

# per kernel: its parts, each (name, the substrings of its kernels' names
# in a trace, all present; the shared LayerNorm and out-GEMM carry their
# library's Tag)
PARTS = {
    "ff": (("ln", ("ln_kernel<", "fused_ff::Tag")),
           ("proj", ("fused_ff::proj_kernel",)),
           ("out", ("out_kernel<", "fused_ff::Tag"))),
    "tconv": (("zpass", ("tconv::zpass_kernel",)),
              ("gemm", ("tconv::gemm_kernel",))),
    "tpair": (("ln", ("ln_kernel<", "tattn::Tag")),
              ("qkv", ("tattn::qkv_kernel",)),
              ("out", ("out_kernel<", "tattn::Tag"))),
    # one part: every kernel of the call (this tree launches one; a
    # checkout before the one-launch designs, three or two)
    "gn": (("gn", ()),),
    "sums": (("sums", ()),),
    # one part: every kernel of the call (the parent's #17 wrapper also
    # filled its float gate on the card)
    "ptc": (("ptc", ()),),
    "dual": (("dual", ()),),
}
CALLS = 5
HOST_CALLS = 10


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


def tpair_bounds(bsz: int, t: int, p: int, c: int) -> Dict[str, float]:
    """Least ms of each part of a pair call (two stages): the LayerNorms
    read x or y and write z; the q|k|v GEMMs read z and the weights and
    write o, with the projections and the attention's products; the
    out-GEMMs read o, the residual and the weights and write y."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    n = bsz * t * p
    act = 2.0 * n * c
    return {
        "ln": 2 * kc.bound(0.0, 2 * act + 8.0 * c)[0],
        "qkv": 2 * kc.bound(6.0 * n * c * c + 4.0 * n * t * c,
                            2 * act + 6.0 * c * c)[0],
        "out": 2 * kc.bound(2.0 * n * c * c,
                            3 * act + 2.0 * c * c + 2.0 * c)[0]}


def host_us(fn) -> float:
    """The wrapper's host time per call: HOST_CALLS calls enqueued in a row
    after a synchronisation, timed on the host before the device catches
    up (microseconds)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(fn, parts: Tuple[Tuple[str, Tuple[str, ...]], ...]
              ) -> Dict[str, float]:
    """Mean device ms per call of each part over CALLS traced calls, and
    the kernels a call launches (``kernels_a_call``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part, _ in parts}
    kernels = 0
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", 0.0)
        kernels += event.count if us > 0 else 0
        name = event.key.replace(" ", "")
        for part, keys in parts:
            if all(k in name for k in keys):
                out[part] += us / CALLS / 1e3
    out["kernels_a_call"] = kernels / CALLS
    return out


def shapes(kernel: str, dev, gen, rows=None):
    """(label, case, each part's bound) at every shape of ``kernel`` (for
    ``gn`` and ``sums``, at ``rows`` where given)."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    if kernel == "ff":
        for label, n, c in kc.FF_512 + kc.FF_1024:
            case, = kc.ff_cases(dev, gen, ((label, n, c),))
            yield f"{label} N={n} C={c}", case, ff_bounds(n, c, 4 * c)
    elif kernel == "tpair":
        for label, p, c in kc.TPAIR_512 + kc.TPAIR_1024:
            case, = kc.tpair_cases(dev, gen, ((label, p, c),))
            yield (f"{label} B=2 T=16 P={p} C={c}", case,
                   tpair_bounds(2, 16, p, c))
    elif kernel == "gn":
        from tooncrafter_tpu_torch.ops import fused_norms as fn

        for row in rows or kc.GN_512 + kc.GN_L2:
            case, = kc.gn_cases(dev, gen, (row,))
            label = case.label
            if hasattr(fn, "plan"):  # the plan, and its clusters a wave
                p = fn.plan(*row[1])
                held = fn._library().tc_gn_clusters(p.k, p.threads, p.smem,
                                                    int(p.resident))
                label += (f" [k={p.k} rstep={p.rstep} "
                          f"{'resident' if p.resident else 'streamed'} "
                          f"clusters_a_wave={held}]")
            yield label, case, {"gn": kc.bound(case.flops, case.nbytes)[0]}
    elif kernel == "sums":
        for row in rows or kc.STATS_512:
            case, = kc.stats_cases(dev, gen, (row,))
            yield case.label, case, {"sums": kc.bound(
                case.flops, case.nbytes, case.peak)[0]}
    elif kernel == "ptc":
        from tooncrafter_tpu_torch.ops import temporal_attention as ta

        for row in rows or kc.PTC_512:
            case, = kc.ptc_cases(dev, gen, (row,))
            label = case.label
            if hasattr(ta, "ptc_plan"):
                p = ta.ptc_plan(2, *row[1:])
                label += (f" [t_box={p.t_box} pixels={p.pixels} "
                          f"stages={p.stages} grid={p.grid}]")
            yield label, case, {"ptc": kc.bound(case.flops, case.nbytes)[0]}
    elif kernel == "dual":
        from tooncrafter_tpu_torch.ops import cross_attention as ca

        for row in rows or kc.ATTN2_512:
            case, = kc.dual_cases(dev, gen, (row,))
            label = case.label
            if hasattr(ca, "plan"):
                p = ca.plan(32, row[1], row[2], 77, 16)
                held = ca._library().tc_dual_blocks_per_sm(p.smem)
                label += (f" [{'resident' if p.resident else 'streamed'} "
                          f"grid={p.grid} blocks_an_sm={held} kv_loads="
                          f"{sum(len(p.units(i)) for i in range(p.grid))}]")
            yield label, case, {"dual": kc.bound(case.flops,
                                                 case.nbytes)[0]}
    else:
        for row in kc.TCONV_512 + kc.TCONV_1024:
            label, (bsz, t, p, c), res, _, stats = row
            case, = kc.tconv_cases(dev, gen, (row,))
            yield (f"{label} B={bsz} T={t} P={p} C={c}", case,
                   tconv_bounds(bsz, t, p, c, res, stats))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(PARTS), required=True)
    ap.add_argument("--shapes", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
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
    rows = args.shapes and [tuple(r) for r in json.loads(args.shapes)]
    for label, case, bounds in shapes(args.kernel, dev, gen, rows):
        total = kc.cuda_ms(case.kernel, 20)
        got = device_ms(case.kernel, parts)
        host = host_us(case.kernel)
        whole = kc.bound(case.flops, case.nbytes, case.peak)[0]
        print(f"{args.kernel}_breakdown {label}: ms={total:.4f} (bound "
              f"{whole:.4f}) "
              + " ".join(f"{p}_ms={got[p]:.4f} (bound {bounds[p]:.4f})"
                         for p, _ in parts)
              + f" kernels_a_call={got['kernels_a_call']:g}"
              f" host_us={host:.1f}", flush=True)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
