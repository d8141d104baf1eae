"""Where the one-pass GroupNorm's (#16) time goes inside its one launch: an
instrumented copy of ``csrc/group_norm_silu.cu`` stamps, for each block,
the card's clock (``%globaltimer``, ns) when it starts, has summed its
slice, has met its cluster, has read the cluster's sums, has written y and
leaves, and the SM it ran on; this prints the spread of each phase over
the blocks, the SMs used and how many blocks started late (a later wave).

    python -m tooncrafter_tpu_torch.utils.gn_timeline [--rows 3]

``--rows``: how many of ``kernel_check.GN_512`` (then ``GN_L2``) to time.
The copy is built beside the kernel's own (under ``build/``); the
package's kernel is not touched. Needs a CUDA device; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys

import torch

PHASES = ("start", "summed", "synced", "exchanged", "applied", "left")
MAX_BLOCKS = 4096
# (text of the kernel, the stamp put after it: phase index or "sm")
_MARKS = (("  const int rank = (int)sm90::cluster_rank();\n", (0, "sm")),
          ("  // 2. per channel, then per group, in order\n", (1,)),
          ("  sm90::cluster_sync();\n", (2,)),
          ("  sm90::cluster_arrive();\n", (3,)),
          ("  sm90::cluster_wait();\n}", (4, 5)))


def _stamp(what) -> str:
    if what == "sm":
        reg = 'asm volatile("mov.u32 %0, %%smid;" : "=r"(v));'
        slot, decl = 6, "unsigned v;"
    else:
        reg = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));'
        slot, decl = what, "unsigned long long v;"
    return (f"  {{ {decl} {reg} if (threadIdx.x == 0 && blockIdx.x < "
            f"{MAX_BLOCKS}) g_stamps[blockIdx.x * 8 + {slot}] = v; }}\n")


def instrumented_source(text: str) -> str:
    """The kernel's source with the stamps and an exported copy-out."""
    text = text.replace("namespace {\n", "__device__ unsigned long long "
                        f"g_stamps[{MAX_BLOCKS} * 8];\nnamespace {{\n", 1)
    for mark, stamps in _MARKS:
        assert text.count(mark) == 1, mark
        if mark.endswith("}"):  # the last two: before and after the wait
            body = mark[:-1]
            text = text.replace(mark, _stamp(stamps[0]) + body
                                + _stamp(stamps[1]) + "}")
        else:
            text = text.replace(mark, mark + "".join(map(_stamp, stamps)))
    return text + ('\nextern "C" int tc_gn_stamps(void* dst) {\n  return '
                   '(int)cudaMemcpyFromSymbol(dst, g_stamps, '
                   'sizeof(g_stamps));\n}\n')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the timeline runs only on the GPU",
              file=sys.stderr)
        return 2
    from tooncrafter_tpu_torch.ops import _build
    from tooncrafter_tpu_torch.ops import fused_norms as fn
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = _build.BUILD_DIR.parent / "gn_timeline"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, src / f.name)
    kernel = src / fn.LIBRARY[1][0]
    kernel.write_text(instrumented_source(kernel.read_text()))
    lib = fn.bind(_build.load_library(*fn.LIBRARY, csrc=src))
    lib.tc_gn_stamps.argtypes = [ctypes.c_void_p]
    fn._LIB = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    qs = (0.0, 0.25, 0.5, 0.75, 1.0)
    for row in (kc.GN_512 + kc.GN_L2)[:args.rows]:
        case, = kc.gn_cases(dev, gen, (row,))
        p = fn.plan(*row[1])
        blocks = row[1][0] * p.k
        if blocks > MAX_BLOCKS:
            continue
        for _ in range(3):
            case.kernel()
        torch.cuda.synchronize()
        got = torch.zeros(MAX_BLOCKS * 8, dtype=torch.int64)
        if lib.tc_gn_stamps(got.data_ptr()):
            raise SystemExit("could not read the stamps")
        t = got[:blocks * 8].reshape(blocks, 8)
        at = (t[:, :6] - t[:, 0].min()).double() / 1e3  # us
        print(f"gn_timeline {case.label} [k={p.k} rstep={p.rstep} "
              f"{'resident' if p.resident else 'streamed'}]: {blocks} blocks"
              f" on {len(set(t[:, 6].tolist()))} SMs, "
              f"{int((at[:, 0] > 3.0).sum())} starting > 3 us late; end "
              f"{at[:, 5].max().item():.2f} us; quantiles "
              + ", ".join(f"{q:g}" for q in qs), flush=True)
        for j in range(1, len(PHASES)):
            d = at[:, j] - at[:, j - 1]
            print(f"  {PHASES[j - 1]} -> {PHASES[j]} us: "
                  + " ".join(f"{d.quantile(q).item():.2f}" for q in qs),
                  flush=True)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
