"""Two checkouts of the repository timed in turns on one card.

    python -m tooncrafter_tpu_torch.utils.ab_compare --a DIR_A --b DIR_B \
        [--out chiprun_out/ab]

Each run is a fresh process in one checkout: it builds that checkout's
kernels, runs its ``chip_smoke.check_kernels`` (phase 2: every kernel
against its plain version at the path shapes, timed beside the library call
and the bound), times its d = 512 forward at the shapes a phase 2 may lack
(one head at 9216 tokens, the 1024 encoder's), its FF at the mid
blocks' shapes and its temporal conv at the request shapes of this
checkout's ``kernel_check`` (``TCONV_512``, ``TCONV_1024``) where its phase
2 lacks them, answers its 3b and 3c
requests (two 320x512 and one 576x1024 DDIM-50 clips,
``chip_smoke.answer_requests``) and takes its 4b training steps
(``chip_smoke.train_full_width``, the 512 training model at full width),
with the functions of that checkout's ``chip_smoke.py``. Then it answers one
320x512 request with the three opt-in switches on (3d, 3b's model, seed
and inputs; its PSNR against 3b's first clip) and takes the 4b' training
steps under ``TOONCRAFTER_FUSED_GN=1``; and it times the one-pass
GroupNorm at this checkout's ``GN_512`` and ``GN_L2`` shapes where a
checkout's phase 2 lacks them. The runs go A, B,
B, A, so a drift of the card's clock or temperature over the call falls on
both alike. A run whose kernels fail their check ends there with a non-zero
code; the comparison stops at it and exits 1, so every time it reports
comes from runs that passed phase 2. With ``--train`` a run only builds
its checkout's kernels and takes ``TRAIN_STEPS`` AdamW steps with EMA of
each training model (configs/training_512_v1.0.yaml, two clips, and
configs/training_1024_v1.0.yaml, one clip) through that checkout's
``chip_smoke.train_full_width`` (the first step warms up; a checkout
whose ``train_full_width`` takes no ``yaml`` cannot be compared so): the
step seconds, the peak memory and the launches per step of each. Each
run's output goes to ``OUT/<i>_<a|b>.log``; the phase-2 times of every
(kernel, shape), the request and training-step seconds and the peak
memory of each run go to ``OUT/summary.json`` and are printed as a table. Needs a CUDA card; the
checkouts' own code decides everything else.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List

from tooncrafter_tpu_torch.utils import kernel_check as kc

ORDER = "abba"

_RUN = r"""
import gc, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tooncrafter_tpu_torch.utils import kernel_check as kc
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
kc.build_all()
print(f"== build {time.perf_counter() - t0:.1f} s", flush=True)
cs.check_kernels(dev)  # a failed check exits non-zero here
# shapes a checkout's phase 2 may lack, timed the same way in every run
from tooncrafter_tpu_torch.ops import flash_attention as fa
for bh, s in ((1, 9216),):
    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn(bh, s, 512, device=dev, generator=g).bfloat16()
               for _ in range(3))
    run = lambda: fa._flash_bh_with_lse(q, k, v, 512 ** -0.5)
    out, lse = run()
    with kc.fp32_reference():
        ref, _ = fa._plain_bh_ones(q.float(), k.float(), v.float(),
                                   512 ** -0.5, cdt=torch.bfloat16,
                                   block=fa.key_tile(512))
    err = (out.float() - ref).abs().max().item()
    ms = kc.cuda_ms(run, 10)
    lib = kc.cuda_ms(lambda: cs.sdpa(q, k, v, 512 ** -0.5), 10)
    bound, by = kc.bound(4.0 * bh * s * s * 512, 8.0 * bh * s * 512)
    print(f"A/B d=512 BH={bh} S={s}: max_abs_err={err:.3e} ms={ms:.4f} "
          f"library_ms={lib:.4f} bound_ms={bound:.4f} ({by})", flush=True)
    del q, k, v, out, lse, ref
# the FF at the mid block's shapes, where a checkout's phase 2 lacks them
have = {label for label, _, _ in kc.FF_512 + kc.FF_1024}
mids = (("mid", 1280, 1280), ("1024 mid", 4608, 1280))
gen = torch.Generator(device=dev).manual_seed(1)
for case in kc.ff_cases(dev, gen, tuple(s for s in mids if s[0] not in have)):
    print(kc.line(case, kc.run_case(case)), flush=True)
# the temporal conv at every request shape, where a checkout's phase 2
# lacks it: (label, (B, T, P, C), residual, out_scale, stats)
have = {row[0] for row in kc.TCONV_512 + kc.TCONV_1024}
for case in kc.tconv_cases(dev, gen, tuple(s for s in TCONV_SHAPES
                                            if s[0] not in have)):
    axes = (2,) if "stats" in case.label else None
    print(kc.line(case, kc.run_case(case, axes)), flush=True)
# the one-pass GroupNorm at every shape of this file's checkout, where a
# checkout's phase 2 lacks it: (label, (N, HW, C), silu)
have = {row[0] for row in kc.GN_512 + getattr(kc, "GN_L2", ())}
for case in kc.gn_cases(dev, gen, tuple(s for s in GN_SHAPES
                                         if s[0] not in have)):
    print(kc.line(case, kc.run_case(case)), flush=True)
print("== requests inference_512_v1.0.yaml", flush=True)
counts, pipe, requests, clips = cs.answer_requests(
    dev, 50, "inference_512_v1.0.yaml", 2, cs.KERNELS_512)
print("== requests 3d", flush=True)
with cs.switches():
    _, clips_sw = cs._serve(pipe, requests[:1], dev)
print(f"3d against 3b's first clip: min PSNR "
      f"{cs.psnr(clips_sw[0], clips[0]):.2f} dB", flush=True)
del pipe, requests, clips, clips_sw
gc.collect()
torch.cuda.empty_cache()
print("== requests inference_1024_v1.0.yaml", flush=True)
cs.answer_requests(dev, 50, "inference_1024_v1.0.yaml", 1, cs.KERNELS_1024)
gc.collect()
torch.cuda.empty_cache()
print("== training", flush=True)
cs.train_full_width(dev)
print("== training switched", flush=True)
with cs.switches(pair=True):
    cs.train_full_width(dev, cs.TRAIN_STEPS_SWITCHED,
                        cs.TRAIN_KERNELS_SWITCHED)
"""

TRAIN_STEPS = 4
_TRAIN_RUN = r"""
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tooncrafter_tpu_torch.utils import kernel_check as kc
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)  # the allocator, before its peak is reset
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
kc.build_all()
print(f"== build {time.perf_counter() - t0:.1f} s", flush=True)
for yaml in ("training_512_v1.0.yaml", "training_1024_v1.0.yaml"):
    print(f"== training {yaml}", flush=True)
    cs.train_full_width(dev, STEPS, (), yaml=yaml)
"""

# "name label: [dq ]max_abs_err=... ms=1.2 plain_ms=... library_ms=...
# bound_ms=..." (the backward's lines name each gradient first)
_LINE = re.compile(r"^(\S+) (.+?): .*?max_abs_err=.*? ms=([\d.]+) .*?"
                   r"library_ms=([\d.]+|none) bound_ms=([\d.]+)")
_REQUEST = re.compile(r"^request (\d+) \(fs \d+\): ([\d.]+) s")
_PEAK = re.compile(r"^peak memory allocated ([\d.]+) GiB")
_STEP = re.compile(r"^train step \d+: ([\d.]+) s")
_TRAIN_PEAK = re.compile(r"^training: peak memory allocated ([\d.]+) GiB")
_PSNR = re.compile(r"^3d against 3b's first clip: min PSNR ([\d.]+) dB")


def parse(log: str) -> dict:
    """Phase-2 ms per 'name label', request seconds and peaks per model,
    training-step seconds and their peak (under 'training')."""
    kernels: Dict[str, dict] = {}
    requests: Dict[str, List[float]] = {}
    peaks: Dict[str, float] = {}
    psnr = None
    model, training = None, "training"
    for line in log.splitlines():
        if line.startswith("== requests "):
            model = line.split()[-1]
        if line.startswith("== training"):
            training = line[3:]
        m = _PSNR.match(line)
        if m:
            psnr = float(m.group(1))
        m = _LINE.match(line)
        if m:
            lib = m.group(4)
            kernels[f"{m.group(1)} {m.group(2)}"] = {
                "ms": float(m.group(3)), "bound_ms": float(m.group(5)),
                "library_ms": None if lib == "none" else float(lib)}
        m = _REQUEST.match(line)
        if m and model:
            requests.setdefault(model, []).append(float(m.group(2)))
        m = _PEAK.match(line)
        if m and model:
            peaks[model] = float(m.group(1))
        m = _STEP.match(line)
        if m:
            requests.setdefault(training, []).append(float(m.group(1)))
        m = _TRAIN_PEAK.match(line)
        if m:
            peaks[training] = float(m.group(1))
    return {"kernels": kernels, "requests": requests, "peak_gib": peaks,
            "psnr_3d_db": psnr}


def run_one(where: str, log_path: str, train: bool = False) -> dict:
    """One run in the checkout ``where``: its return code, seconds and what
    ``parse`` reads from its output, which goes to ``log_path``."""
    t0 = time.perf_counter()
    gn = tuple(row[:3] for row in kc.GN_512 + kc.GN_L2)
    code = (_TRAIN_RUN.replace("STEPS", str(TRAIN_STEPS)) if train
            else _RUN.replace("TCONV_SHAPES", repr(
                kc.TCONV_512 + kc.TCONV_1024)).replace("GN_SHAPES", repr(gn)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=where,
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    with open(log_path, "w") as f:
        f.write(log)
    return {"dir": where, "rc": proc.returncode,
            "seconds": time.perf_counter() - t0, **parse(log)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. the parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. the change)")
    ap.add_argument("--out", default="chiprun_out/ab")
    ap.add_argument("--train", action="store_true",
                    help="only the training steps of the 512 and 1024 "
                         "training models")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, which in enumerate(ORDER):
        run = {"which": which, **run_one(
            os.path.abspath(getattr(args, which)),
            os.path.join(args.out, f"{i}_{which}.log"), args.train)}
        runs.append(run)
        print(f"run {i} ({which}): rc {run['rc']}, {run['seconds']:.0f} s, "
              f"requests {run['requests']}, peak {run['peak_gib']}, 3d "
              f"PSNR {run['psnr_3d_db']} dB", flush=True)
        if run["rc"] != 0:
            print(f"run {i} failed: see {i}_{which}.log; no times reported",
                  flush=True)
            break
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"card": smi, "order": ORDER, "runs": runs}, f, indent=1)
    if runs[-1]["rc"] != 0:
        return 1
    shapes = [k for k in runs[0]["kernels"]]
    for run in runs[1:]:
        shapes += [k for k in run["kernels"] if k not in shapes]
    print("ms per run (" + ", ".join(ORDER) + "), library_ms, bound_ms:")
    for k in shapes:
        got = [r["kernels"].get(k) for r in runs]
        ms = ", ".join("-" if g is None else f"{g['ms']:.4f}" for g in got)
        ref = next(g for g in got if g is not None)
        lib = ref["library_ms"]
        print(f"{k}: {ms}; library {'none' if lib is None else lib}; "
              f"bound {ref['bound_ms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
