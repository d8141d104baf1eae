"""On-card smoke test of the PyTorch port (tooncrafter_tpu_torch) on one GPU.

    python3 chip_smoke.py [--ddim_steps 50]

Phases, each printed on its own lines; any failure exits non-zero:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from tooncrafter_tpu_torch/csrc (one nvcc per
     library, all at once) and print each one's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the 320x512 interpolation path gives it, then at the 576x1024
     path's most-launched shapes (the VAE mid attention at both its
     decoder and per-frame encoder shapes), the switched path's, and the
     shapes the
     op functions of the kernels no model reaches are driven with, with
     its time, the plain version's (fp32 products: a reference), the
     unfused module chain's in bf16 (chain_ms: what the port ran before the
     kernel), the one PyTorch call that computes the same function where
     there is one (library_ms; the port never calls it) and the least time
     the card could take (bound_ms);
  2'. the op functions of the kernels no model reaches, as their users
     call them: ``dual_cross_attention`` at the 512 UNet's attn2 shapes
     with TC_DUAL_CROSS_PALLAS on (#17, one launch a call) and off (none),
     ``stats.channel_sums`` at its GroupNorm inputs inside the envelope
     (#18), ``_flash_mh_ones`` at #2's and the 1024 attn1 shapes (#5) and
     ``temporal_attention_ptc`` (#11, no shipped site), each output against
     its plain version;
  3. check a reduced model on the card against the same model on the CPU
     (every kernel reached, the convs at a ragged pixel tile), and a batch
     of two clips with per-item generators against the two clips alone
     (the --bs contract, 3a''), then build
     the full-width 320x512 model (configs/inference_512_v1.0.yaml) with
     random weights from a fixed seed in bf16 and answer two interpolation
     requests (16 frames, DDIM, CFG 7.5 + rescale 0.7, the middle-frame
     splice) through the port's Pipeline, counting kernel launches (3b);
     then, the 512 model freed, the same for the 576x1024 model
     (configs/inference_1024_v1.0.yaml: base_scale 0.3), one request
     (3c); every request at the YAML's default_fs as the frame stride, each
     with its
     seconds per phase, peak memory and launches per kernel;
  3a', 3d. the JAX package's three opt-in switches on (TC_TATTN_PAIR=0,
     TC_SPATIAL_CONV_PALLAS=1, TOONCRAFTER_FUSED_GN=1, set as the port's
     module globals): the reduced model card against CPU again, then one
     full-width 320x512 request with 3b's model, seed and inputs (the pair
     at 0 launches; the single-stage temporal attention, the im2col-named
     conv and the one-pass GroupNorm launched), its PSNR against 3b's
     first clip printed;
  4. training: a reduced model's UNet and image_proj gradients in bf16 on
     the card against the same model's fp32 gradients on the CPU (same
     weights, same draws), then the full-width 320x512 training model
     (configs/training_512_v1.0.yaml: per-block checkpointing with the
     'dots' policy) with random weights from a fixed seed takes three
     AdamW steps with EMA on a batch of two 16x320x512 clips through
     ``make_train_step``, counting the forward and backward kernels'
     launches, with the step seconds and the peak memory.
No model phase launches #5, #17 or #18. The last two lines are the
kernels' JSON summary (``launches`` from the first path that runs the
kernel: 3b, else 3c, else 4b, else 3d, else 4b', else 2'; and each path's
count) and the device JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 123

# A kernel's bounds against its fp32 plain version scale with each shape's
# reference: flash_attention.error_bounds (2 bf16 ulps of the largest |out|,
# 4x the mean bf16 rounding error of the reference) and LSE_MAX_ABS.

# the reduced model in bf16 on the card against fp32 on the CPU
REDUCED_MIN_PSNR = 30.0
# random weights make no picture; this only rules out a blow-up (the
# decoder's last conv sees unit-variance features: outputs of a few units)
OUTPUT_MAX_ABS = 100.0
# the reduced training model's gradients, card (bf16 autocast, kernels)
# against CPU (fp32, plain versions): the cosine of the concatenated
# gradient, and each tensor's relative L2 error
# (bf16 products round each operand to 2^-9; through the UNet's depth the
# worst tensor was 3.6% off on the first run, so 0.1 leaves ~3x margin)
GRAD_MIN_COSINE = 0.99
GRAD_MAX_REL_L2 = 0.1
TRAIN_STEPS = 3
# the kernels a training step of the 512 model launches
TRAIN_KERNELS = ("_flash_mh_packed", "_flash_mh", "_pallas_ff",
                 "_pallas_ff_streamed", "_fused_tpair_call", "_flash_bwd_bh")
# the kernels a 320x512 request launches (the reduced model reaches each)
KERNELS_512 = ("_flash_mh_packed", "_flash_mh", "_flash_bh_with_lse",
               "_flash_bh_single", "_pallas_ff", "_pallas_ff_streamed",
               "_pallas_tconv", "winograd_gn_silu_conv3x3",
               "_fused_tpair_call")
# the kernels a 576x1024 request launches: attn1 at S = 9216 and 2304 takes
# the token-major kernel (S > 4096, and 2304 % 640 != 0: never the packed
# one); the ds4 attn1 (S = 576) and every VAE mid attention (S = 9216, past
# the single-pass cap) take the two-pass wrapper; the 36x64 640->640 convs
# are the F(2x4)-named ones
KERNELS_1024 = ("_flash_mh", "_flash_bh_with_lse", "_pallas_ff",
                "_pallas_ff_streamed", "_fused_tpair_call", "_pallas_tconv",
                "winograd_gn_silu_conv3x3", "winograd24_gn_silu_conv3x3")
# the kernels the three switches add on the 320x512 path (the T-attention
# core #11 is reached at no shipped site: wherever its rule holds, the
# single-stage kernel's does too); under them the pair runs nowhere
KERNELS_SWITCHED = ("_fused_tattn_call", "_pallas_fused_conv", "_pallas_gn")
TRAIN_KERNELS_SWITCHED = TRAIN_KERNELS + ("_pallas_gn",)
TRAIN_STEPS_SWITCHED = 2
# the kernels no model reaches, driven through their op functions (2')
OP_KERNELS = ("_dual_kernel_call", "_pallas_sums", "_flash_mh_ones",
              "_ptc_kernel_call")
# a batch of two clips with per-item generators against each clip alone,
# reduced model in bf16 on the card, against the same comparison with
# nothing drawn (3a'' prints both): batched and single runs sum in other
# orders (torch's reductions, cuBLAS and cuDNN pick theirs by shape), and 3
# DDIM steps at CFG 7.5 spread that over the clip, so the per-item draws may
# cost at most this many dB more than that floor. A whole-batch draw (clip
# 1's noise after clip 0's) must fall at least as far below the per-item run.
PER_ITEM_MARGIN_DB = 3.0


@contextlib.contextmanager
def switches(pair: bool = False, spatial_conv_pallas: bool = True,
             fused_gn: bool = True):
    """The JAX package's opt-in switches as the port's module globals:
    TC_TATTN_PAIR=0, TC_SPATIAL_CONV_PALLAS=1, TOONCRAFTER_FUSED_GN=1."""
    from tooncrafter_tpu_torch.ops import fused_norms as fn
    from tooncrafter_tpu_torch.ops import spatial_conv as sc
    from tooncrafter_tpu_torch.ops import temporal_attention as ta

    saved = (ta._PAIR, sc._SPATIAL_CONV_PALLAS, fn._FUSED_GN)
    ta._PAIR, sc._SPATIAL_CONV_PALLAS, fn._FUSED_GN = (
        pair, spatial_conv_pallas, fused_gn)
    try:
        yield
    finally:
        ta._PAIR, sc._SPATIAL_CONV_PALLAS, fn._FUSED_GN = saved


def psnr(a, b) -> float:
    """Lowest per-frame PSNR (dB) of two clips in [-1, 1]."""
    mse = (a.float() - b.float()).square().mean(dim=(2, 3, 4))
    return (10 * torch.log10(4.0 / mse.clamp_min(1e-12))).min().item()


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def sdpa(q, k, v, scale, heads=None):
    """The one PyTorch call for the same attention (library_ms only):
    token-major (B, S, H*D) operands with ``heads``, else (BH, S, D)."""
    import torch.nn.functional as F

    def split(t):
        if heads is None:
            return t.unsqueeze(0)
        b, s, c = t.shape
        return t.unflatten(-1, (heads, c // heads)).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v),
                                          scale=scale)


def check_kernels(dev) -> dict:
    """Each kernel against its plain version at the path's shapes, timed
    with its plain version and its library call; a kernel's JSON row takes
    the times and bound of its first (main) shape and the largest error over
    its shapes. Every shape is checked and printed before a disagreement
    exits."""
    from tooncrafter_tpu_torch.ops import flash_attention as fa
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    # #3 and #4 round p for their normalizer, at the kernel's running max
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen,
                                 dtype=torch.float32).to(torch.bfloat16)

    def fold(x):  # (1, S, 512) projection -> (8, S, 64) view, as the path
        return x.view(1, x.shape[1], 8, 64).transpose(1, 2).reshape(
            8, x.shape[1], 64)

    def packed_plain(qkv, heads):
        c = qkv.shape[-1] // 3
        return fa._plain_mh(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                            heads, 0.125)

    def packed_sdpa(qkv, heads):
        c = qkv.shape[-1] // 3
        return sdpa(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], 0.125,
                    heads)

    # (kernel, label, bf16 operands, kernel fn, plain fn, library fn, query
    #  rows compared or None, timing reps of kernel and plain, (BH, Sq, Sk,
    #  D) for the bound)
    cases = []
    for label, s, c, heads in (("ds1", 2560, 320, 5), ("ds2", 640, 640, 10)):
        cases.append((
            "_flash_mh_packed", f"{label} B=32 S={s} C={c}", (rnd(32, s, 3 * c),),
            lambda qkv, h=heads: fa._flash_mh_packed(qkv, h, 0.125),
            lambda qkv, h=heads: packed_plain(qkv, h),
            lambda qkv, h=heads: packed_sdpa(qkv, h), None, (20, 3),
            (32 * heads, s, s, 64)))
    qkv = rnd(32, 160, 3 * 1280)  # ds4: slices of the packed projection
    cases.append(("_flash_mh", "ds4 B=32 S=160 C=1280",
                  (qkv[..., :1280], qkv[..., 1280:2560], qkv[..., 2560:]),
                  lambda q, k, v: fa._flash_mh(q, k, v, 20, 0.125),
                  lambda q, k, v: fa._plain_mh(q, k, v, 20, 0.125),
                  lambda q, k, v: sdpa(q, k, v, 0.125, 20),
                  None, (50, 10), (32 * 20, 160, 160, 64)))
    # dual-ref fusion, 8 heads x 64; level 2's plain version is compared on
    # a subset of query rows (all 20480 keys) and timed whole
    for label, sq, sk, reps in (("level2", 163840, 20480, (3, 1)),
                                ("level3", 40960, 5120, (10, 2))):
        cases.append((
            "_flash_bh_with_lse", f"{label} BH=8 Sq={sq} Sk={sk}",
            (fold(rnd(1, sq, 512)), fold(rnd(1, sk, 512)),
             fold(rnd(1, sk, 512))),
            lambda q, k, v: fa._flash_bh_with_lse(q, k, v, 0.125),
            lambda q, k, v: fa._plain_bh_ones(q, k, v, 0.125, cdt=bf16,
                                              block=fa.key_tile(64)),
            lambda q, k, v: sdpa(q, k, v, 0.125),
            (torch.arange(0, sq, 41, device=dev)[:4096]
             if label == "level2" else None), reps, (8, sq, sk, 64)))
    # VAE mid attention, one head of 512: decoder (16 frames), encoder (1)
    for label, bh, reps in (("decoder", 16, (10, 3)), ("encoder", 1, (20, 5))):
        cases.append((
            "_flash_bh_single", f"{label} BH={bh} S=2560 D=512",
            tuple(rnd(bh, 2560, 512) for _ in range(3)),
            lambda q, k, v: fa._flash_bh_with_lse(q, k, v, 512 ** -0.5),
            lambda q, k, v: fa._plain_bh_ones(q, k, v, 512 ** -0.5,
                                            cdt=bf16,
                                            block=fa.key_tile(512)),
            lambda q, k, v: sdpa(q, k, v, 512 ** -0.5), None, reps,
            (bh, 2560, 2560, 512)))
    # the 576x1024 path: attn1 at ds1 and ds2 (S=9216 > 4096, and 2304 %
    # 640 != 0: the token-major kernel on slices of the packed projection),
    # attn1 at ds4 (S=576, no single-pass block: the two-pass kernel through
    # the head-split view the UNet passes ``flash_attention``; 250 of its
    # 272 launches a request), the fusion at levels 2 and 3 (plain compared
    # on a subset of query rows) and the decoder's VAE mid attention at
    # S=9216 (two-pass: K/V past the single-pass cap)
    for label, s, c, heads, idx, reps in (
            ("ds1", 9216, 320, 5, torch.arange(0, 9216, 3, device=dev),
             (5, 1)),
            ("ds2", 2304, 640, 10, None, (20, 3))):
        qkv = rnd(32, s, 3 * c)
        cases.append(("_flash_mh", f"1024 {label} B=32 S={s} C={c}",
                      (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]),
                      lambda q, k, v, h=heads: fa._flash_mh(q, k, v, h, 0.125),
                      lambda q, k, v, h=heads: fa._plain_mh(q, k, v, h, 0.125),
                      lambda q, k, v, h=heads: sdpa(q, k, v, 0.125, h),
                      idx, reps, (32 * heads, s, s, 64)))
    qkv = rnd(32, 576, 3 * 1280)
    heads4 = lambda t: t.unflatten(-1, (20, 64))
    cases.append(("_flash_bh_with_lse", "1024 ds4 attn1 B=32 S=576 C=1280, "
                  "20 heads, head-split view",
                  (qkv[..., :1280], qkv[..., 1280:2560], qkv[..., 2560:]),
                  lambda q, k, v: fa.flash_attention(
                      heads4(q), heads4(k), heads4(v), 0.125).flatten(2),
                  lambda q, k, v: fa._plain_mh_ones(
                      q, k, v, 20, 0.125, cdt=bf16, block=fa.key_tile(64)),
                  lambda q, k, v: sdpa(q, k, v, 0.125, 20),
                  None, (50, 10), (32 * 20, 576, 576, 64)))
    for label, sq, sk, step, reps in (("level2", 589824, 73728, 149, (2, 1)),
                                      ("level3", 147456, 18432, 37, (5, 1))):
        cases.append((
            "_flash_bh_with_lse", f"1024 {label} BH=8 Sq={sq} Sk={sk}",
            (fold(rnd(1, sq, 512)), fold(rnd(1, sk, 512)),
             fold(rnd(1, sk, 512))),
            lambda q, k, v: fa._flash_bh_with_lse(q, k, v, 0.125),
            lambda q, k, v: fa._plain_bh_ones(q, k, v, 0.125, cdt=bf16,
                                              block=fa.key_tile(64)),
            lambda q, k, v: sdpa(q, k, v, 0.125),
            torch.arange(0, sq, step, device=dev)[:4096], reps,
            (8, sq, sk, 64)))
    # the 1024 VAE mid attention: decoder (16 frames), encoder (one frame a
    # call, 16 calls a request)
    for label, bh, reps in (("decoder", 16, (3, 1)), ("encoder", 1, (10, 3))):
        cases.append((
            "_flash_bh_with_lse", f"1024 {label} mid BH={bh} S=9216 D=512",
            tuple(rnd(bh, 9216, 512) for _ in range(3)),
            lambda q, k, v: fa._flash_bh_with_lse(q, k, v, 512 ** -0.5),
            lambda q, k, v: fa._plain_bh_ones(q, k, v, 512 ** -0.5,
                                              cdt=bf16,
                                              block=fa.key_tile(512)),
            lambda q, k, v: sdpa(q, k, v, 512 ** -0.5), None, reps,
            (bh, 9216, 9216, 512)))

    rows, failed = {}, []
    for (name, label, args, kernel, plain, library, idx,
         (reps, plain_reps), (bh, sq, sk, d)) in cases:
        before = dict(fa.LAUNCHES)
        got = kernel(*args)
        if fa.LAUNCHES[name] != before[name] + 1:
            raise SystemExit(f"{label} did not launch {name}")
        got = got if isinstance(got, tuple) else (got,)
        # the plain version in fp32 on the same (bf16-valued) operands;
        # rows are independent, so level 2 is compared on a subset
        ref_args = [a.float() for a in args]
        if idx is not None:
            ref_args[0] = ref_args[0][:, idx]
            got = tuple(t[:, idx] for t in got)
        ref = plain(*ref_args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        err = (got[0].float() - ref[0]).abs()
        mx, mean = err.max().item(), err.mean().item()
        max_bound, mean_bound = fa.error_bounds(ref[0])
        ok = mx <= max_bound and mean <= mean_bound
        ok = ok and torch.isfinite(got[0].float()).all().item()
        line = (f"{name} {label}: max_abs_err={mx:.3e} (bound "
                f"{max_bound:.3e}) mean_abs_err={mean:.3e} (bound "
                f"{mean_bound:.3e}, |ref| mean {ref[0].abs().mean().item():.3e}"
                f" max {ref[0].abs().max().item():.3e})")
        if len(got) == 2:
            lerr = (got[1] - ref[1]).abs()
            line += (f" lse_max_abs_err={lerr.max().item():.3e}"
                     f" lse_mean_abs_err={lerr.mean().item():.3e}")
            ok = ok and lerr.max().item() <= fa.LSE_MAX_ABS
            mx = max(mx, lerr.max().item())
        ms = kc.cuda_ms(lambda: kernel(*args), reps)
        plain_ms = kc.cuda_ms(lambda: plain(*args), plain_reps)
        library_ms = kc.cuda_ms(lambda: library(*args), reps)
        # QK^T and PV products; q, k, v read and the output written once
        bound_ms, bound_by = kc.bound(4.0 * bh * sq * sk * d,
                                      2.0 * bh * d * (2 * sq + 2 * sk))
        print(f"{line} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
              + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            failed.append(f"{name} {label}")
        row = rows.setdefault(name, new_row(name, ms, plain_ms, library_ms,
                                            bound_ms, bound_by))
        row["max_abs_err"] = max(row["max_abs_err"], mx)
    del cases, args, got, ref, ref_args, qkv
    for cases_of in (kc.fused_cases, kc.fused_cases_1024, kc.switched_cases,
                     kc.op_cases):
        for case, axes in cases_of(dev):
            r = kc.run_case(case, axes)
            print(kc.line(case, r), flush=True)
            if not r["ok"]:
                failed.append(f"{case.name} {case.label}")
            row = rows.setdefault(case.name, new_row(
                case.name, r["ms"], r["plain_ms"], r["library_ms"],
                r["bound_ms"], r["bound_by"]))
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
    for case in kc.bwd_cases(dev):
        r = kc.run_bwd_case(case)
        print(kc.bwd_line(case, r), flush=True)
        if not r["ok"]:
            failed.append(f"_flash_bwd_bh {case.label}")
        row = rows.setdefault("_flash_bwd_bh", new_row(
            "_flash_bwd_bh", r["ms"], r["plain_ms"], r["library_ms"],
            r["bound_ms"], r["bound_by"]))
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
        del case
    if failed:
        raise SystemExit("kernels disagree with their plain versions: "
                         + "; ".join(failed))
    return rows


def new_row(name, ms, plain_ms, library_ms, bound_ms, bound_by) -> dict:
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    return {"name": name, "route": "cuda", "source": kc.SOURCES[name],
            "replaces": kc.REPLACES[name], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def drive_op_functions(dev) -> dict:
    """2': the op functions of #17, #18, #5 and #11 at the shapes of their
    phase-2 cases, counts set to 0 just before and read just after; each
    output against its plain version (bf16 operands, fp32 products) within
    the phase-2 bounds. #17 once more with its switch off: no launch."""
    from tooncrafter_tpu_torch.ops import cross_attention as ca
    from tooncrafter_tpu_torch.ops import flash_attention as fa
    from tooncrafter_tpu_torch.ops import stats as st
    from tooncrafter_tpu_torch.ops import temporal_attention as ta
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    gen = torch.Generator(device=dev).manual_seed(1)
    calls = []  # (what, fn, plain) with the operands bound
    for label, sq, c in kc.ATTN2_512:
        ops = kc.dual_operands(dev, gen, sq, c)
        gate = torch.tensor(kc.DUAL_S_IP, device=dev)  # a learnable gate
        calls.append((f"dual_cross_attention attn2 {label} Sq={sq} C={c}",
                      lambda o=ops, g=gate, c=c: ca.dual_cross_attention(
                          *o, g, c // 64),
                      lambda o=ops, c=c: ca._plain_dual(
                          *(t.float() for t in o), kc.DUAL_S_IP, c // 64,
                          0.125, cdt=torch.bfloat16)))
    for label, (n, s, c), _ in kc.STATS_512[:6]:
        x = kc._rnd(gen, dev, n, 16, s // 16, c, scale=2.0, offset=0.5)
        calls.append((f"channel_sums {label} (N, 16, S/16, C)",
                      lambda x=x: st.channel_sums(x),
                      lambda x=x: kc.sums_reference(x.flatten(1, 2))))
    for label, b, s, c, _ in kc.ONES_SHAPES:
        qkv = kc._rnd(gen, dev, b, s, 3 * c)
        ops = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
        calls.append((f"_flash_mh_ones {label} S={s} C={c}",
                      lambda o=ops, c=c: fa._flash_mh_ones(*o, c // 64,
                                                           0.125),
                      lambda o=ops, c=c: fa._plain_mh_ones(
                          *(t.float() for t in o), c // 64, 0.125,
                          cdt=torch.bfloat16)))
    for label, t, p, inner, heads in kc.PTC_512:
        qkv = kc._rnd(gen, dev, 2, t, p, 3 * inner)
        q, k, v = qkv.chunk(3, dim=-1)
        d = inner // heads
        calls.append((f"temporal_attention_ptc {label} T={t} P={p}",
                      lambda q=q, k=k, v=v, h=heads, d=d:
                      ta.temporal_attention_ptc(q, k, v, heads=h,
                                                scale=d ** -0.5),
                      lambda q=q, k=k, v=v, h=heads, d=d: ta._xla_ptc(
                          q.float(), k.float(), v.float(), h, d ** -0.5,
                          cdt=torch.bfloat16)))
    saved = ca._DUAL_CROSS_PALLAS
    ca._DUAL_CROSS_PALLAS = True
    try:
        kc.reset_launch_counts()
        outs = [fn() for _, fn, _ in calls]
        torch.cuda.synchronize()
        counts = kc.launch_counts()
    finally:
        ca._DUAL_CROSS_PALLAS = saved
    print(f"2' op functions: kernel launches {counts}", flush=True)
    failed = []
    for (what, _, plain), got in zip(calls, outs):
        with kc.fp32_reference():
            ref = plain()
        if isinstance(ref, tuple):
            row = kc._sums_row(got, ref)
        else:
            row = kc._output_row((got,), ref, None)
        print(f"2' {what}: max_abs_err {row['max_abs_err']:.3e}"
              + (f" (rel {row['rel_err']:.3e})" if "rel_err" in row else
                 f" (bound {row['max_bound']:.3e})")
              + (" ok" if row["ok"] else " FAIL"), flush=True)
        if not row["ok"]:
            failed.append(what)
    del outs
    ca._DUAL_CROSS_PALLAS = False
    kc.reset_launch_counts()
    for what, fn, _ in calls[:len(kc.ATTN2_512)]:
        fn()
    torch.cuda.synchronize()
    off = kc.launch_counts()["_dual_kernel_call"]
    ca._DUAL_CROSS_PALLAS = saved
    print(f"2' dual_cross_attention with TC_DUAL_CROSS_PALLAS off: "
          f"_dual_kernel_call launches {off}", flush=True)
    want = {"_dual_kernel_call": len(kc.ATTN2_512),
            "_pallas_sums": len(kc.STATS_512[:6]),
            "_flash_mh_ones": len(kc.ONES_SHAPES),
            "_ptc_kernel_call": len(kc.PTC_512)}
    others = {k: v for k, v in counts.items() if v and k not in want}
    if failed or off or others or any(counts[k] != v
                                      for k, v in want.items()):
        raise SystemExit(f"2': outputs off their plain versions {failed}, "
                         f"launches {counts} (want {want}), {off} launches "
                         f"with the switch off")
    return counts


def check_per_item_noise(dev) -> dict:
    """3a'': the reduced model in bf16 on the card, DDIM-3 at eta 1 with a
    sampled posterior: one batch of two clips with per-item generators
    (``utils/rngs.py``) against each clip alone with its own generator.
    Held to the card's floor for that comparison: the same two runs with
    nothing drawn (eta 0, the posterior's mode, each clip's x_T given),
    where only the bf16 numerics' dependence on the batch size separates
    them (torch's reductions, cuBLAS and cuDNN pick their summation order
    by shape). One generator for the whole batch, as before the per-item
    draws, must fall far below: clip 1's noise then follows clip 0's."""
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.utils import rngs as R
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(reduced_config(ModelConfig()),
                              compute_dtype=torch.bfloat16)
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(1))
    model.to_compute_dtype().eval()
    inputs = [small_inputs(cfg, seed, dev) for seed in (2, 3)]
    batch = [torch.cat(parts) for parts in zip(*inputs)]

    def against_alone(pipe, both, alone_kw):
        return [psnr(both[i:i + 1], pipe(*inputs[i][:4], **alone_kw(i)))
                for i in range(2)]
    pipe = Pipeline(model, ddim_steps=3, eta=1.0, perframe_ae=True)
    per_item = against_alone(
        pipe, pipe(*batch[:4], generator=R.per_item_generators(
            SEED, [0, 1], dev)),
        lambda i: {"generator": R.per_item_generators(SEED, [i], dev)})
    shared = against_alone(
        pipe, pipe(*batch[:4], generator=torch.Generator(dev).manual_seed(
            SEED)),
        lambda i: {"generator": torch.Generator(dev).manual_seed(SEED)})
    still = Pipeline(model, ddim_steps=3, eta=0.0, perframe_ae=True)
    floor = against_alone(still, still(*batch[:4], x_T=batch[4]),
                          lambda i: {"x_T": inputs[i][4]})
    out = {"per_item_db": min(per_item), "floor_db": min(floor),
           "shared_db": shared[1]}
    print(f"per-item noise, a batch of two clips against each alone: min "
          f"PSNR {out['per_item_db']:.2f} dB (clips "
          f"{', '.join(f'{d:.2f}' for d in per_item)}); with nothing drawn "
          f"(the card's bf16 floor for B = 2 against B = 1) "
          f"{out['floor_db']:.2f} dB; one generator for the batch, clip 1: "
          f"{out['shared_db']:.2f} dB", flush=True)
    if (out["per_item_db"] < out["floor_db"] - PER_ITEM_MARGIN_DB
            or out["shared_db"] > out["per_item_db"] - PER_ITEM_MARGIN_DB):
        raise SystemExit(
            f"per-item noise: a batched clip is more than "
            f"{PER_ITEM_MARGIN_DB} dB below the numerics' floor, or the "
            f"whole-batch draw is not {PER_ITEM_MARGIN_DB} dB below it")
    return out


def reduced_config(base):
    """A small configuration whose shapes still reach every kernel: UNet ds1
    c=320 with S=1536 (packed) and its FF, ds2 c=640 with S=384 (mh) and
    its FF, the init attention's FF at c=512 (streamed), the temporal
    attention pair over T=4 frames (whole pixels per m16 tile, masked) at
    320, 512, 640 and the mid block's 1280 channels, a ds4 level at
    c=1280 whose 8x12 frames are a ragged 96-pixel tile for the convs and
    the temporal convs (its mid-block FF streamed), the decoder's fusion at
    64x96 (Sk=12288, two-pass) and 32x48, its TimeStacks (temporal conv at
    32-512 channels) and a 512-channel VAE mid attention (d=512)."""
    return base.tiny(
        latent_h=32, latent_w=48, model_channels=320, num_res_blocks=1,
        channel_mult=(1, 2, 4), attention_resolutions=(1, 2),
        num_head_channels=64, vae_ch=32, vae_ch_mult=(1, 2, 4, 16))


@contextlib.contextmanager
def record_pixels():
    """The pixel count per image of every conv and temporal-conv launch."""
    from tooncrafter_tpu_torch.ops import spatial_conv as sc
    from tooncrafter_tpu_torch.ops import temporal_conv as tc

    seen = {"winograd_gn_silu_conv3x3": [], "_pallas_tconv": []}
    conv, tconv = sc._launch_conv, tc._launch_tconv

    def conv_rec(x, *args, **kw):
        seen["winograd_gn_silu_conv3x3"].append(x.shape[1] * x.shape[2])
        return conv(x, *args, **kw)

    def tconv_rec(x, *args, **kw):
        seen["_pallas_tconv"].append(x.shape[2])
        return tconv(x, *args, **kw)

    sc._launch_conv, tc._launch_tconv = conv_rec, tconv_rec
    try:
        yield seen
    finally:
        sc._launch_conv, tc._launch_tconv = conv, tconv


def small_inputs(cfg, seed, device):
    g = torch.Generator().manual_seed(seed)
    t, h, w = cfg.video_length, cfg.latent_h * 8, cfg.latent_w * 8
    a = torch.rand(1, 1, h, w, 3, generator=g) * 2 - 1
    b = torch.rand(1, 1, h, w, 3, generator=g) * 2 - 1
    video = torch.cat([a.expand(1, t // 2, h, w, 3),
                       b.expand(1, t - t // 2, h, w, 3)], dim=1)
    tokens = torch.randint(0, 49408, (1, 77), generator=g)
    x_T = torch.randn(1, t, cfg.latent_h, cfg.latent_w, cfg.z_channels,
                      generator=g)
    fs = torch.full((1,), float(cfg.default_fs))  # the YAML's frame stride
    return [x.to(device) for x in (video, tokens, torch.zeros_like(tokens),
                                   fs, x_T)]


def check_reduced_model(dev, kernels=KERNELS_512) -> dict:
    """The same reduced model and inputs through the Pipeline on the card
    (bf16, CUDA kernels) and on the CPU (fp32, plain versions); every
    kernel of ``kernels`` must launch. Returns, per conv kernel, the pixel
    counts it was launched at with a ragged last tile."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.ops import _launch
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = reduced_config(ModelConfig())
    cpu_model = ToonCrafter(cfg)
    init_random_(cpu_model, torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gpu_model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    gpu_model.to_compute_dtype()
    outs = {}
    for name, model, device in (("cpu", cpu_model.eval(), "cpu"),
                                ("gpu", gpu_model.eval(), dev)):
        pipe = Pipeline(model, ddim_steps=3, eta=0.0, perframe_ae=True)
        video, tokens, null, fs, x_T = small_inputs(cfg, 2, device)
        kc.reset_launch_counts()
        with record_pixels() as pixels:
            outs[name] = pipe(video, tokens, null, fs, x_T=x_T).float().cpu()
        if name == "gpu":
            hit = kc.launch_counts()
    err = (outs["gpu"] - outs["cpu"]).abs()
    db = psnr(outs["gpu"], outs["cpu"])
    print(f"reduced model {cfg.latent_h * 8}x{cfg.latent_w * 8}x"
          f"{cfg.video_length}: card bf16 vs CPU fp32 min PSNR {db:.2f} dB"
          f", max_abs_err {err.max().item():.4e}, output range "
          f"[{outs['cpu'].min().item():.3f}, {outs['cpu'].max().item():.3f}]"
          f", kernel launches {hit}", flush=True)
    ragged = {k: sorted({p for p in v if p % _launch.pixel_tile(p)})
              for k, v in pixels.items()}
    print(f"reduced model: pixel counts with a ragged last tile {ragged}",
          flush=True)
    if not (db >= REDUCED_MIN_PSNR and all(hit[k] for k in kernels)):
        raise SystemExit("reduced model: the card disagrees with the CPU or "
                         "a kernel was not reached")
    return ragged


def answer_requests(dev, ddim_steps: int, yaml: str, n_requests: int,
                    kernels):
    """Full-width requests (16 frames) of the model in ``yaml`` through the
    port's Pipeline, at the YAML's ``default_fs``; exits if a kernel of
    ``kernels`` was never launched. Returns the launch counts over the
    requests, the pipeline, the requests and their clips."""
    import dataclasses

    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(
        model_config_from_yaml(os.path.join(REPO, "configs", yaml)),
        compute_dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    model.to_compute_dtype().eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"full-width model {yaml} ({cfg.latent_h * 8}x{cfg.latent_w * 8}, "
          f"base_scale {cfg.base_scale}): {n_params / 1e9:.3f} B parameters,"
          f" built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)
    pipe = Pipeline(model, ddim_steps=ddim_steps, eta=1.0,
                    spacing="uniform_trailing",
                    guidance=GuidanceConfig(cfg_scale=7.5,
                                            guidance_rescale=0.7),
                    perframe_ae=cfg.perframe_ae)
    requests = [small_inputs(cfg, 10 + r, dev)[:4] for r in range(n_requests)]
    counts, outs = _serve(pipe, requests, dev)
    _check_outputs(cfg, outs)
    missed = [k for k in kernels if not counts[k]]
    if missed:
        raise SystemExit(f"{yaml}: kernels {missed} never launched")
    return counts, pipe, requests, outs


def _serve(pipe, requests, dev):
    """Answer ``requests`` in turn (the generator seeded anew); the launch
    counts over them and the clips."""
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    kc.reset_launch_counts()
    outs = []
    for r, (video, tokens, null, fs) in enumerate(requests):
        t0 = time.perf_counter()
        outs.append(pipe(video, tokens, null, fs, generator=gen))
        torch.cuda.synchronize()
        print(f"request {r} (fs {fs.item():.0f}): "
              f"{time.perf_counter() - t0:.2f} s; phase seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in pipe.timings.items()),
              flush=True)
    counts = kc.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"peak memory allocated {peak:.2f} GiB; kernel launches {counts}",
          flush=True)
    return counts, outs


def _check_outputs(cfg, outs) -> None:
    for r, out in enumerate(outs):
        lo, hi = out.min().item(), out.max().item()
        print(f"request {r}: output {tuple(out.shape)} range "
              f"[{lo:.3f}, {hi:.3f}]", flush=True)
        want = (1, cfg.video_length, cfg.latent_h * 8, cfg.latent_w * 8, 3)
        if tuple(out.shape) != want or not torch.isfinite(out).all():
            raise SystemExit(f"request {r}: bad output shape or non-finite")
        if max(abs(lo), abs(hi)) > OUTPUT_MAX_ABS:
            raise SystemExit(f"request {r}: output outside "
                             f"+-{OUTPUT_MAX_ABS}")


class _KeptDropout(torch.nn.Dropout):
    """A dropout that passes its input through but keeps its p, so the
    UNet still takes its training branch: the card and the CPU then see
    the same (no) masks."""

    def forward(self, x):
        return x


def _keep_dropout(model) -> None:
    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if type(child) is torch.nn.Dropout and child.p > 0:
                setattr(mod, name, _KeptDropout(child.p))


def check_reduced_training(dev, kernels=TRAIN_KERNELS) -> None:
    """The reduced model's trainable gradients: card (bf16 autocast over
    fp32 weights, the kernels and #6) against CPU (fp32, plain versions),
    on the same weights, batch and draws, dropout kept out of both."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(reduced_config(ModelConfig()),
                              use_checkpoint=True, remat_policy="dots")
    cpu_model = ToonCrafter(cfg)
    init_random_(cpu_model, torch.Generator().manual_seed(1))
    _keep_dropout(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gpu_model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    batch = random_batch(cfg, 2, 4, "cpu")
    draws = T.sample_draws(cpu_model, batch["video"],
                           torch.Generator().manual_seed(5))
    draws["rand"] = torch.tensor([0.5, 0.07])  # one clip keeps its text
    grads = {}
    for name, model, device in (("cpu", cpu_model, "cpu"),
                                ("gpu", gpu_model, dev)):
        train, _ = T.split_trainable(model)
        kc.reset_launch_counts()
        b = {k: v.to(device) for k, v in batch.items()}
        with T.autocast(model, torch.device(device)):
            loss, _ = T.diffusion_loss(model, b, draws=draws, train=True)
        loss.backward()
        if name == "gpu":
            torch.cuda.synchronize()
            hit = kc.launch_counts()
        grads[name] = {k: p.grad.float().cpu() for k, p in train.items()}
        print(f"reduced training model on the {name}: loss "
              f"{loss.item():.6f}", flush=True)
    names = sorted(grads["cpu"])
    flat = {k: torch.cat([grads[k][n].flatten() for n in names]).double()
            for k in grads}
    cos = (flat["gpu"] @ flat["cpu"]
           / (flat["gpu"].norm() * flat["cpu"].norm())).item()
    rel = {n: ((grads["gpu"][n] - grads["cpu"][n]).norm()
               / grads["cpu"][n].norm().clamp_min(1e-30)).item()
           for n in names}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    print(f"reduced training model {cfg.latent_h * 8}x{cfg.latent_w * 8}x"
          f"{cfg.video_length}, B=2: {len(names)} trainable tensors, "
          f"gradient cosine {cos:.6f} (bound >= {GRAD_MIN_COSINE}), "
          f"largest per-tensor relative L2 error {worst[0][1]:.4f} (bound "
          f"{GRAD_MAX_REL_L2}); worst {worst}; kernel launches {hit}",
          flush=True)
    missed = [k for k in kernels if not hit[k]]
    if cos < GRAD_MIN_COSINE or worst[0][1] > GRAD_MAX_REL_L2 or missed:
        raise SystemExit(f"reduced training model: card gradients disagree "
                         f"with the CPU's, or kernels {missed} not reached")


def train_full_width(dev, steps: int = TRAIN_STEPS,
                     kernels=TRAIN_KERNELS):
    """``steps`` AdamW steps of the 512 training model at full width;
    returns the launch counts over the steps, each step's seconds and the
    peak memory (GiB). With #16 among ``kernels``, then counts its
    launches in one forward of the loss (a step also recomputes the
    checkpointed blocks' forward in its backward)."""
    import dataclasses

    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(
        model_config_from_yaml(os.path.join(
            REPO, "configs", "training_512_v1.0.yaml")),
        compute_dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.manual_seed(SEED)  # dropout's stream
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    tcfg = T.TrainConfig(learning_rate=1e-5 * 2)
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    step_fn = T.make_train_step(model, opt, tcfg)
    n_train = sum(p.numel() for p in state.train_params.values())
    torch.cuda.synchronize()
    print(f"training model (use_checkpoint={cfg.use_checkpoint}, "
          f"remat_policy={cfg.remat_policy}): {n_train / 1e9:.3f} B "
          f"trainable of {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f" B parameters, AdamW + EMA, built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)
    grad_seen = {}

    def seen(name):
        def hook(p):
            flag = (p.grad != 0).any()
            grad_seen[name] = flag | grad_seen.get(name, flag)
        return hook
    hooks = [p.register_post_accumulate_grad_hook(seen(n))
             for n, p in state.train_params.items()]
    ema0 = {k: e.double().sum() for k, e in state.ema_params.items()}
    batch = random_batch(cfg, 2, SEED, dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    total = dict.fromkeys(kc.launch_counts(), 0)
    seconds = []
    for i in range(steps):
        kc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        seconds.append(dt)
        counts = kc.launch_counts()
        for k, v in counts.items():
            total[k] += v
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"train step {i}: {dt:.2f} s, loss {loss:.6f}, grad_norm "
              f"{gnorm:.6f}, t {float(metrics['t_mean']):.0f}; launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
              flush=True)
        if not (torch.isfinite(torch.tensor([loss, gnorm])).all()):
            raise SystemExit(f"train step {i}: non-finite loss or grad_norm")
    for h in hooks:
        h.remove()
    zero = [n for n in state.train_params if not bool(grad_seen.get(n))]
    still = [k for k, e in state.ema_params.items()
             if e.double().sum() == ema0[k]]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"training: peak memory allocated {peak:.2f} GiB; "
          f"{len(state.train_params) - len(zero)} of "
          f"{len(state.train_params)} trainable tensors got a non-zero "
          f"gradient; EMA shadow moved on {len(ema0) - len(still)} of "
          f"{len(ema0)}", flush=True)
    if zero or still:
        raise SystemExit(f"training: zero gradients {zero[:5]} or an EMA "
                         f"that did not move {still[:5]}")
    missed = [k for k in kernels if not total[k]]
    if missed:
        raise SystemExit(f"training: kernels {missed} never launched")
    if "_pallas_gn" in kernels:
        kc.reset_launch_counts()
        with T.autocast(model, dev):
            loss, _ = T.diffusion_loss(model, batch, gen, train=True)
        torch.cuda.synchronize()
        print(f"training: _pallas_gn launches in one forward of the loss "
              f"{kc.launch_counts()['_pallas_gn']}", flush=True)
        del loss
    return total, seconds, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ddim_steps", type=int, default=50)
    args = ap.parse_args(argv)

    phase("0 device")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, REPO)
    from tooncrafter_tpu_torch.ops import _build
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    phase("1 build")
    t0 = time.perf_counter()
    nvcc = kc.build_all()
    print(f"built {len(nvcc)} libraries in {time.perf_counter() - t0:.1f} s"
          " (nvcc " + ", ".join(f"{k} {v:.1f} s" for k, v in nvcc.items())
          + ")", flush=True)
    for name in nvcc:
        log = _build.lib_path(name, kc.LIBRARIES[name]).with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: "
                      + line.strip().removeprefix("ptxas info    : "))

    phase("2 kernels against their plain versions")
    rows = check_kernels(dev)
    phase("2' the op functions of the kernels no model reaches")
    counts_ops = drive_op_functions(dev)
    phase("3a reduced model: card against CPU")
    if not all(check_reduced_model(dev).values()):
        raise SystemExit("reduced model: no conv launched at a ragged tile")
    phase("3a'' per-item noise: a batch of two against each clip alone")
    check_per_item_noise(dev)
    phase("3a' reduced model with the three switches on: card against CPU")
    with switches():
        check_reduced_model(dev, KERNELS_SWITCHED)
    phase(f"3b two full-width requests, DDIM-{args.ddim_steps}")
    counts, pipe, requests, clips = answer_requests(
        dev, args.ddim_steps, "inference_512_v1.0.yaml", 2, KERNELS_512)
    phase(f"3d one full-width request with the three switches on, "
          f"DDIM-{args.ddim_steps}")
    with switches():
        counts_sw, clips_sw = _serve(pipe, requests[:1], dev)
    _check_outputs(pipe.model.config, clips_sw)
    print(f"3d against 3b's first clip (same weights, seed and inputs): "
          f"min PSNR {psnr(clips_sw[0], clips[0]):.2f} dB", flush=True)
    missed = [k for k in KERNELS_SWITCHED if not counts_sw[k]]
    if missed or counts_sw["_fused_tpair_call"]:
        raise SystemExit(f"3d: kernels {missed} never launched, or the pair "
                         f"launched {counts_sw['_fused_tpair_call']} times")
    del pipe, requests, clips, clips_sw
    phase(f"3c one full-width 576x1024 request, DDIM-{args.ddim_steps}")
    counts_1024 = answer_requests(dev, args.ddim_steps,
                                  "inference_1024_v1.0.yaml", 1,
                                  KERNELS_1024)[0]
    phase("4a reduced training model: card gradients against CPU")
    check_reduced_training(dev)
    phase(f"4b full-width training, {TRAIN_STEPS} steps")
    train_counts, train_s, train_peak = train_full_width(dev)
    phase("4a' reduced training model with TOONCRAFTER_FUSED_GN=1: card "
          "gradients against CPU")
    with switches(pair=True, spatial_conv_pallas=False):
        check_reduced_training(dev, TRAIN_KERNELS_SWITCHED)
    phase(f"4b' full-width training with TOONCRAFTER_FUSED_GN=1, "
          f"{TRAIN_STEPS_SWITCHED} steps")
    with switches(pair=True, spatial_conv_pallas=False):
        train_sw, sw_s, sw_peak = train_full_width(
            dev, TRAIN_STEPS_SWITCHED, TRAIN_KERNELS_SWITCHED)
    print(f"4b' beside 4b: _pallas_gn launches per step "
          f"{train_sw['_pallas_gn'] / TRAIN_STEPS_SWITCHED:.0f} (the "
          f"checkpointed blocks' recomputation included) against 0; step "
          f"seconds {', '.join(f'{t:.2f}' for t in sw_s)} against "
          f"{', '.join(f'{t:.2f}' for t in train_s)}; peak {sw_peak:.2f} "
          f"GiB against {train_peak:.2f}", flush=True)
    summary = []
    paths = (counts, counts_1024, train_counts, counts_sw, train_sw,
             counts_ops)
    in_models = {k: [c[k] for c in paths[:-1]]
                 for k in ("_dual_kernel_call", "_pallas_sums",
                           "_flash_mh_ones")}
    if any(any(v) for v in in_models.values()):
        raise SystemExit(f"a model phase launched a kernel no model reaches: "
                         f"{in_models}")
    for name, row in rows.items():
        # each kernel's launches on the first path that runs it: two
        # 320x512 requests, else the 576x1024 request, else training, else
        # the switched request (3d), else the switched training steps
        # (4b'), else the op functions (2')
        row["launches"] = next((c[name] for c in paths if c[name]), 0)
        row["launches_512"] = counts[name]
        row["launches_1024"] = counts_1024[name]
        row["launches_train"] = train_counts[name]
        row["launches_512_switched"] = counts_sw[name]
        row["launches_train_switched"] = train_sw[name]
        row["launches_ops"] = counts_ops[name]
        summary.append(row)
    missed = [r["name"] for r in summary if not r["launches"]]
    if missed or len(summary) != len(kc.REPLACES):
        raise SystemExit(f"kernels {missed} launched on no path, or "
                         f"{len(summary)} rows for {len(kc.REPLACES)} TPU "
                         f"kernels")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
