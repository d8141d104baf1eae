"""On-card smoke test of the PyTorch port (tooncrafter_tpu_torch) on one GPU.

    python3 chip_smoke.py [--ddim_steps 50]

Phases, each printed on its own lines; any failure exits non-zero:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from tooncrafter_tpu_torch/csrc (one nvcc per
     library, all at once) and print each one's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the 320x512 interpolation path gives it, then at the 576x1024
     path's most-launched shapes (the VAE mid attention at both its
     decoder and per-frame encoder shapes), the stem's one-clip shapes of
     both paths, the F(2x2)- and F(2x4)-named convs at the fp32 cast point
     (TC_PROLOGUE_DTYPE=f32), the switched path's (the
     one-pass GroupNorm at every shape it launches with, in inference and
     training, and at two samples no cluster holds: its L2 branch), and
     the shapes the
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
  3. (every model phase runs the main path as ToonCrafter runs it: the
     per-channel sums chained across blocks, the UNet's CFG stem on one
     clip's rows) check a reduced model on the card against the same model
     on the CPU (every kernel reached, the convs at a ragged pixel tile), and
     a batch
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
     seconds per phase, peak memory and launches per kernel; after 3b, for
     one UNet call and one decode, how many norms read their input for
     statistics (and how many on the parent's route), and after 3b and 3c
     the UNet step's and the decode's norm and elementwise device ms
     (``utils/profiling.inference_breakdown``);
  3a', 3d. the JAX package's three opt-in switches on (TC_TATTN_PAIR=0,
     TC_SPATIAL_CONV_PALLAS=1, TOONCRAFTER_FUSED_GN=1, set as the port's
     module globals): the reduced model card against CPU again, then one
     full-width 320x512 request with 3b's model, seed and inputs (the pair
     at 0 launches; the single-stage temporal attention, the im2col-named
     conv and the one-pass GroupNorm launched), its PSNR against 3b's
     first clip printed;
  3h. the conv switches one at a time (TC_WINOGRAD=0, TC_WINOGRAD24=0,
     TC_PROLOGUE_DTYPE=f32, TC_PROLOGUE_DTYPE=bf16, TC_STATS_SQ_BF16=1, as
     module globals through ``switches()``): 3a's reduced model on the card
     against 3a's CPU clip at 3a's bound with the conv launches the JAX
     rule predicts, then
     one conv at every Winograd table shape (the named kernel against its
     plain version at the setting's cast point; under "bf16" no launch);
  3i. the reduced UNet with relative-position temporal attention, one
     denoise call card against CPU;
  3j. the native host preprocessing (``tooncrafter_tpu_torch/native``,
     built with g++ on the machine): a 16-frame 720x1280 uint8 clip to
     320x512 against its numpy plain version, timed;
  3e. serving: one ``cli/serve.Image2Video`` resident on the card at the
     full 512 YAML answers three requests from 480x640 uint8 frames (an
     interpolation at DDIM --ddim_steps, the same again through the cached
     pipeline, a single-image "repeat" request at DDIM-10 and eta 0), each
     launching every kernel of the 320x512 path, the second equal to the
     first bit for bit, the allocated memory flat, each clip written;
  3f. the dual-ref decoder's 'attn-only' and 'all' time modes: a reduced
     decoder in bf16 on the card against fp32 on the CPU, then one
     full-width 320x512 decode of each, every flash launch at a shape
     phase 2 checks;
  3g. ``ddpm_sample`` (a 4-step schedule) and ``decode_plain`` on a
     reduced plain-decoder model, card against CPU (the CPU's noise);
     then ``cli/smoke.py`` on the card;
  4. training, the UNet on its training branch (dropout 0.1: the ResBlock
     convs through the 3x3 conv kernel where the JAX package's tables take
     one, the temporal convs through #12, each under autograd through its
     Function; phase 2 holds both Functions' outputs and gradients at the
     512 and 1024 training shapes): 4a a reduced model's UNet and
     image_proj gradients in bf16 on the card against the same model's
     fp32 gradients on the CPU (same weights, same draws, the dropout
     modules passing their input through), then again at the 512 model's ds2 and ds4 shapes (#13); 4b
     the full-width 320x512 training model (configs/training_512_v1.0.yaml:
     per-block checkpointing with the 'dots' policy) with random weights
     from a fixed seed takes three AdamW steps with EMA on a batch of two
     16x320x512 clips through ``make_train_step``, every step launching
     every kernel of TRAIN_KERNELS, with the step seconds and the peak
     memory, then two steps each with the 'adamw_lowmem' and 'adafactor'
     profiles (their state bytes and peaks); 4d on that model
     ``make_val_step`` with the EMA weights and one ``VideoSampleLogger``
     clip (DDIM-2), finite and written; 4a' (on ``shallow_config``) and
     4b' the same under TOONCRAFTER_FUSED_GN=1 and TC_SPATIAL_CONV_PALLAS=1
     (#16 and #15); 4c
     the 576x1024 training model (configs/training_1024_v1.0.yaml, one
     clip) takes three AdamW steps with EMA, #14 launched in each;
  5. multi-device (``parallel/`` over torch.distributed): 5a a process
     group of one over NCCL: the 512 training model's all-reduced
     gradients against one process's (same weights, draws and
     pass-through dropout), then two AdamW steps with the optimizer state
     split by owner, every step launching TRAIN_KERNELS, their seconds and
     peak beside 4b's; 5b two spawned ranks sharing cuda:0 over gloo (the
     compute mode must be Default), the reduced training model: the
     reduced gradients against one process with the batch of two on the
     card (4a's bounds), two AdamW steps and one adafactor step with the
     ranks' trainables equal bit for bit after each, every rank launching
     REDUCED_TRAIN_KERNELS; 5c two ranks sharing cuda:0 over gloo serve
     three 512 clips through ``BatchedPipeline`` (ragged: two and one,
     DDIM-4, per-item generators), held against one process running the
     same micro-batches, every rank launching KERNELS_512; 5d
     ``graft_entry.entry("cuda")``'s UNet forward, finite, of the latent
     shape, and ``graft_entry.dryrun_multidevice(2, "cuda")`` (a train
     step, validation and DDIM-2 serving at the tiny config on two ranks
     sharing the card, its values finite). Tensor parallelism over the
     mesh's model axis (``parallel/tensor.py``: the UNet's transformer
     blocks hold a model rank's heads and FF width; phase 2 holds the FF
     (#7/#8) and the single temporal stage (#10) with their partial fp32
     out-GEMM and #1 at a rank's local shapes): 5e one CFG-batched UNet
     call of the full-width 512 inference model at (1 data, 2 model) on
     two ranks sharing the card, against the same call at world one (PSNR
     >= TP_MIN_PSNR), each rank's launches the layout's prediction (the
     pair's launches as twice as many single stages); 5f two AdamW steps of
     the reduced training model at (1, 2) against world one (the gathered
     gradients' cosine >= TP_GRAD_MIN_COSINE, the updates' cosine >=
     TP_UPDATE_MIN_COSINE), its checkpoint restored at (1, 1); 5g four
     ranks at (2, 2): ``BatchedPipeline(shard_params=True)`` serves three
     reduced-model clips at DDIM-2 (ragged: two and one) against one
     process (>= TP_SERVE_MIN_PSNR), then the graft dry run at (2, 2). A
     rank that raises, exits non-zero or outlives RANK_TIMEOUT_S fails the
     run.
No model phase launches #5, #17 or #18. The last two lines are the
kernels' JSON summary (``launches`` from the first path that runs the
kernel: 3b, else 3c, else 4b, else 3d, else 4b', else 4c, else the paths
of 3e, 3f and 5, else 2'; and each path's count, 3e's, 3f's, 5a's and
each rank's of 5b, 5c, 5e, 5f and 5g too) and the device JSON.
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

import numpy as np
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
# the kernels every training step of the 512 model launches: the training
# branch's temporal convs (#12) and its ResBlock convs at the JAX tables'
# shapes (#13) too
TRAIN_KERNELS = ("_flash_mh_packed", "_flash_mh", "_pallas_ff",
                 "_pallas_ff_streamed", "_fused_tpair_call", "_flash_bwd_bh",
                 "_pallas_tconv", "winograd_gn_silu_conv3x3")
# the reduced training model's: its ResBlock convs meet no JAX table
REDUCED_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS
                              if k != "winograd_gn_silu_conv3x3")
# 4a's second run: the reduced model at the 512 model's ds2 and ds4 shapes
TABLE_TRAIN_KERNELS = ("_pallas_tconv", "winograd_gn_silu_conv3x3")
# the low-memory optimizer profiles, two steps each after 4b's AdamW steps
PROFILE_STEPS = 2
# 4c: the 576x1024 training model (configs/training_1024_v1.0.yaml)
TRAIN_STEPS_1024 = 3
TRAIN_KERNELS_1024 = ("_flash_mh", "_flash_bh_with_lse", "_pallas_ff",
                      "_pallas_ff_streamed", "_fused_tpair_call",
                      "_flash_bwd_bh", "_pallas_tconv",
                      "winograd_gn_silu_conv3x3",
                      "winograd24_gn_silu_conv3x3")
# 4d: the sampled clip's DDIM steps
SAMPLE_DDIM_STEPS = 2
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
# under TC_SPATIAL_CONV_PALLAS=1 the training branch's convs outside the
# tables take #15 (the reduced model's too)
TRAIN_KERNELS_SWITCHED = TRAIN_KERNELS + ("_pallas_gn", "_pallas_fused_conv")
REDUCED_TRAIN_KERNELS_SWITCHED = REDUCED_TRAIN_KERNELS + (
    "_pallas_gn", "_pallas_fused_conv")
TRAIN_STEPS_SWITCHED = 2
# the kernels no model reaches, driven through their op functions (2')
OP_KERNELS = ("_dual_kernel_call", "_pallas_sums", "_flash_mh_ones",
              "_ptc_kernel_call")
# 3e: the allocated memory after the third request may differ from its
# value after the first by this much (the weights stay resident and
# nothing accumulates; a request's own tensors are freed)
SERVE_MEMORY_SLACK_MIB = 8.0
SERVE_REPEAT_STEPS = 10
DDPM_STEPS = 4
# 3f's and 3g's reduced models run on the CPU too: a quarter of 3a's pixels
SMALL_LATENT = (16, 24)
# the flash kernels' (BH, Sq, Sk, D) that phase 2 checks
FLASH_CHECKED = set()
# phase 5 (multi-device): 5a's distributed gradient at world 1 against one
# process's (the same weights, draws and pass-through dropout; #6's dq sums
# in another order each run), its AdamW steps after; 5b's two ranks' steps
# (two AdamW, one adafactor); 5c's DDIM steps and its clips' floor where a
# second process picks other library algorithms than the first
WORLD1_MIN_COSINE = 0.9999
WORLD1_STEPS = 2
RANK_PROFILES = (("adamw", 2), ("adafactor", 1))
SERVE_DDIM_STEPS = 4
SERVE_MIN_PSNR = 40.0
# a spawned rank that runs longer than this fails its phase
RANK_TIMEOUT_S = 300.0
# tensor parallelism: 5e's UNet call at (1, 2) against world one, both bf16
# on the card (the sharded sub-blocks sum their heads in fp32 in another
# order, and their partial products reach bf16 once, after the sum); 5f's
# gathered gradients and the updates of two AdamW steps against world one
# (AdamW's first steps move each weight by about the learning rate times
# the sign of its gradient, so a gradient within bf16 noise of zero may
# flip its update); 5g's served clips against one process
TP_MIN_PSNR = 40.0
TP_GRAD_MIN_COSINE = 0.999
TP_UPDATE_MIN_COSINE = 0.9
# 5g: the reduced random-weight model at CFG 7.5 amplifies bf16 summation
# order into the clips: 3a'' measures 36.7-38.3 dB for a mere batch-size
# change on it (DDIM-3), and the sharded path's fp32 partial sums perturb
# every attention and FF (34.49-35.06 dB measured in two runs, under the
# 35 dB first set); tests/test_torch_tensor_parallel.py holds the sharded
# path as close to fp32 as one process is, in bf16 on the CPU
TP_SERVE_MIN_PSNR = 33.0
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
             fused_gn: bool = True, winograd: bool = True,
             winograd24: bool = True, prologue: str = "ref",
             stats_sq_bf16: bool = False):
    """The JAX package's switches as the port's module globals: by default
    the three opt-in ones on (TC_TATTN_PAIR=0, TC_SPATIAL_CONV_PALLAS=1,
    TOONCRAFTER_FUSED_GN=1) and the conv's four at their defaults
    (TC_WINOGRAD, TC_WINOGRAD24, TC_PROLOGUE_DTYPE, TC_STATS_SQ_BF16)."""
    from tooncrafter_tpu_torch.ops import fused_norms as fn
    from tooncrafter_tpu_torch.ops import spatial_conv as sc
    from tooncrafter_tpu_torch.ops import temporal_attention as ta

    names = ((ta, "_PAIR", pair),
             (sc, "_SPATIAL_CONV_PALLAS", spatial_conv_pallas),
             (fn, "_FUSED_GN", fused_gn), (sc, "_WINOGRAD", winograd),
             (sc, "_WINOGRAD24", winograd24),
             (sc, "_PROLOGUE_DTYPE", prologue),
             (sc, "_STATS_SQ_BF16", stats_sq_bf16))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in names]
    for mod, attr, value in names:
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def psnr(a, b) -> float:
    """Lowest per-frame PSNR (dB) of two clips in [-1, 1]."""
    mse = (a.float() - b.float()).square().mean(dim=(2, 3, 4))
    return (10 * torch.log10(4.0 / mse.clamp_min(1e-12))).min().item()


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    # tensor parallelism: a model rank's 3 or 2 of ds1's 5 heads, packed,
    # routed by the whole call (parallel/tensor.py)
    for heads in (3, 2):
        c = 64 * heads
        cases.append((
            "_flash_mh_packed", f"TP ds1 {heads} of 5 heads B=32 S=2560 "
            f"C={c}", (rnd(32, 2560, 3 * c),),
            lambda qkv, h=heads: fa.flash_attention_packed(qkv, h, 0.125,
                                                           whole_c=320),
            lambda qkv, h=heads: packed_plain(qkv, h),
            lambda qkv, h=heads: packed_sdpa(qkv, h), None, (20, 3),
            (32 * heads, 2560, 2560, 64)))
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
        FLASH_CHECKED.add((bh, sq, sk, d))
        print(f"{line} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
              + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            failed.append(f"{name} {label}")
        row = rows.setdefault(name, new_row(name, ms, plain_ms, library_ms,
                                            bound_ms, bound_by))
        row["max_abs_err"] = max(row["max_abs_err"], mx)
    del cases, args, got, ref, ref_args, qkv
    for cases_of in (kc.fused_cases, kc.fused_cases_1024, kc.chain_cases,
                     kc.switched_cases, kc.op_cases, kc.tp_cases):
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
    # the training branch's convs under autograd: each Function's output
    # and gradients against the plain version and its autograd in fp32
    for case in kc.train_grad_cases(dev):
        r = kc.run_grad_case(case)
        print(kc.grad_line(case, r), flush=True)
        if not r["ok"]:
            failed.append(f"{case.name} forward and backward {case.label}")
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
    straddle the temporal convs' row tiles (its mid-block FF streamed),
    the decoder's fusion at 64x96 (Sk=12288, two-pass) and 32x48, its
    TimeStacks (temporal conv at 32-512 channels) and a 512-channel VAE mid
    attention (d=512)."""
    return base.tiny(
        latent_h=32, latent_w=48, model_channels=320, num_res_blocks=1,
        channel_mult=(1, 2, 4), attention_resolutions=(1, 2),
        num_head_channels=64, vae_ch=32, vae_ch_mult=(1, 2, 4, 16))


def shallow_config(base):
    """``reduced_config`` without its 1280-wide level: the model of 4a' and
    the multi-rank training phases (5b, 5f), cut in depth for the run's time
    limit.
    It still reaches every kernel of REDUCED_TRAIN_KERNELS: ds1 (5 heads)
    packed, ds2 (10 heads, S = 384) token-major, the init attention's FF
    streamed at C = 512, the pair, #6 and #12."""
    import dataclasses

    return dataclasses.replace(reduced_config(base), channel_mult=(1, 2))


@contextlib.contextmanager
def record_pixels():
    """The pixel count per image of every conv launch, and (T, P) of every
    temporal-conv launch."""
    from tooncrafter_tpu_torch.ops import spatial_conv as sc
    from tooncrafter_tpu_torch.ops import temporal_conv as tc

    seen = {"winograd_gn_silu_conv3x3": [], "_pallas_tconv": []}
    conv, tconv = sc._launch_conv, tc._launch_tconv

    def conv_rec(x, *args, **kw):
        seen["winograd_gn_silu_conv3x3"].append(x.shape[1] * x.shape[2])
        return conv(x, *args, **kw)

    def tconv_rec(x, w3, *args, **kw):
        seen["_pallas_tconv"].append(tuple(x.shape) + (w3.shape[0],))
        return tconv(x, w3, *args, **kw)

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


def check_reduced_model(dev, kernels=KERNELS_512, keep=None) -> dict:
    """The same reduced model and inputs through the Pipeline on the card
    (bf16, CUDA kernels) and on the CPU (fp32, plain versions); every
    kernel of ``kernels`` must launch. Returns, per conv kernel, the shapes
    it was launched at with a ragged tile; ``keep`` (a dict), when given,
    receives the config, the card's model and the CPU's clip for 3h."""
    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.ops import _launch
    from tooncrafter_tpu_torch.ops import temporal_conv as tc
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    cfg = reduced_config(ModelConfig())
    cpu_model, gpu_model = _reduced_models(dev, cfg)
    outs = {}
    for name, model, device in (("cpu", cpu_model, "cpu"),
                                ("gpu", gpu_model, dev)):
        kc.reset_launch_counts()
        with record_pixels() as pixels:
            outs[name] = _reduced_clip(model, cfg, device)
        if name == "gpu":
            hit = kc.launch_counts()
    if keep is not None:
        keep.update(cfg=cfg, gpu_model=gpu_model, cpu_clip=outs["cpu"])
    err = (outs["gpu"] - outs["cpu"]).abs()
    db = psnr(outs["gpu"], outs["cpu"])
    print(f"reduced model {cfg.latent_h * 8}x{cfg.latent_w * 8}x"
          f"{cfg.video_length}: card bf16 vs CPU fp32 min PSNR {db:.2f} dB"
          f", max_abs_err {err.max().item():.4e}, output range "
          f"[{outs['cpu'].min().item():.3f}, {outs['cpu'].max().item():.3f}]"
          f", kernel launches {hit}", flush=True)
    # the 3x3 conv: an image's pixels end in a part tile; the temporal
    # conv's GEMM: a row tile spans two frames
    ragged = {"winograd_gn_silu_conv3x3": sorted(
        {p for p in pixels["winograd_gn_silu_conv3x3"]
         if p % _launch.pixel_tile(p)})}
    ragged["_pallas_tconv"] = sorted(
        {(t, p) for b, t, p, cin, cout in pixels["_pallas_tconv"]
         if p % tc.plan(b, t, p, cin, cout).rows})
    print(f"reduced model: pixel counts with a ragged last tile (conv) or "
          f"(T, P) with tiles across frames (temporal conv) {ragged}",
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


def serve_requests(dev, ddim_steps: int,
                   yaml: str = "inference_512_v1.0.yaml",
                   resolution=(320, 512), kernels=KERNELS_512) -> dict:
    """3e: one Image2Video, resident on the card, answers three requests;
    returns the launch counts over them."""
    import numpy as np

    from tooncrafter_tpu_torch.cli.serve import Image2Video
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backend = Image2Video(config_path=os.path.join(REPO, "configs", yaml),
                          result_dir=os.path.join(REPO, "build", "serve"),
                          resolution=resolution, device=dev.type)
    torch.cuda.synchronize()
    print(f"Image2Video {yaml} {resolution[0]}x{resolution[1]}: built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)
    rng = np.random.default_rng(SEED)
    img_a, img_b = (rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                    for _ in range(2))
    interp = dict(steps=ddim_steps, eta=1.0, image_b=img_b)
    plan = (("interp", "", interp),
            ("interp", ", the cached pipeline", interp),
            ("repeat", "", dict(steps=SERVE_REPEAT_STEPS, eta=0.0)))
    t, (h, w) = backend.cfg.video_length, resolution
    total = dict.fromkeys(kc.launch_counts(), 0)
    clips, allocated = [], []
    for r, (mode, note, kw) in enumerate(plan):
        torch.cuda.reset_peak_memory_stats(dev)
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        path = backend.get_image(img_a, "", fs=backend.cfg.default_fs,
                                 seed=SEED, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kc.launch_counts()
        for k, v in counts.items():
            total[k] += v
        clip = backend.last_clip
        allocated.append(torch.cuda.memory_allocated(dev))
        written = (os.path.getsize(path) > 0 if os.path.isfile(path)
                   else os.path.isdir(path) and len(os.listdir(path)) == t)
        missed = [k for k in kernels if not counts[k]]
        pipe = backend._pipelines[(kw["steps"], 7.5, kw["eta"], mode)]
        print(f"3e request {r} ({mode}{note}, DDIM-{kw['steps']}, eta "
              f"{kw['eta']}): {dt:.2f} s (phase seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in pipe.timings.items())
              + f"); peak memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, "
              f"{allocated[-1] / 2 ** 30:.4f} GiB after; clip range "
              f"[{clip.min():.3f}, {clip.max():.3f}] written to "
              f"{os.path.relpath(path, REPO)}; launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
              flush=True)
        if (missed or not written or clip.shape != (t, h, w, 3)
                or not np.isfinite(clip).all()
                or np.abs(clip).max() > OUTPUT_MAX_ABS):
            raise SystemExit(f"3e request {r}: kernels {missed} not "
                             f"launched, clip not written ({path}), or a "
                             f"clip of shape {clip.shape} not finite or "
                             f"outside +-{OUTPUT_MAX_ABS}")
        clips.append(clip)
    same = bool(np.array_equal(clips[0], clips[1]))
    drift = (allocated[2] - allocated[0]) / 2 ** 20
    print(f"3e request 1 against request 0: bit for bit {same} (max abs "
          f"diff {np.abs(clips[1] - clips[0]).max():.3e}); allocated after "
          f"request 2 minus after request 0: {drift:+.3f} MiB (bound "
          f"+-{SERVE_MEMORY_SLACK_MIB}); pipelines cached "
          f"{sorted(backend._pipelines)}", flush=True)
    if not same or abs(drift) > SERVE_MEMORY_SLACK_MIB:
        raise SystemExit("3e: the cached pipeline's clip differs from the "
                         "first, or the allocated memory moved")
    return total


def decoder_inputs(cfg, gen, device, dtype=torch.float32):
    """Raw latents (1, T, h, w, z) and the five reference taps
    (1, 2, H_l, W_l, C_l) of the configuration, standard normal."""
    h, w = cfg.latent_h * 8, cfg.latent_w * 8
    shapes = []
    for i, mult in enumerate(cfg.vae_ch_mult):
        shapes.append((h, w, cfg.vae_ch * mult))
        if i != len(cfg.vae_ch_mult) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
    shapes.append((cfg.latent_h * 8, cfg.latent_w * 8, cfg.vae_ch))
    rnd = lambda *s: torch.randn(*s, generator=gen, device=gen.device).to(
        device, dtype)
    z = rnd(1, cfg.video_length, cfg.latent_h, cfg.latent_w, cfg.z_channels)
    return z, [rnd(1, 2, *sh) for sh in shapes]


@contextlib.contextmanager
def record_flash_shapes():
    """(BH, Sq, Sk, D) of every flash forward launch."""
    from tooncrafter_tpu_torch.ops import flash_attention as fa

    seen, launch = [], fa._launch

    def rec(q4, k4, *args, **kw):
        b, sq, h, d = q4.shape
        seen.append((b * h, sq, k4.shape[1], d))
        return launch(q4, k4, *args, **kw)
    fa._launch = rec
    try:
        yield seen
    finally:
        fa._launch = launch


def check_time_modes(dev) -> dict:
    """3f: each of the 'attn-only' and 'all' decoders, reduced, bf16 on the
    card against fp32 on the CPU (same weights and inputs), then at full
    width (320x512x16) twice on the card: seconds, peak, flash launches,
    each launch at a shape phase 2 checks. Returns the full-width decodes'
    launch counts."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import (ModelConfig,
                                              model_config_from_yaml)
    from tooncrafter_tpu_torch.models.vae_dualref import DualRefVideoDecoder
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.weights import (init_random_,
                                                     to_compute_dtype)

    cast_bf16 = lambda mod: to_compute_dtype(mod, torch.bfloat16).eval()

    full = model_config_from_yaml(os.path.join(REPO, "configs",
                                               "inference_512_v1.0.yaml"))
    total = dict.fromkeys(kc.launch_counts(), 0)
    failed = []
    for mode in ("attn-only", "all"):
        cfg = dataclasses.replace(reduced_config(ModelConfig()),
                                  latent_h=SMALL_LATENT[0],
                                  latent_w=SMALL_LATENT[1],
                                  dualref_time_mode=mode)
        cpu_dec = DualRefVideoDecoder.from_config(cfg).eval()
        init_random_(cpu_dec, torch.Generator().manual_seed(1))
        gpu_dec = cast_bf16(copy.deepcopy(cpu_dec).to(dev))
        z, refs = decoder_inputs(cfg, torch.Generator().manual_seed(2), "cpu")
        kc.reset_launch_counts()
        with torch.no_grad():
            ref = cpu_dec(z, refs)
            got = gpu_dec(z.to(dev, torch.bfloat16),
                          [r.to(dev, torch.bfloat16) for r in refs])
        got = got.float().cpu()
        db = psnr(got, ref)
        print(f"3f {mode} reduced decoder {cfg.latent_h * 8}x"
              f"{cfg.latent_w * 8}x{cfg.video_length}: card bf16 vs CPU fp32"
              f" min PSNR {db:.2f} dB, max_abs_err "
              f"{(got - ref).abs().max().item():.4e}, output range "
              f"[{ref.min().item():.3f}, {ref.max().item():.3f}], launches "
              f"{ {k: v for k, v in kc.launch_counts().items() if v} }",
              flush=True)
        if not db >= REDUCED_MIN_PSNR:
            failed.append(f"{mode} reduced")
        del cpu_dec, gpu_dec
        cfg = dataclasses.replace(full, dualref_time_mode=mode)
        gc.collect()
        torch.cuda.empty_cache()
        with torch.device(dev):
            dec = DualRefVideoDecoder.from_config(cfg)
        init_random_(dec, torch.Generator(dev).manual_seed(SEED))
        dec = cast_bf16(dec)
        z, refs = decoder_inputs(cfg, torch.Generator(dev).manual_seed(3),
                                 dev, torch.bfloat16)
        torch.cuda.reset_peak_memory_stats(dev)
        seconds = []
        for _ in range(2):
            kc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad(), record_flash_shapes() as shapes:
                out = dec(z, refs)
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        counts = kc.launch_counts()
        for k, v in counts.items():
            total[k] += v
        unchecked = sorted(set(shapes) - FLASH_CHECKED)
        ok = (tuple(out.shape) == (1, cfg.video_length, cfg.latent_h * 8,
                                   cfg.latent_w * 8, 3)
              and torch.isfinite(out).all().item() and not unchecked)
        print(f"3f {mode} full-width decode {cfg.latent_h * 8}x"
              f"{cfg.latent_w * 8}x{cfg.video_length}: "
              f"{', '.join(f'{t:.3f}' for t in seconds)} s; peak memory "
              f"allocated {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f}"
              f" GiB; launches a decode "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
              + f"; flash (BH, Sq, Sk, D) {sorted(set(shapes))}, not checked"
              f" in phase 2: {unchecked}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            failed.append(f"{mode} full width")
        del dec, out, z, refs
    if failed:
        raise SystemExit(f"3f: {failed}")
    return total


class _HostNoise:
    """Stands in for a sampler module's ``utils.rngs``: every draw comes
    from one CPU generator and moves to the draw's device, so a card run
    and a CPU run share their noise."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def normal(self, gen, shape, device=None, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=self.gen).to(device, dtype)


def check_ddpm_decode_plain(dev) -> None:
    """3g: a reduced model with the plain decoder, the same weights on the
    card (bf16) and the CPU (fp32): encode, the conditioning, a
    ``DDPM_STEPS``-step ``ddpm_sample`` with noise from one CPU generator
    on both (the sampler's ``R`` swapped for ``_HostNoise``, as the CPU
    tests swap it), ``decode_plain``; the clips held to the 3a bar."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.ops import schedule as S
    from tooncrafter_tpu_torch.sampling import ddpm
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(reduced_config(ModelConfig()),
                              latent_h=SMALL_LATENT[0],
                              latent_w=SMALL_LATENT[1])
    cpu_model = ToonCrafter(cfg, dualref=False)
    init_random_(cpu_model, torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gpu_model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    gpu_model.to_compute_dtype()
    sched = S.build_schedule(
        timesteps=DDPM_STEPS, beta_schedule=cfg.beta_schedule,
        linear_start=cfg.linear_start, linear_end=cfg.linear_end,
        rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        parameterization=cfg.parameterization)
    outs = {}
    for name, model, device in (("cpu", cpu_model.eval(), "cpu"),
                                ("gpu", gpu_model.eval(), dev)):
        video, tokens, null, fs, x_T = small_inputs(cfg, 4, device)
        kc.reset_launch_counts()
        with torch.no_grad():
            z, _ = model.encode_first_stage(video, sample_posterior=False)
            ctx = Pipeline(model, guidance=GuidanceConfig(
                cfg_scale=1.0)).conditioning(tokens, null, video[:, 0])
            rngs, ddpm.R = ddpm.R, _HostNoise(SEED)
            try:
                lat = ddpm.ddpm_sample(model.unet, sched, x_T, ctx,
                                       model.build_concat_cond(z), fs)
            finally:
                ddpm.R = rngs
            outs[name] = (lat.float().cpu(),
                          model.decode_plain(lat).float().cpu())
        if name == "gpu":
            torch.cuda.synchronize()
            hit = kc.launch_counts()
    (lc, vc), (lg, vg) = outs["cpu"], outs["gpu"]
    rel = ((lg - lc).norm() / lc.norm()).item()
    db = psnr(vg, vc)
    print(f"3g reduced plain-decoder model, DDPM-{DDPM_STEPS} + "
          f"decode_plain: card bf16 vs CPU fp32 latents relative L2 error "
          f"{rel:.4e}, clip min PSNR {db:.2f} dB, output range "
          f"[{vc.min().item():.3f}, {vc.max().item():.3f}]; launches "
          f"{ {k: v for k, v in hit.items() if v} }", flush=True)
    if not (db >= REDUCED_MIN_PSNR and torch.isfinite(vg).all()):
        raise SystemExit("3g: ddpm_sample / decode_plain on the card "
                         "disagree with the CPU")


def table_config(base):
    """The reduced training model at the 512 model's ds2 and ds4 shapes
    (over two frames): 20x32 latents at 640 channels and 10x16 at 1280,
    where the JAX
    package's F(2x2) table takes the ResBlock convs (#13) but for the 640
    -> 1280 in_conv."""
    return base.tiny(
        latent_h=20, latent_w=32, model_channels=640, num_res_blocks=1,
        channel_mult=(1, 2), attention_resolutions=(1, 2),
        num_head_channels=64, vae_ch=32, vae_ch_mult=(1, 2, 4, 16),
        video_length=2)  # two frames: cut in depth for the time limit


def check_reduced_training(dev, kernels=REDUCED_TRAIN_KERNELS,
                           config=reduced_config) -> None:
    """The reduced model's trainable gradients: card (bf16 autocast over
    fp32 weights, the kernels and #6) against CPU (fp32, plain versions),
    on the same weights, batch and draws. The UNet trains on its unfused
    branch (dropout 0.1, the training convs through their kernels'
    Functions) with the dropout modules passing their input through on
    both sides, so the two see the same (no) masks."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.models.unet import ResBlock
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = dataclasses.replace(config(ModelConfig()),
                              use_checkpoint=True, remat_policy="dots")
    cpu_model = ToonCrafter(cfg)
    init_random_(cpu_model, torch.Generator().manual_seed(1))
    rank_runs.pass_dropout_(cpu_model)
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
        unfused = all(m.unfused for m in model.unet.modules()
                      if isinstance(m, ResBlock))
        loss.backward()
        if name == "gpu":
            torch.cuda.synchronize()
            hit = kc.launch_counts()
        grads[name] = {k: p.grad.float().cpu() for k, p in train.items()}
        print(f"reduced training model on the {name}: loss "
              f"{loss.item():.6f}, ResBlocks on the unfused branch "
              f"{unfused}", flush=True)
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
          f"{cfg.video_length}, C={cfg.model_channels}, B=2: {len(names)} "
          f"trainable tensors, "
          f"gradient cosine {cos:.6f} (bound >= {GRAD_MIN_COSINE}), "
          f"largest per-tensor relative L2 error {worst[0][1]:.4f} (bound "
          f"{GRAD_MAX_REL_L2}); worst {worst}; kernel launches "
          f"{ {k: v for k, v in hit.items() if v} }", flush=True)
    missed = [k for k in kernels if not hit[k]]
    if (cos < GRAD_MIN_COSINE or worst[0][1] > GRAD_MAX_REL_L2 or missed
            or not unfused):
        raise SystemExit(f"reduced training model: card gradients disagree "
                         f"with the CPU's, kernels {missed} not reached, or "
                         f"a ResBlock off its training branch")


def train_full_width(dev, steps: int = TRAIN_STEPS, kernels=TRAIN_KERNELS,
                     yaml: str = "training_512_v1.0.yaml", profiles=(),
                     keep: bool = False):
    """``steps`` AdamW steps with EMA of the training model in ``yaml``
    (its batch of clips, its checkpointing) at full width, every step
    launching every kernel of ``kernels``; then ``PROFILE_STEPS`` steps
    with each optimizer profile in ``profiles`` on the same model (the
    AdamW moments freed first), with its state bytes and peak. Returns the
    launch counts over the AdamW steps, each step's seconds and the peak
    memory (GiB), and with ``keep`` the model, the state, its TrainConfig
    and the batch. With #16 among ``kernels``, then counts its launches in
    one forward of the loss (a step also recomputes the checkpointed
    blocks' forward in its backward)."""
    import dataclasses

    from tooncrafter_tpu_torch.config import load_yaml, model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    path = os.path.join(REPO, "configs", yaml)
    cfg = dataclasses.replace(model_config_from_yaml(path),
                              compute_dtype=torch.bfloat16)
    bsz = load_yaml(path)["data"]["params"]["batch_size"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.manual_seed(SEED)  # dropout's stream
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    tcfg = T.TrainConfig(learning_rate=1e-5 * bsz)
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    del opt  # the state holds it
    n_train = sum(p.numel() for p in state.train_params.values())
    torch.cuda.synchronize()
    print(f"training model {yaml} (use_checkpoint={cfg.use_checkpoint}, "
          f"remat_policy={cfg.remat_policy}, {bsz} clips of "
          f"{cfg.latent_h * 8}x{cfg.latent_w * 8}x{cfg.video_length}): "
          f"{n_train / 1e9:.3f} B "
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
    batch = random_batch(cfg, bsz, SEED, dev)
    gen = torch.Generator(dev).manual_seed(SEED)

    def run(step_fn, n, label):
        total = dict.fromkeys(kc.launch_counts(), 0)
        seconds = []
        for i in range(n):
            kc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            seconds.append(dt)
            counts = kc.launch_counts()
            for k, v in counts.items():
                total[k] += v
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            print(f"{label} step {i}: {dt:.2f} s, loss {loss:.6f}, grad_norm "
                  f"{gnorm:.6f}, t {float(metrics['t_mean']):.0f}; launches "
                  + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
                  flush=True)
            missed = [k for k in kernels if not counts[k]]
            if missed or not torch.isfinite(
                    torch.tensor([loss, gnorm])).all():
                raise SystemExit(f"{label} step {i}: kernels {missed} not "
                                 f"launched, or a non-finite loss or "
                                 f"grad_norm")
        return total, seconds

    total, seconds = run(T.make_train_step(model, state.optimizer, tcfg), steps,
                         "train")
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
          f"{len(ema0)}; optimizer state {state_gib(state.optimizer):.2f} "
          f"GiB", flush=True)
    if zero or still:
        raise SystemExit(f"training: zero gradients {zero[:5]} or an EMA "
                         f"that did not move {still[:5]}")
    for name in profiles:
        pcfg = dataclasses.replace(tcfg, optimizer=name)
        state.optimizer.state.clear()
        state.optimizer = state.scheduler = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state.optimizer, state.scheduler = T.make_optimizer(
            pcfg, list(state.train_params.values()))
        _, secs = run(T.make_train_step(model, state.optimizer, pcfg),
                      PROFILE_STEPS, name)
        print(f"{name}: step seconds {', '.join(f'{t:.2f}' for t in secs)};"
              f" optimizer state {state_gib(state.optimizer):.2f} GiB; peak "
              f"memory allocated {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f}"
              f" GiB (AdamW above: {peak:.2f})", flush=True)
    if "_pallas_gn" in kernels:
        kc.reset_launch_counts()
        with T.autocast(model, dev):
            loss, _ = T.diffusion_loss(model, batch, gen, train=True)
        torch.cuda.synchronize()
        print(f"training: _pallas_gn launches in one forward of the loss "
              f"{kc.launch_counts()['_pallas_gn']}", flush=True)
        del loss
    if keep:
        return total, seconds, peak, (model, state, tcfg, batch)
    return total, seconds, peak


def state_gib(opt) -> float:
    """The bytes of an optimizer's state tensors, GiB."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t)) / 2 ** 30


def check_validation(dev, model, state, tcfg, batch) -> None:
    """4d: ``make_val_step`` on the training batch (the loss with the raw
    weights and with the EMA shadow, on the same draws) and one
    ``VideoSampleLogger`` call (the Pipeline at DDIM-SAMPLE_DDIM_STEPS on
    the batch's first clip with the EMA weights), each finite, the clip
    written."""
    from tooncrafter_tpu_torch.training import callbacks as CB
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import video_io

    t0 = time.perf_counter()
    metrics = T.make_val_step(model, tcfg)(
        state, batch, torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    vals = {k: float(v) for k, v in metrics.items()}
    print(f"4d make_val_step: {vals} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    clips = []
    write = video_io.write_video

    def recorded(path, video, *a, **k):
        clips.append((video.shape, bool(np.isfinite(video).all())))
        return write(path, video, *a, **k)
    logger = CB.VideoSampleLogger(
        model, os.path.join(REPO, "build", "train_samples"), every_steps=1,
        ddim_steps=SAMPLE_DDIM_STEPS)
    video_io.write_video = recorded
    t0 = time.perf_counter()
    try:
        out = logger.maybe_log(state.step, state, batch,
                               torch.Generator(dev).manual_seed(SEED))
    finally:
        video_io.write_video = write
    torch.cuda.synchronize()
    written = (sorted(os.listdir(out)) if os.path.isdir(out)
               else [os.path.basename(out)] if os.path.getsize(out) else [])
    print(f"4d VideoSampleLogger (DDIM-{SAMPLE_DDIM_STEPS}, EMA weights): "
          f"{time.perf_counter() - t0:.2f} s, clip {clips}, written {out} "
          f"({len(written)} files)", flush=True)
    if not (set(vals) == {"val/loss", "val/loss_ema"}
            and all(np.isfinite(v) for v in vals.values())
            and clips and all(ok for _, ok in clips) and written):
        raise SystemExit("4d: a validation loss or the sampled clip is not "
                         "finite, or no clip was written")


# ---------------------------------------------------------------------------
# phase 5: multi-device (parallel/, the trainer and BatchedPipeline over
# torch.distributed)
# ---------------------------------------------------------------------------

def _grad_agreement(a, b):
    """(cosine of the concatenated gradients, [(name, relative L2 error)]
    worst first) of two name -> tensor maps, summed in float64."""
    dot = na = nb = 0.0
    rel = {}
    for n in b:
        x, y = a[n].double(), b[n].double()
        dot += float((x * y).sum())
        na += float(x.square().sum())
        nb += float(y.square().sum())
        rel[n] = float((x - y).norm() / y.norm().clamp_min(1e-30))
    return dot / (na * nb) ** 0.5, sorted(rel.items(), key=lambda kv: -kv[1])


def check_world1_training(dev, train_s, train_peak) -> dict:
    """5a: a process group of one over NCCL on the card; the 512 training
    model (4b's YAML, seed and batch of two). One non-distributed step's
    gradients against the distributed step's all-reduced ones, from the
    same weights (drawn again from the seed), the same draws and the
    dropout modules passing their input through; then WORLD1_STEPS AdamW
    steps of the distributed state, each launching TRAIN_KERNELS. Returns
    the launch counts over those steps."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from tooncrafter_tpu_torch.config import load_yaml, model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.parallel import mesh as M
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    path = os.path.join(REPO, "configs", "training_512_v1.0.yaml")
    cfg = dataclasses.replace(model_config_from_yaml(path),
                              compute_dtype=torch.bfloat16)
    bsz = load_yaml(path)["data"]["params"]["batch_size"]
    store = tempfile.mkdtemp(prefix="chip_smoke_5a_")
    d = M.init_distributed(dev, backend="nccl",
                           init_method=f"file://{store}/store", rank=0,
                           world_size=1)
    try:
        mesh = M.make_mesh(device_type="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.manual_seed(SEED)
        with torch.device(dev):
            model = ToonCrafter(cfg)
        rank_runs.pass_dropout_(model)
        tcfg = T.TrainConfig(learning_rate=1e-5 * bsz)
        batch = random_batch(cfg, bsz, SEED, dev)
        draws = T.sample_draws(model, batch["video"],
                               torch.Generator(dev).manual_seed(SEED))
        grads = {}
        for name, group in (("one process", None), ("world 1", mesh)):
            init_random_(model, torch.Generator(dev).manual_seed(SEED))
            state, _ = T.make_train_state(model, tcfg, use_ema=True,
                                          group=group)
            _, g = T.loss_and_grads(model, tcfg, state, batch, draws=draws)
            if group is not None:
                M.all_reduce_mean_(g, state.group)
            grads[name] = dict(zip(state.train_params, g))
            del g
        cos, worst = _grad_agreement(grads["world 1"], grads["one process"])
        print(f"5a world 1 over {dist.get_backend()} on {d.device}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: gradient "
              f"cosine {cos:.7f} against one process (bound >= "
              f"{WORLD1_MIN_COSINE}); worst relative L2 {worst[:3]}",
              flush=True)
        del grads
        if cos < WORLD1_MIN_COSINE:
            raise SystemExit("5a: the world-1 reduced gradients disagree "
                             "with one process's")
        step_fn = T.make_train_step(model, state.optimizer, tcfg)
        gen = torch.Generator(dev).manual_seed(SEED)
        total = dict.fromkeys(kc.launch_counts(), 0)
        seconds = []
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(WORLD1_STEPS):
            kc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts = kc.launch_counts()
            for k, v in counts.items():
                total[k] += v
            missed = [k for k in TRAIN_KERNELS if not counts[k]]
            loss = float(metrics["loss"])
            print(f"5a step {i}: {seconds[-1]:.2f} s, loss {loss:.6f}, "
                  f"grad_norm {float(metrics['grad_norm']):.6f}", flush=True)
            if missed or not np.isfinite(loss):
                raise SystemExit(f"5a step {i}: kernels {missed} not "
                                 f"launched or a non-finite loss")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"5a: step seconds {', '.join(f'{t:.2f}' for t in seconds)} "
              f"against 4b's {', '.join(f'{t:.2f}' for t in train_s)}; peak "
              f"{peak:.2f} GiB against 4b's {train_peak:.2f}; launches per "
              f"step " + ", ".join(f"{k} {v / WORLD1_STEPS:.0f}"
                                  for k, v in total.items() if v), flush=True)
        del model, state, step_fn, batch
        return total
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def _card_shared() -> None:
    """Two ranks share cuda:0 only in the Default compute mode."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    if mode != "Default":
        raise SystemExit(f"phase 5: the card's compute mode is {mode}, not "
                         f"Default: two ranks cannot share it")


def _rank_report(label, results, kernels) -> list:
    """Print each rank's seconds and peak; exit if a rank missed a kernel
    of ``kernels``. Returns the ranks' launch counts."""
    counts = []
    for r in results:
        secs = (r["seconds"] if "seconds" in r else
                {k: [round(t, 2) for t in v["seconds"]]
                 for k, v in r["profiles"].items()})
        missed = [k for k in kernels if not r["launches"][k]]
        print(f"{label} rank {r['rank']}: seconds {secs}, peak "
              f"{r['peak_gib']:.2f} GiB; launches "
              + ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v),
              flush=True)
        if missed:
            raise SystemExit(f"{label} rank {r['rank']}: kernels {missed} "
                             f"not launched")
        counts.append(r["launches"])
    return counts


def check_two_rank_training(dev) -> list:
    """5b: two spawned ranks share cuda:0 over gloo, the reduced training
    model (weights drawn on the card from a seed; 4a's batch and draws),
    one clip a rank, the dropout modules passing their input through. The
    reduced gradients against one process with the batch of two on the
    card (4a's bounds); then two AdamW steps and one adafactor step, each
    from those weights, the ranks' trainables equal bit for bit after
    every step. Returns each rank's launch counts."""
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    _card_shared()
    cfg = dataclasses.replace(shallow_config(ModelConfig()),
                              use_checkpoint=True, remat_policy="dots")
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(1))
    rank_runs.pass_dropout_(model)
    model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    batch = random_batch(cfg, 2, 4, "cpu")
    draws = T.sample_draws(model, batch["video"],
                           torch.Generator().manual_seed(5))
    draws["rand"] = torch.tensor([0.5, 0.07])  # one clip keeps its text
    train, _ = T.split_trainable(model)
    t0 = time.perf_counter()
    with T.autocast(model, dev):
        loss, _ = T.diffusion_loss(model, {k: v.to(dev) for k, v in
                                           batch.items()}, draws=draws,
                                   train=True)
    loss.backward()
    one = {k: p.grad.float().cpu() for k, p in train.items()}
    print(f"5b one process, batch of two on the card: loss "
          f"{loss.item():.6f} in {time.perf_counter() - t0:.2f} s", flush=True)
    del model, train, loss
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"config": cfg, "init_device_seed": 1, "batch": batch,
            "first_draws": draws, "pass_dropout": True,
            "train_config": {"learning_rate": 2e-5},
            "profiles": RANK_PROFILES, "gen_seed": SEED}
    t0 = time.perf_counter()
    res = run_ranks(rank_runs.train, 2, "cuda", args=(spec,),
                    timeout=RANK_TIMEOUT_S)
    print(f"5b two ranks over gloo on {dev} (mesh {res[0]['mesh']}): "
          f"{time.perf_counter() - t0:.1f} s, spawn and build included; "
          f"rank 0's seconds by part "
          f"{ {k: round(v, 2) for k, v in res[0]['clock'].items()} }",
          flush=True)
    cos, worst = _grad_agreement(res[0]["grads"], one)
    same_grads = res[0]["grads_digest"] == res[1]["grads_digest"]
    print(f"5b reduced gradients against one process: cosine {cos:.6f} "
          f"(bound >= {GRAD_MIN_COSINE}), largest per-tensor relative L2 "
          f"{worst[0][1]:.4f} (bound {GRAD_MAX_REL_L2}); the ranks' reduced "
          f"gradients equal {same_grads}; worst {worst[:3]}", flush=True)
    if cos < GRAD_MIN_COSINE or worst[0][1] > GRAD_MAX_REL_L2 \
            or not same_grads:
        raise SystemExit("5b: the ranks' reduced gradients disagree with "
                         "one process's or with each other")
    for name, steps in RANK_PROFILES:
        a, b = (r["profiles"][name] for r in res)
        same = [x == y for x, y in zip(a["digests"], b["digests"])]
        print(f"5b {name}: losses {a['losses']}; trainables equal across "
              f"the ranks after each step {same}", flush=True)
        if len(same) != steps or not all(same) \
                or not np.isfinite(a["losses"]).all():
            raise SystemExit(f"5b {name}: the ranks' trainables differ or a "
                             f"loss is not finite")
    return _rank_report("5b", res, REDUCED_TRAIN_KERNELS)


def check_two_rank_serving(dev, seconds_3b) -> list:
    """5c: two spawned ranks share cuda:0 over gloo and serve three clips
    of the 512 inference model (3b's YAML and seed, random weights) through
    ``BatchedPipeline``: ragged, rank 0 clips 0-1 and rank 1 clip 2, DDIM-
    SERVE_DDIM_STEPS, CFG 7.5 with rescale 0.7, the splice, per-item
    generators. Held against one process running the same micro-batches
    (first, then freed): bit for bit, else each clip's PSNR >=
    SERVE_MIN_PSNR. Returns each rank's launch counts."""
    import dataclasses

    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import rngs as R
    from tooncrafter_tpu_torch.utils.weights import init_random_

    _card_shared()
    cfg = dataclasses.replace(
        model_config_from_yaml(os.path.join(REPO, "configs",
                                            "inference_512_v1.0.yaml")),
        compute_dtype=torch.bfloat16)
    parts = [small_inputs(cfg, 10 + r, "cpu")[:4] for r in range(3)]
    inputs = [torch.cat(p) for p in zip(*parts)]
    pipe_kw = dict(ddim_steps=SERVE_DDIM_STEPS, eta=1.0,
                   spacing="uniform_trailing",
                   guidance=dict(cfg_scale=7.5, guidance_rescale=0.7),
                   perframe_ae=cfg.perframe_ae)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    model.to_compute_dtype().eval()
    kw = dict(pipe_kw, guidance=GuidanceConfig(**pipe_kw["guidance"]))
    pipe = Pipeline(model, **kw)
    ref, ref_s = [], []
    for rows in (slice(0, 2), slice(2, 3)):
        gens = R.per_item_generators(SEED, range(3)[rows], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.append(pipe(*(x[rows].to(dev) for x in inputs),
                        generator=gens).float().cpu())
        torch.cuda.synchronize()
        ref_s.append(time.perf_counter() - t0)
    ref = torch.cat(ref).numpy()
    print(f"5c one process, the same micro-batches (clips 0-1, clip 2): "
          f"{', '.join(f'{t:.2f}' for t in ref_s)} s", flush=True)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"config": cfg, "init_device_seed": SEED, "inputs": inputs,
            "seed": SEED, "pipeline": pipe_kw}
    t0 = time.perf_counter()
    res = run_ranks(rank_runs.serve, 2, "cuda", args=(spec,),
                    timeout=RANK_TIMEOUT_S)
    out = res[0]["clips"]
    equal = bool(np.array_equal(out, ref))
    db = [psnr(torch.from_numpy(out[i:i + 1]), torch.from_numpy(ref[i:i + 1]))
          for i in range(len(ref))]
    print(f"5c two ranks over gloo on {dev} (mesh {res[0]['mesh']}): "
          f"{time.perf_counter() - t0:.1f} s, spawn and build included; "
          f"clips a rank {[r['clips_here'] for r in res]}; gathered "
          f"{tuple(out.shape)} against one process: bit for bit {equal}, "
          f"per-clip min PSNR {[round(x, 2) for x in db]} dB; the ranks' "
          f"gathered clips equal {res[0]['digest'] == res[1]['digest']}; "
          f"3b's request {seconds_3b:.2f} s at DDIM-50", flush=True)
    if not equal:
        print("5c: not bit for bit: a second process may pick other cuBLAS "
              "and cuDNN algorithms than the first; each clip held to "
              f"{SERVE_MIN_PSNR} dB", flush=True)
    if (out.shape != ref.shape or not np.isfinite(out).all()
            or res[0]["digest"] != res[1]["digest"]
            or [r["clips_here"] for r in res] != [2, 1]
            or not (equal or min(db) >= SERVE_MIN_PSNR)):
        raise SystemExit("5c: the gathered clips disagree with one process "
                         "or between the ranks")
    return _rank_report("5c", res, KERNELS_512)


def check_graft_entry(dev) -> None:
    """5d: the graft entry's UNet forward on the card, then its dry run on
    two ranks sharing the card."""
    from tooncrafter_tpu_torch import graft_entry

    t0 = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    out = fn(*args)
    torch.cuda.synchronize()
    ok = (tuple(out.shape) == (2, 16, 40, 64, 4)
          and bool(torch.isfinite(out).all()))
    print(f"5d graft_entry.entry('cuda'): output {tuple(out.shape)} "
          f"{out.dtype}, finite {bool(torch.isfinite(out).all())}, range "
          f"[{out.min().item():.4f}, {out.max().item():.4f}], "
          f"{time.perf_counter() - t0:.2f} s with the build", flush=True)
    if not ok:
        raise SystemExit("5d: the graft entry's output is not the finite "
                         "latent")
    del fn, args, out
    gc.collect()
    torch.cuda.empty_cache()
    _card_shared()
    t0 = time.perf_counter()
    graft_entry.dryrun_multidevice(2, "cuda", timeout=RANK_TIMEOUT_S)
    print(f"5d dryrun_multidevice(2, 'cuda'): "
          f"{time.perf_counter() - t0:.1f} s, spawn included", flush=True)


def latent_psnr(a, b) -> float:
    """PSNR (dB) of ``a`` against ``b`` at b's peak |value|."""
    mse = (a.float() - b.float()).square().mean()
    return (10 * torch.log10(b.float().abs().max() ** 2
                             / mse.clamp_min(1e-30))).item()


def check_tp_denoise(dev) -> list:
    """5e: one CFG-batched UNet call (two branches of one 16-frame 320x512
    clip, ``cfg_groups`` 2 as the DDIM sampler calls it) of the full-width
    512 inference model (random weights from SEED, bf16) at world one on
    the card, then on two ranks sharing the card at (1 data, 2 model), the
    transformer blocks sharded. Each rank's output equals the other's bit
    for bit and is held to TP_MIN_PSNR against world one; each rank
    launches what world one launches with every pair launch replaced by
    two single stages (the layout's prediction). Returns each rank's
    launch counts."""
    import dataclasses

    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks
    from tooncrafter_tpu_torch.utils import kernel_check as kc
    from tooncrafter_tpu_torch.utils.weights import init_random_

    _card_shared()
    cfg = dataclasses.replace(
        model_config_from_yaml(os.path.join(REPO, "configs",
                                            "inference_512_v1.0.yaml")),
        compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(SEED)
    t = cfg.video_length
    x = torch.randn(1, t, cfg.latent_h, cfg.latent_w, cfg.unet_in_channels,
                    generator=g).repeat(2, 1, 1, 1, 1)
    ctx = torch.randn(2, 77 + t * cfg.resampler_queries, cfg.context_dim,
                      generator=g)
    ts, fs = torch.full((2,), 501.0), torch.full((2,), 24.0)
    inputs = (x.bfloat16(), ts, ctx.bfloat16(), fs)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    model.to_compute_dtype().eval()
    torch.cuda.synchronize()
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = model.unet(*(a.to(dev) for a in inputs), cfg_groups=2)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one = kc.launch_counts()
    ref = ref.float().cpu()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(one, _fused_tpair_call=0,
                _fused_tattn_call=one["_fused_tattn_call"]
                + 2 * one["_fused_tpair_call"])
    spec = {"config": cfg, "init_device_seed": SEED, "n_model": 2,
            "inputs": inputs, "cfg_groups": 2}
    t0 = time.perf_counter()
    res = run_ranks(rank_runs.unet_forward, 2, "cuda", args=(spec,),
                    timeout=RANK_TIMEOUT_S)
    db = latent_psnr(res[0]["out"], ref)
    same = res[0]["digest"] == res[1]["digest"]
    secs = ", ".join(f"{r['seconds']:.3f}" for r in res)
    print(f"5e (1, 2) on {dev} over gloo (mesh {res[0]['mesh']}): "
          f"{time.perf_counter() - t0:.1f} s with the spawn; the UNet call "
          f"{secs} s a rank against {one_s:.3f} s at world one (gloo "
          f"reductions through the host); PSNR against world one "
          f"{db:.2f} dB (bound >= {TP_MIN_PSNR}); the ranks' outputs equal "
          f"{same}; gathered state dicts whole "
          f"{[r['gather_equal'] for r in res]}", flush=True)
    bad = [(r["rank"], {k: (v, want[k]) for k, v in r["launches"].items()
                        if v != want[k]}) for r in res]
    nz = {k: v for k, v in res[0]["launches"].items() if v}
    print(f"5e launches a rank {nz} (world one "
          f"{ {k: v for k, v in one.items() if v} }); differences from the "
          f"layout's prediction {bad}", flush=True)
    if (db < TP_MIN_PSNR or not same or any(b for _, b in bad)
            or not all(r["gather_equal"] for r in res)
            or not all(res[0]["launches"][k] for k in (
                "_flash_mh_packed", "_flash_mh", "_pallas_ff",
                "_pallas_ff_streamed", "_fused_tattn_call"))):
        raise SystemExit("5e: the (1, 2) UNet call disagrees with world one "
                         "or launches other than the layout predicts")
    return [r["launches"] for r in res]


def check_tp_training(dev) -> list:
    """5f: the reduced training model (5b's configuration, weights and
    batch, pass-through dropout) at (1 data, 2 model) on two ranks sharing
    the card: the first reduced gradients and two AdamW steps (each on the
    same draws) against world one in this process, gathered whole; the
    checkpoint the ranks write restores at (1, 1) to their trainables bit
    for bit. Returns each rank's launch counts."""
    import dataclasses
    import tempfile

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks
    from tooncrafter_tpu_torch.training import checkpoints as CKPT
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    _card_shared()
    cfg = dataclasses.replace(shallow_config(ModelConfig()),
                              use_checkpoint=True, remat_policy="dots")
    tc = {"learning_rate": 2e-5}

    def build():
        with torch.device(dev):
            model = ToonCrafter(cfg)
        init_random_(model, torch.Generator(dev).manual_seed(1))
        rank_runs.pass_dropout_(model)
        model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        return model

    model = build()
    batch = random_batch(cfg, 2, 4, "cpu")
    draws = T.sample_draws(model, batch["video"],
                           torch.Generator().manual_seed(5))
    draws["rand"] = torch.tensor([0.5, 0.07])
    init = {k: p.detach().float().cpu().clone()
            for k, p in T.split_trainable(model)[0].items()}
    tcfg = T.TrainConfig(**tc)
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    gb = {k: v.to(dev) for k, v in batch.items()}
    gd = {k: v.to(dev) for k, v in draws.items()}
    _, grads = T.loss_and_grads(model, tcfg, state, gb, draws=gd)
    one_g = {n: g.float().cpu() for n, g in zip(state.train_params, grads)}
    del grads
    step = T.make_train_step(model, opt, tcfg)
    for _ in range(2):
        step(state, gb, None, gd)
    one_p = {k: p.detach().float().cpu() for k, p in
             state.train_params.items()}
    del model, state, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    ck = tempfile.mkdtemp(prefix="chip_smoke_5f_")
    spec = {"config": cfg, "init_device_seed": 1, "batch": batch,
            "first_draws": draws, "profile_draws": draws,
            "pass_dropout": True, "train_config": tc,
            "profiles": (("adamw", 2),), "return_params": True,
            "n_model": 2, "save_dir": ck}
    t0 = time.perf_counter()
    res = run_ranks(rank_runs.train, 2, "cuda", args=(spec,),
                    timeout=RANK_TIMEOUT_S)
    cos, worst = _grad_agreement(res[0]["grads"], one_g)
    got = {k: v.float() for k, v in res[0]["profiles"]["adamw"]["params"]
           .items()}
    upd, _ = _grad_agreement({k: got[k] - init[k] for k in init},
                             {k: one_p[k] - init[k] for k in init})
    print(f"5f (1, 2) on {dev} over gloo (mesh {res[0]['mesh']}): "
          f"{time.perf_counter() - t0:.1f} s with the spawn; rank 0's seconds "
          f"by part { {k: round(v, 2) for k, v in res[0]['clock'].items()} }; "
          f"losses "
          f"{res[0]['profiles']['adamw']['losses']}; gathered gradients' "
          f"cosine against world one {cos:.6f} (bound >= "
          f"{TP_GRAD_MIN_COSINE}), worst relative L2 {worst[:3]}; the two "
          f"AdamW updates' cosine {upd:.6f} (bound >= "
          f"{TP_UPDATE_MIN_COSINE})", flush=True)
    if cos < TP_GRAD_MIN_COSINE or upd < TP_UPDATE_MIN_COSINE:
        raise SystemExit("5f: the (1, 2) training disagrees with world one")
    model = build()
    state, _ = T.make_train_state(model, T.TrainConfig(**tc), use_ema=True)
    _, stepn = CKPT.restore_train_state(ck, state)
    same = all(torch.equal(p.detach().float().cpu(), got[k])
               for k, p in state.train_params.items())
    ema = all(torch.equal(e.float().cpu(), res[0]["saved"]["ema"][k].float())
              for k, e in state.ema_params.items())
    print(f"5f: the (1, 2) checkpoint restored at (1, 1): step {stepn}, "
          f"trainables equal {same}, EMA equal {ema}", flush=True)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    if stepn != 2 or not same or not ema:
        raise SystemExit("5f: the (1, 2) checkpoint does not restore at "
                         "(1, 1)")
    return _rank_report("5f", res, tuple(
        "_fused_tattn_call" if k == "_fused_tpair_call" else k
        for k in REDUCED_TRAIN_KERNELS))


def check_tp_four_ranks(dev) -> list:
    """5g: four ranks sharing the card at (2 data, 2 model):
    ``BatchedPipeline(shard_params=True)`` serves three clips of the
    reduced inference model (random weights from SEED on the card;
    ragged: data rank 0 clips 0-1, data rank 1 clip 2; DDIM-2, CFG 7.5
    with rescale 0.7, per-item generators), held against one process on the
    same micro-batches at TP_SERVE_MIN_PSNR; then the graft dry run on four
    ranks, (2, 2). Returns each serving rank's launch counts."""
    from tooncrafter_tpu_torch import graft_entry
    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks
    from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
    from tooncrafter_tpu_torch.utils import rngs as R
    from tooncrafter_tpu_torch.utils.weights import init_random_

    _card_shared()
    import dataclasses
    cfg = dataclasses.replace(reduced_config(ModelConfig()),
                              compute_dtype=torch.bfloat16)
    parts = [small_inputs(cfg, 20 + r, "cpu")[:4] for r in range(3)]
    inputs = [torch.cat(p) for p in zip(*parts)]
    pipe_kw = dict(ddim_steps=2, eta=1.0, spacing="uniform_trailing",
                   guidance=dict(cfg_scale=7.5, guidance_rescale=0.7),
                   perframe_ae=cfg.perframe_ae)
    with torch.device(dev):
        model = ToonCrafter(cfg)
    init_random_(model, torch.Generator(dev).manual_seed(SEED))
    model.to_compute_dtype().eval()
    pipe = Pipeline(model, **dict(pipe_kw, guidance=GuidanceConfig(
        **pipe_kw["guidance"])))
    ref = []
    for rows in (slice(0, 2), slice(2, 3)):
        gens = R.per_item_generators(SEED, range(3)[rows], dev)
        ref.append(pipe(*(x[rows].to(dev) for x in inputs),
                        generator=gens).float().cpu())
    ref = torch.cat(ref)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"config": cfg, "init_device_seed": SEED, "inputs": inputs,
            "seed": SEED, "pipeline": pipe_kw, "n_model": 2}
    t0 = time.perf_counter()
    res = run_ranks(rank_runs.serve, 4, "cuda", args=(spec,),
                    timeout=RANK_TIMEOUT_S)
    out = torch.from_numpy(res[0]["clips"])
    db = [psnr(out[i:i + 1], ref[i:i + 1]) for i in range(3)]
    digests = {r["digest"] for r in res}
    print(f"5g (2, 2) on {dev} over gloo (mesh {res[0]['mesh']}): "
          f"{time.perf_counter() - t0:.1f} s with the spawn; clips a rank "
          f"{[r['clips_here'] for r in res]}; per-clip PSNR against one "
          f"process {[round(x, 2) for x in db]} dB (bound >= "
          f"{TP_SERVE_MIN_PSNR}); the ranks' gathered clips equal "
          f"{len(digests) == 1}", flush=True)
    if (tuple(out.shape) != tuple(ref.shape) or len(digests) != 1
            or [r["clips_here"] for r in res] != [2, 2, 1, 1]
            or min(db) < TP_SERVE_MIN_PSNR):
        raise SystemExit("5g: the (2, 2) served clips disagree with one "
                         "process or between the ranks")
    counts = _rank_report("5g", res, ("_flash_mh_packed", "_flash_mh",
                                      "_pallas_ff", "_pallas_ff_streamed",
                                      "_fused_tattn_call"))
    t0 = time.perf_counter()
    vals = graft_entry.dryrun_multidevice(4, "cuda", timeout=RANK_TIMEOUT_S)
    print(f"5g dryrun_multidevice(4, 'cuda'): mesh {vals['mesh']}, "
          f"{time.perf_counter() - t0:.1f} s, spawn included", flush=True)
    if vals["mesh"] != {"data": 2, "model": 2}:
        raise SystemExit("5g: the dry run's mesh is not (2, 2)")
    return counts


# 3h: each conv switch alone, as the JAX package reads it at import
CONV_SWITCHES = (("TC_WINOGRAD=0", dict(winograd=False)),
                 ("TC_WINOGRAD24=0", dict(winograd24=False)),
                 ("TC_PROLOGUE_DTYPE=f32", dict(prologue="f32")),
                 ("TC_PROLOGUE_DTYPE=bf16", dict(prologue="bf16")),
                 ("TC_STATS_SQ_BF16=1", dict(stats_sq_bf16=True)))
CONV_NAMES = ("winograd_gn_silu_conv3x3", "winograd24_gn_silu_conv3x3",
              "_pallas_fused_conv")


def jax_conv_rule(h, w, cin, cout, winograd=True, winograd24=True,
                  prologue="ref", pallas=False, **_):
    """The kernel the JAX package's ``_impl`` takes at a conv shape under
    the switches (tooncrafter_tpu/ops/spatial_conv.py:371-389), restated
    here: the Winograd tables unless the "bf16" prologue declines them
    (F(2x4) first, both gone under TC_WINOGRAD=0), then #15's rule under
    TC_SPATIAL_CONV_PALLAS=1; None where it runs XLA."""
    from tooncrafter_tpu_torch.ops import spatial_conv as sc

    key = (h, w, cin, cout)
    if prologue != "bf16" and winograd:
        if winograd24 and h % 2 == 0 and w % 4 == 0 and key in sc._TABLE24:
            return "winograd24_gn_silu_conv3x3"
        if key in sc._TABLE:
            return "winograd_gn_silu_conv3x3"
    if pallas and sc._use_kernel(*key):
        return "_pallas_fused_conv"
    return None


@contextlib.contextmanager
def record_conv_sites():
    """(site, (H, W, Cin, Cout)) of every fused conv a model calls: the
    UNet's ``gn_silu_conv3x3`` ('unet': its kernel runs where the JAX
    package runs XLA too, under F(2x2)'s name) and the VAE's
    ``spatial_conv3x3`` ('vae': the JAX dispatch as it is)."""
    from tooncrafter_tpu_torch.models import unet as unet_mod
    from tooncrafter_tpu_torch.models import vae as vae_mod

    seen = []
    saved = (unet_mod.gn_silu_conv3x3, vae_mod.spatial_conv3x3)

    def site(name, fn_):
        def rec(x, affine, conv, *a, **k):
            seen.append((name, tuple(x.shape[1:]) + (conv.weight.shape[0],)))
            return fn_(x, affine, conv, *a, **k)
        return rec
    unet_mod.gn_silu_conv3x3 = site("unet", saved[0])
    vae_mod.spatial_conv3x3 = site("vae", saved[1])
    try:
        yield seen
    finally:
        unet_mod.gn_silu_conv3x3, vae_mod.spatial_conv3x3 = saved


def predicted_conv_launches(sites, setting) -> dict:
    """Launches by conv kernel name that the JAX rule predicts for these
    sites under ``setting``: the UNet's at its kernel (F(2x2)'s name where
    the rule names none, but no launch under the "bf16" prologue, which no
    kernel computes), the VAE's only where the rule names one."""
    out = dict.fromkeys(CONV_NAMES, 0)
    for site, key in sites:
        name = jax_conv_rule(*key, **setting)
        if (name is None and site == "unet"
                and setting.get("prologue", "ref") != "bf16"):
            name = "winograd_gn_silu_conv3x3"
        if name is not None:
            out[name] += 1
    return out


def _reduced_models(dev, cfg):
    """The same randomly initialised model on the CPU (fp32) and on the
    card (bf16), both in eval mode."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cpu_model = ToonCrafter(cfg)
    init_random_(cpu_model, torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gpu_model.config = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    gpu_model.to_compute_dtype()
    return cpu_model.eval(), gpu_model.eval()


def _reduced_clip(model, cfg, device):
    from tooncrafter_tpu_torch.models.diffusion import Pipeline

    # two DDIM steps (three before PR 19): cut in depth for the time limit
    pipe = Pipeline(model, ddim_steps=2, eta=0.0, perframe_ae=True)
    video, tokens, null, fs, x_T = small_inputs(cfg, 2, device)
    return pipe(video, tokens, null, fs, x_T=x_T).float().cpu()


def check_conv_switches(dev, reduced) -> None:
    """3h: 3a's reduced model on the card (``reduced``: what
    ``check_reduced_model`` kept) against 3a's CPU clip (no switch moves an
    fp32 result), under each conv switch alone: 3a's bound, and the conv
    launches the JAX rule predicts at the sites the run called (the reduced
    model's shapes are in no table); then every table shape at N = 2, one
    conv each: the kernel the rule names launched (held to its plain
    version at the setting's cast point, phase 2's bound) or, under the
    "bf16" prologue, none (``gn_silu_conv3x3``'s plain route)."""
    from tooncrafter_tpu_torch.ops import spatial_conv as sc
    from tooncrafter_tpu_torch.utils import kernel_check as kc

    cfg, gpu_model, ref = (reduced[k] for k in ("cfg", "gpu_model",
                                                "cpu_clip"))
    tables = sorted(set(sc._TABLE) | set(sc._TABLE24))
    failed = []
    for label, setting in CONV_SWITCHES:
        with switches(pair=True, spatial_conv_pallas=False, fused_gn=False,
                      **setting):
            kc.reset_launch_counts()
            with torch.no_grad(), record_conv_sites() as sites:
                got = _reduced_clip(gpu_model, cfg, dev)
            counts = kc.launch_counts()
            want = predicted_conv_launches(sites, setting)
            db = psnr(got, ref)
            ok = db >= REDUCED_MIN_PSNR and all(
                counts[k] == v for k, v in want.items())
            ok = ok and all(counts[k] for k in KERNELS_512
                            if k not in CONV_NAMES)
            print(f"3h {label}: reduced model card vs CPU min PSNR {db:.2f} "
                  f"dB (bound {REDUCED_MIN_PSNR}); conv launches "
                  f"{ {k: counts[k] for k in CONV_NAMES} } predicted {want}"
                  + ("" if ok else " FAIL"), flush=True)
            if not ok:
                failed.append(f"{label} reduced model")
            gen = torch.Generator(device=dev).manual_seed(5)
            for key in tables:
                name = jax_conv_rule(*key, **setting)
                if name is None and setting.get("prologue") != "bf16":
                    name = "winograd_gn_silu_conv3x3"
                routed = sc.conv_kernel_name(*key)
                if routed != name:
                    failed.append(f"{label} {key}: routed {routed}, rule "
                                  f"{name}")
                    continue
                if name is None:  # the plain route: no kernel launches
                    x = torch.randn(2, *key[:3], device=dev).bfloat16()
                    conv = torch.nn.Conv2d(key[2], key[3], 3, padding=1).to(
                        dev, torch.bfloat16)
                    aff = (torch.ones(2, key[2], device=dev),
                           torch.zeros(2, key[2], device=dev))
                    kc.reset_launch_counts()
                    with torch.no_grad():
                        y = sc.gn_silu_conv3x3(x, aff, conv)
                    moved = [k for k, v in kc.launch_counts().items() if v]
                    print(f"3h {label} {key}: the plain route, launches "
                          f"{moved}", flush=True)
                    if moved or not torch.isfinite(y).all():
                        failed.append(f"{label} {key} plain route")
                    continue
                (case, axes), = [
                    (c, (1, 2)) for c in kc.conv_cases(
                        dev, gen, ((f"3h {label}", (2,) + key),))]
                r = kc.run_case(case, axes, timed=False)
                print(kc.line(case, r), flush=True)
                if not r["ok"]:
                    failed.append(f"{label} {key}")
    if failed:
        raise SystemExit(f"3h: {failed}")


def check_relative_position(dev) -> None:
    """3i: the reduced UNet with ``use_relative_position`` (its temporal
    attention on the plain route, as the JAX package runs it; the rest on
    the kernels), card (bf16) against CPU (fp32): one denoise call as the
    sampler makes it (a CFG pair, ``cfg_groups=2``) at 3a's latent, the
    UNet's output held to 3a's bound."""
    import copy
    import dataclasses

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.utils.weights import (init_random_,
                                                     to_compute_dtype)

    cfg = dataclasses.replace(reduced_config(ModelConfig()),
                              use_relative_position=True)
    with torch.device("meta"):  # the UNet alone, off the meta model
        unet = ToonCrafter(cfg).unet
    unet = unet.to_empty(device="cpu").eval()
    init_random_(unet, torch.Generator().manual_seed(1))
    gpu_unet = to_compute_dtype(copy.deepcopy(unet).to(dev),
                                torch.bfloat16).eval()
    tables = [n for n, _ in unet.named_parameters()
              if n.endswith("relative_position_k.embeddings_table")]
    g = torch.Generator().manual_seed(2)
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    args = (torch.randn(1, t, h, w, cfg.unet_in_channels,
                        generator=g).repeat(2, 1, 1, 1, 1),
            torch.full((2,), 500.0),
            torch.randn(2, 77 + t * cfg.resampler_queries, cfg.context_dim,
                        generator=g), torch.full((2,), 24.0))
    with torch.no_grad():
        ref = unet(*args, cfg_groups=2)
        got = gpu_unet(*(a.to(dev) for a in args), cfg_groups=2).float().cpu()
    db = psnr(got, ref)
    print(f"3i relative position: {len(tables)} attention layers with tables"
          f" {tuple(unet.get_parameter(tables[0]).shape)}; reduced UNet at "
          f"{h}x{w}x{t} card vs CPU min PSNR {db:.2f} dB (bound "
          f"{REDUCED_MIN_PSNR}), output range [{ref.min().item():.3f}, "
          f"{ref.max().item():.3f}]", flush=True)
    if not (tables and db >= REDUCED_MIN_PSNR):
        raise SystemExit("3i: the relative-position model disagrees")


def check_native_preprocessing() -> None:
    """3j: the native host preprocessing built on this machine, one
    16-frame clip of uint8 720x1280 frames drawn from a seed to 320x512,
    against its numpy plain version (1e-5), timed."""
    from tooncrafter_tpu_torch import native

    t0 = time.perf_counter()
    native.library()
    built = time.perf_counter() - t0
    frames = np.random.default_rng(SEED).integers(
        0, 256, (16, 720, 1280, 3), dtype=np.uint8)
    native.preprocess_clip(frames, 320, 512)  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = native.preprocess_clip(frames, 320, 512)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    ref = native._plain_preprocess(frames, 320, 512)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(out - ref).max())
    print(f"3j native preprocessing: built in {built:.2f} s "
          f"({native.lib_path().name}, {os.cpu_count()} cores); 16x720x1280"
          f" uint8 -> {out.shape} fp32 in "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms; numpy plain version {plain_ms:.1f} ms; max_abs_err "
          f"{err:.3e} (bound 1e-5)", flush=True)
    if not err <= 1e-5:
        raise SystemExit("3j: the native preprocessing disagrees")


def norm_reads(model, dev) -> None:
    """For one UNet call of the full-width model as the sampler makes it (a
    CFG pair over one clip, ``cfg_groups=2``) and one dual-ref decode: how
    many norms took their statistics from their input, counted as
    tests/test_torch_stats_chain.py counts them, beside the count on the
    parent's route (chained sums only inside a block: every ResBlock's
    in_norm, every transformer's norm and the output norm read; in the
    decoder every ResnetBlock's norm1, every TimeStack's in_norm, the mid
    and fusion attentions' norms and norm_out), from the model's modules."""
    from tooncrafter_tpu_torch.models import unet as unet_mod
    from tooncrafter_tpu_torch.models import vae_dualref as dr
    from tooncrafter_tpu_torch.ops import fused_norms as fn
    from tooncrafter_tpu_torch.ops import norms

    cfg = model.config
    g = torch.Generator(dev).manual_seed(SEED)
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    x = torch.randn(1, t, h, w, cfg.unet_in_channels, generator=g,
                    device=dev).repeat(2, 1, 1, 1, 1)
    ctx = torch.randn(2, 77 + t * cfg.resampler_queries, cfg.context_dim,
                      generator=g, device=dev)
    z, refs = decoder_inputs(cfg, torch.Generator(dev).manual_seed(3), dev,
                             model.dtype)
    box = [0]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in (
        (norms, "gn_affine"), (norms, "group_norm"), (fn, "group_norm"),
        (fn, "_pallas_gn"))]

    def counted(real):
        def call(*a, **k):
            box[0] += 1
            return real(*a, **k)
        return call
    now = []
    try:
        for mod, attr, real in saved:
            setattr(mod, attr, counted(real))
        with torch.no_grad():
            for run in (lambda: model.unet(
                    x, torch.full((2,), 500.0, device=dev), ctx,
                    torch.full((2,), 24.0, device=dev), cfg_groups=2),
                        lambda: model.first_stage_model.decoder(z, refs)):
                box[0] = 0
                run()
                now.append(box[0])
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    count = lambda mod, cls: sum(isinstance(m, cls) for m in mod.modules())
    unet, dec = model.unet, model.first_stage_model.decoder
    before = (count(unet, unet_mod.ResBlock)
              + count(unet, unet_mod.SpatialTransformer)
              + count(unet, unet_mod.TemporalTransformer) + 1,
              count(dec, dr.VideoResBlock) + count(dec, dr.TimeStack) + 1
              + count(dec, dr.FusionCrossAttention) + 1)
    print(f"norms reading their input for statistics: a UNet call "
          f"{now[0]} (parent's route {before[0]}), a dual-ref decode "
          f"{now[1]} (parent's route {before[1]})", flush=True)


def kind_breakdown(model, dev, label: str) -> None:
    """``utils/profiling.inference_breakdown`` of the model: the UNet
    step's and the decode's norm and elementwise device ms."""
    from tooncrafter_tpu_torch.utils import profiling

    kinds = profiling.inference_breakdown(model, dev)
    for part, rows in kinds.items():
        print(f"{label} {part}: norm / softmax / reduce "
              f"{rows.get('norm / softmax / reduce', 0.0):.2f} ms, "
              f"elementwise / copy {rows.get('elementwise / copy', 0.0):.2f}"
              f" ms, busy {rows['busy_ms']:.2f} ms, wall {rows['wall_ms']:.2f}"
              f" ms", flush=True)


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
    reduced = {}
    if not all(check_reduced_model(dev, keep=reduced).values()):
        raise SystemExit("reduced model: no conv launched at a ragged tile")
    phase("3a'' per-item noise: a batch of two against each clip alone")
    check_per_item_noise(dev)
    phase("3a' reduced model with the three switches on: card against CPU")
    with switches():
        check_reduced_model(dev, KERNELS_SWITCHED)
    phase("3h the conv switches one at a time: the reduced model card "
          "against CPU, the table shapes")
    check_conv_switches(dev, reduced)
    del reduced
    phase("3i relative-position temporal attention: a reduced model card "
          "against CPU")
    check_relative_position(dev)
    phase("3j the native host preprocessing")
    check_native_preprocessing()
    phase(f"3b two full-width requests, DDIM-{args.ddim_steps}")
    counts, pipe, requests, clips = answer_requests(
        dev, args.ddim_steps, "inference_512_v1.0.yaml", 2, KERNELS_512)
    seconds_3b = sum(pipe.timings.values())  # the last request's phases
    norm_reads(pipe.model, dev)
    kind_breakdown(pipe.model, dev, "3b 320x512")
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
    phase(f"3e serving: Image2Video resident on the card, three requests")
    counts_serve = serve_requests(dev, args.ddim_steps)
    phase("3f the dual-ref decoder's 'attn-only' and 'all' time modes")
    counts_modes = check_time_modes(dev)
    phase(f"3g ddpm_sample and decode_plain: card against CPU; the smoke CLI")
    check_ddpm_decode_plain(dev)
    from tooncrafter_tpu_torch.cli import smoke
    t0 = time.perf_counter()
    smoke.main(["--steps", "3", "--out",
                os.path.join(REPO, "build", "smoke", "clip")])
    torch.cuda.synchronize()
    print(f"3g cli/smoke.py on the card: {time.perf_counter() - t0:.2f} s",
          flush=True)
    phase(f"3c one full-width 576x1024 request, DDIM-{args.ddim_steps}")
    counts_1024, pipe_1024, _, _ = answer_requests(
        dev, args.ddim_steps, "inference_1024_v1.0.yaml", 1, KERNELS_1024)
    kind_breakdown(pipe_1024.model, dev, "3c 576x1024")
    del pipe_1024
    phase("4a reduced training model: card gradients against CPU")
    check_reduced_training(dev)
    print("4a, second run: the reduced model at the 512 model's ds2 and ds4 "
          "shapes (#13 on the training branch)", flush=True)
    check_reduced_training(dev, TABLE_TRAIN_KERNELS, table_config)
    phase(f"4b full-width training, {TRAIN_STEPS} steps, then "
          f"{PROFILE_STEPS} with each of adamw_lowmem and adafactor")
    train_counts, train_s, train_peak, kept = train_full_width(
        dev, profiles=("adamw_lowmem", "adafactor"), keep=True)
    phase("4d validation with the EMA weights and a sampled clip")
    check_validation(dev, *kept)
    del kept
    phase("4a' reduced training model with TOONCRAFTER_FUSED_GN=1 and "
          "TC_SPATIAL_CONV_PALLAS=1: card gradients against CPU")
    with switches(pair=True):  # the shallow model: cut for the time limit
        check_reduced_training(dev, REDUCED_TRAIN_KERNELS_SWITCHED,
                               shallow_config)
    phase(f"4b' full-width training with TOONCRAFTER_FUSED_GN=1 and "
          f"TC_SPATIAL_CONV_PALLAS=1, {TRAIN_STEPS_SWITCHED} steps")
    with switches(pair=True):
        train_sw, sw_s, sw_peak = train_full_width(
            dev, TRAIN_STEPS_SWITCHED, TRAIN_KERNELS_SWITCHED)
    print(f"4b' beside 4b: _pallas_gn launches per step "
          f"{train_sw['_pallas_gn'] / TRAIN_STEPS_SWITCHED:.0f} (the "
          f"checkpointed blocks' recomputation included) against 0; step "
          f"seconds {', '.join(f'{t:.2f}' for t in sw_s)} against "
          f"{', '.join(f'{t:.2f}' for t in train_s)}; peak {sw_peak:.2f} "
          f"GiB against {train_peak:.2f}", flush=True)
    phase(f"4c full-width 576x1024 training, {TRAIN_STEPS_1024} steps")
    train_1024, s_1024, peak_1024 = train_full_width(
        dev, TRAIN_STEPS_1024, TRAIN_KERNELS_1024,
        yaml="training_1024_v1.0.yaml")
    print(f"4c: step seconds {', '.join(f'{t:.2f}' for t in s_1024)}; peak "
          f"{peak_1024:.2f} GiB; launches per step "
          + ", ".join(f"{k} {v / TRAIN_STEPS_1024:.0f}"
                      for k, v in train_1024.items() if v), flush=True)
    phase(f"5a world 1 over NCCL: full-width training, the reduced "
          f"gradients against one process, {WORLD1_STEPS} AdamW steps")
    counts_5a = check_world1_training(dev, train_s, train_peak)
    phase("5b two ranks sharing the card over gloo: reduced training")
    counts_5b = check_two_rank_training(dev)
    phase(f"5c two ranks sharing the card over gloo: full-width serving of "
          f"three clips, DDIM-{SERVE_DDIM_STEPS}")
    counts_5c = check_two_rank_serving(dev, seconds_3b)
    phase("5d the graft entry's UNet forward and its two-rank dry run")
    check_graft_entry(dev)
    phase("5e tensor parallelism at (1, 2): one full-width 512 UNet call "
          "against world one")
    counts_5e = check_tp_denoise(dev)
    phase("5f tensor parallelism at (1, 2): reduced training, two AdamW "
          "steps, the checkpoint at (1, 1)")
    counts_5f = check_tp_training(dev)
    phase("5g four ranks at (2, 2): BatchedPipeline(shard_params=True) and "
          "the graft dry run")
    counts_5g = check_tp_four_ranks(dev)
    summary = []
    paths = (counts, counts_1024, train_counts, counts_sw, train_sw,
             train_1024, counts_serve, counts_modes, counts_5a, *counts_5b,
             *counts_5c, *counts_5e, *counts_5f, *counts_5g, counts_ops)
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
        # (4b'), else the 576x1024 training steps (4c), else the paths of
        # phases 3e, 3f and 5, else the op functions (2')
        row["launches"] = next((c[name] for c in paths if c[name]), 0)
        row["launches_512"] = counts[name]
        row["launches_1024"] = counts_1024[name]
        row["launches_train"] = train_counts[name]
        row["launches_512_switched"] = counts_sw[name]
        row["launches_train_switched"] = train_sw[name]
        row["launches_train_1024"] = train_1024[name]
        row["launches_serve"] = counts_serve[name]
        row["launches_time_modes"] = counts_modes[name]
        row["launches_ops"] = counts_ops[name]
        row["launches_5a_world1"] = counts_5a[name]
        for r, c in enumerate(counts_5b):
            row[f"launches_5b_rank{r}"] = c[name]
        for r, c in enumerate(counts_5c):
            row[f"launches_5c_rank{r}"] = c[name]
        for label, ranks in (("5e", counts_5e), ("5f", counts_5f),
                             ("5g", counts_5g)):
            for r, c in enumerate(ranks):
                row[f"launches_{label}_rank{r}"] = c[name]
        summary.append(row)
    missed = [r["name"] for r in summary if not r["launches"]]
    if missed or len(summary) != len(kc.REPLACES):
        raise SystemExit(f"kernels {missed} launched on no path, or "
                         f"{len(summary)} rows for {len(kc.REPLACES)} TPU "
                         f"kernels")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - _T0:.1f} s", flush=True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
