"""Dual-reference 3D VAE decoder (tooncrafter_tpu/models/vae_dualref.py),
in the three time modes of the reference's VideoDecoder: ``conv-only``
(shipped), ``all`` and ``attn-only``.

  * VideoResBlock: a per-frame ResnetBlock, then (unless ``attn-only``) a
    (3,1,1) temporal residual stack merged as x + sigmoid(mix_factor) *
    stack(x), its two convs through the fused temporal conv kernel
    (ops/temporal_conv.py).
  * mid attention: per-frame single-head self-attention (d = C = 512 at
    full width, the d=512 flash kernel); under ``all`` and ``attn-only``
    the TimeAttnBlock, which mixes that attention with a temporal
    transformer over the frames (its attention over T = 16 tokens stays
    on the plain path, as the TPU package leaves it to XLA).
  * FusionCrossAttention at levels {2, 3}: per-frame GroupNorm, 8 heads of
    64; all frames share the first/last-frame K/V, so frames ride the query
    axis of one attention per clip (the d=64 flash kernel with lse).
  * Combiner at the other levels and after norm_out: a 1x1 conv of the
    reference features added to frames 0 and -1.
  * AE3DConv output: a 2-D conv per frame, then (unless ``attn-only``) a
    temporal mixing conv.
The caller passes raw latents (``post_quant_conv`` is skipped on this
path). Tensors are (B, T, H, W, C).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
from torch import nn

from tooncrafter_tpu_torch.ops.attention import attention
from tooncrafter_tpu_torch.ops.norms import (GroupNorm, LayerNorm,
                                             apply_affine, replace_end_frames)
from tooncrafter_tpu_torch.ops.schedule import timestep_embedding
from tooncrafter_tpu_torch.ops.spatial_conv import Conv1x1, Conv2d
from tooncrafter_tpu_torch.ops.temporal_conv import TemporalConv3
from tooncrafter_tpu_torch.models.unet import CrossAttention, FeedForward
from tooncrafter_tpu_torch.models.vae import (AttnBlock, MidBlock,
                                              ResnetBlock, UpLevel)

TIME_MODES = ("all", "conv-only", "attn-only")


def _fold(x):
    return x.reshape((-1,) + x.shape[2:])


class TimeStack(nn.Module):
    """GN+SiLU+Conv3d(3,1,1) x2; GN statistics span T, H and W (eps 1e-5).
    ``in_layers`` = [GN, SiLU, conv], ``out_layers`` = [GN, SiLU, Dropout,
    conv] as upstream. Its dropout is 0, so it always runs fused, as the
    JAX package does: each GN+SiLU is a folded affine applied in the next
    temporal conv's prologue, in_conv's per-frame sums feed out_norm, and
    the alpha merge rides out_conv's epilogue as scale + residual, with the
    per-frame sums of the merged output that the next block's norm folds."""

    def __init__(self, c: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(c, 1e-5, act=True),
                                       nn.SiLU(), TemporalConv3(c, c))
        self.out_layers = nn.Sequential(GroupNorm(c, 1e-5, act=True),
                                        nn.SiLU(), nn.Dropout(0.0),
                                        TemporalConv3(c, c))

    def forward(self, x, merge_scale, stats=None,
                return_stats: bool = False):
        """x + merge_scale * stack(x); ``stats``: the producer's per-frame
        sums of x, each (B, T, C), folded over T for in_norm; with
        ``return_stats`` (y, s1, s2), the per-frame sums of y."""
        st = None if stats is None else tuple(s.sum(1) for s in stats)
        h, s1, s2 = self.in_layers[2].fused(
            x, self.in_layers[0].folded(x, stats=st), return_stats=True)
        aff = self.out_layers[0].folded(h, stats=(s1.sum(1), s2.sum(1)))
        return self.out_layers[3].fused(h, aff, residual=x,
                                        out_scale=merge_scale,
                                        return_stats=return_stats)


class VideoResBlock(ResnetBlock):
    """A per-frame ResnetBlock; with ``temporal`` (every mode but
    ``attn-only``) its time stack and mix_factor."""

    def __init__(self, cin: int, cout: int, temporal: bool = True):
        super().__init__(cin, cout)
        if temporal:
            self.time_stack = TimeStack(cout)
            self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x, stats=None, return_stats: bool = False):
        """``stats`` in and out: per-frame sums, each (B, T, C), chained
        through every conv epilogue (vae_dualref.py:124-150)."""
        b, t = x.shape[:2]
        st = None if stats is None else tuple(s.reshape(b * t, -1)
                                              for s in stats)
        x, s1, s2 = super().forward(_fold(x), stats=st, return_stats=True)
        x = x.reshape((b, t) + x.shape[1:])
        rb = (s1.reshape(b, t, -1), s2.reshape(b, t, -1))
        if not hasattr(self, "time_stack"):
            return (x, *rb) if return_stats else x
        # a*(x + stack(x)) + (1-a)*x == x + a*stack(x), a in fp32
        return self.time_stack(x, torch.sigmoid(self.mix_factor.float())[0],
                               stats=rb, return_stats=return_stats)


class AE3DConv(Conv2d):
    """2-D conv per frame; with ``temporal`` a (3,1,1) mixing conv after it
    (without, the reference's Conv2DWrapper)."""

    def __init__(self, cin: int, cout: int, temporal: bool = True):
        super().__init__(cin, cout, 3, padding=1)
        if temporal:
            self.time_mix_conv = TemporalConv3(cout, cout)

    def forward(self, x):
        b, t = x.shape[:2]
        y = super().forward(_fold(x))
        y = y.reshape((b, t) + y.shape[1:])
        if not hasattr(self, "time_mix_conv"):
            return y
        return self.time_mix_conv(y)


class SVDTemporalBlock(nn.Module):
    """The reference's VideoTransformerBlock as the decoder builds it: one
    head of d = C, a GEGLU ``ff_in`` (exact erf), self-attention twice and
    the FF, each pre-LayerNorm with a residual, over the T frames of every
    spatial token."""

    def __init__(self, c: int):
        super().__init__()
        self.norm_in = LayerNorm(c)
        self.ff_in = FeedForward(c)
        self.attn1 = CrossAttention(c, 1, c)  # self-attention, one head
        self.attn2 = CrossAttention(c, 1, c)
        self.norm1 = LayerNorm(c)
        self.norm2 = LayerNorm(c)
        self.norm3 = LayerNorm(c)
        self.ff = FeedForward(c)

    def forward(self, x, timesteps: int):
        """x: (B*T, S, C) frame-major -> the same shape."""
        bt, s, c = x.shape
        b = bt // timesteps
        x = x.reshape(b, timesteps, s, c).transpose(1, 2).reshape(
            b * s, timesteps, c)
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x)) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(b, s, timesteps, c).transpose(1, 2).reshape(
            bt, s, c)


class TimeAttnBlock(AttnBlock):
    """The mid attention of the ``all`` and ``attn-only`` modes: per-frame
    single-head attention, alpha-merged with a temporal transformer over the
    frames fed that attention plus a frame-position embedding (the
    ``video_time_embed`` MLP)."""

    def __init__(self, c: int):
        super().__init__(c)
        self.video_time_embed = nn.Sequential(
            nn.Linear(c, 4 * c), nn.SiLU(), nn.Linear(4 * c, c))
        self.time_mix_block = SVDTemporalBlock(c)
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = self.norm(_fold(x))
        toks = lambda a: a.reshape(b * t, hh * ww, c)
        att = attention(toks(self.q(h)), toks(self.k(h)), toks(self.v(h)),
                        heads=1)
        # frame index of row b*t + i is i
        frames = torch.arange(t, dtype=torch.float32,
                              device=x.device).repeat(b)
        emb = self.video_time_embed(timestep_embedding(frames, c).to(
            att.dtype))
        x_mix = self.time_mix_block(att + emb[:, None, :], t)
        a = torch.sigmoid(self.mix_factor.float()).to(att.dtype)
        out = self.proj_out(a * att + (1.0 - a) * x_mix)
        return x + out.reshape(b, t, hh, ww, c)


class FusionCrossAttention(nn.Module):
    def __init__(self, c: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = GroupNorm(c, 1e-6, one_pass=False)
        self.to_q = nn.Linear(c, inner, bias=False)
        self.to_k = nn.Linear(c, inner, bias=False)
        self.to_v = nn.Linear(c, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, c), nn.Dropout(0.0))

    def forward(self, x, context):
        """x: (B, T, H, W, C); context: (B, 2, H, W, C)."""
        b, t, hh, ww, c = x.shape
        h = self.norm(_fold(x)).reshape(b, t * hh * ww, c)
        ctx = context.reshape(b, -1, c)
        out = attention(self.to_q(h), self.to_k(ctx), self.to_v(ctx),
                        heads=self.heads)
        return x + self.to_out(out).reshape(b, t, hh, ww, c)


class Combiner(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv1x1(c, c)

    def forward(self, x, context, stats=None):
        """With ``stats`` (per-frame sums of x, each (B, T, C)) also the
        sums of the output: frames 0 and -1 summed afresh, the rest kept."""
        ctx = self.conv(context)
        first, last = x[:, :1] + ctx[:, :1], x[:, -1:] + ctx[:, 1:2]
        out = torch.cat([first, x[:, 1:-1], last], dim=1)
        if stats is None:
            return out
        return (out, *replace_end_frames(stats, first, last))


class DualRefVideoDecoder(nn.Module):
    @classmethod
    def from_config(cls, cfg) -> "DualRefVideoDecoder":
        """The decoder of a ModelConfig (its ``vae_*`` and ``dualref_*``
        fields)."""
        return cls(ch=cfg.vae_ch, ch_mult=tuple(cfg.vae_ch_mult),
                   num_res_blocks=cfg.vae_num_res_blocks,
                   attn_level=tuple(cfg.dualref_attn_level),
                   z_channels=cfg.z_channels,
                   time_mode=cfg.dualref_time_mode)

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_level: Sequence[int] = (2, 3),
                 z_channels: int = 4, time_mode: str = "conv-only"):
        super().__init__()
        if time_mode not in TIME_MODES:
            raise ValueError(f"time_mode={time_mode!r}, not one of "
                             f"{TIME_MODES}")
        # which sub-blocks get temporal machinery
        self.time_attn = time_mode in ("all", "attn-only")
        time_res = time_mode != "attn-only"
        block = functools.partial(VideoResBlock, temporal=time_res)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = MidBlock(block_in, block=block,
                            attn=TimeAttnBlock if self.time_attn
                            else AttnBlock)
        ups, refine = [], []
        c = block_in
        for level in reversed(range(len(ch_mult))):
            cout = ch * ch_mult[level]
            ups.append(UpLevel(c, cout, num_res_blocks, upsample=level != 0,
                               block=block))
            refine.append(FusionCrossAttention(cout) if level in attn_level
                          else Combiner(cout))
            c = cout
        self.up = nn.ModuleList(reversed(ups))
        self.attn_refinement = nn.ModuleList(
            list(reversed(refine)) + [Combiner(c)])
        # folded from the chained sums (no one-pass kernel)
        self.norm_out = GroupNorm(c, 1e-6, one_pass=False)
        self.conv_out = AE3DConv(c, out_ch, temporal=time_res)

    def forward(self, z, refs: List[torch.Tensor]):
        """z: (B, T, h, w, z_ch) raw latents; refs: the encoder taps, each
        (B, 2, H_l, W_l, C_l), ordered [level 0..3, conv_in].

        Per-frame (B, T, C) sums of h chain from block to block through the
        conv epilogues, as the JAX decoder chains them (vae_dualref.py:
        384-446): no VideoResBlock after the mid block reads its input for
        statistics; a Combiner sums its two touched frames afresh, a fusion
        cross-attention resets the chain and the upsample conv re-seeds
        it; norm_out folds the last sums."""
        b, t = z.shape[:2]
        h = self.conv_in(_fold(z))
        h = h.reshape((b, t) + h.shape[1:])
        h, *st = self.mid.block_1(h, return_stats=True)
        if self.time_attn:
            h = self.mid.attn_1(h)
        else:
            h = self.mid.attn_1(_fold(h)).reshape(h.shape)
        h, *st = self.mid.block_2(h, return_stats=True)
        for level in reversed(range(len(self.up))):
            up = self.up[level]
            for blk in up.block:
                h, *st = blk(h, stats=st or None, return_stats=True)
            inject = self.attn_refinement[level]
            if isinstance(inject, Combiner):
                h, *st = inject(h, refs[level], stats=tuple(st))
            else:
                h, st = inject(h, refs[level]), []
            if hasattr(up, "upsample"):
                f, s1, s2 = up.upsample(_fold(h), return_stats=True)
                h = f.reshape((b, t) + f.shape[1:])
                st = [s.reshape(b, t, -1) for s in (s1, s2)]
        # per-frame norm_out from the chained sums, the SiLU in fp32
        f = _fold(h)
        a, c = self.norm_out.folded(f, stats=tuple(
            s.reshape(b * t, -1) for s in st) if st else None)
        h = apply_affine(f, a, c, act=True).reshape(h.shape)
        h = self.attn_refinement[-1](h, refs[-1])
        return self.conv_out(h)
