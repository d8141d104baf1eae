"""KL autoencoder, f=8, 4-channel latent (tooncrafter_tpu/models/vae.py).

The Encoder returns the per-level hidden-state taps (after each level's
res blocks, before its downsample) plus the conv_in feature, which the
dual-reference decoder consumes. The plain ``Decoder`` (the DynamiCrafter
lineage's, after ``post_quant_conv``) decodes one frame at a time.
Tensors are channels-last (N, H, W, C); parameter names follow the
upstream ``first_stage_model`` state dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tooncrafter_tpu_torch.ops.attention import attention
from tooncrafter_tpu_torch.ops.norms import GroupNorm
from tooncrafter_tpu_torch.ops.spatial_conv import (Conv1x1, Conv2d,
                                                    Downsample, Upsample,
                                                    spatial_conv3x3)


class ResnetBlock(nn.Module):
    """GN+swish+conv x2 with a 1x1 ``nin_shortcut`` on a channel change,
    run as the JAX package's fused branch (its dropout is 0, so always;
    tooncrafter_tpu/models/vae.py:54-63): norm1 folds into conv1's
    prologue, conv1's sums fold norm2 into conv2's, and the skip rides
    conv2's epilogue, each conv through ``spatial_conv3x3`` (a kernel where
    the JAX package takes a TPU kernel, F.conv2d where it runs XLA)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, 1e-6, act=True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout, 1e-6, act=True)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv1x1(cin, cout)

    def forward(self, x, stats=None, return_stats: bool = False):
        """``stats``: the producer's sums of x, each (N, C), for norm1 (it
        then reads x for no statistics); with ``return_stats`` also conv2's
        sums of the output, (y, s1, s2) (tooncrafter_tpu/models/vae.py:
        42-69)."""
        skip = self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x
        h, s1, s2 = spatial_conv3x3(x, self.norm1.folded(x, stats=stats),
                                    self.conv1, return_stats=True)
        return spatial_conv3x3(h, self.norm2.folded(h, stats=(s1, s2)),
                               self.conv2, residual=skip,
                               return_stats=return_stats)


class AttnBlock(nn.Module):
    """Single-head self-attention over the h*w tokens (1x1-conv q/k/v)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c, 1e-6, one_pass=False)
        self.q = Conv1x1(c, c)
        self.k = Conv1x1(c, c)
        self.v = Conv1x1(c, c)
        self.proj_out = Conv1x1(c, c)

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = self.norm(x)
        toks = lambda t: t.reshape(b, hh * ww, c)
        out = attention(toks(self.q(h)), toks(self.k(h)), toks(self.v(h)),
                        heads=1)
        return x + self.proj_out(out.reshape(b, hh, ww, c))


class DownLevel(nn.Module):
    def __init__(self, cin: int, cout: int, num_res_blocks: int,
                 downsample: bool):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(cin if i == 0 else cout, cout)
            for i in range(num_res_blocks))
        if downsample:
            self.downsample = Downsample(cout, asymmetric=True)

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        tap = x
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return x, tap


class MidBlock(nn.Module):
    def __init__(self, c: int, block=ResnetBlock, attn=AttnBlock):
        super().__init__()
        self.block_1 = block(c, c)
        self.attn_1 = attn(c)
        self.block_2 = block(c, c)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 in_channels: int = 3, double_z: bool = True):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        mults = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList(
            DownLevel(ch * mults[i], ch * mults[i + 1], num_res_blocks,
                      downsample=i != len(ch_mult) - 1)
            for i in range(len(ch_mult)))
        c = ch * ch_mult[-1]
        self.mid = MidBlock(c)
        self.norm_out = GroupNorm(c, 1e-6, act=True)
        self.conv_out = Conv2d(c, 2 * z_channels if double_z else z_channels,
                               3, padding=1)

    def forward(self, x):
        """x: (N, H, W, 3) -> (moments, [level taps..., conv_in feature])."""
        h = self.conv_in(x)
        taps = []
        conv_in_feat = h
        for level in self.down:
            h, tap = level(h)
            taps.append(tap)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h)), taps + [conv_in_feat]


class UpLevel(nn.Module):
    """num_res_blocks + 1 blocks of ``block``, then a nearest-2x upsample
    and 3x3 conv unless it is the last level."""

    def __init__(self, cin: int, cout: int, num_res_blocks: int,
                 upsample: bool, block=ResnetBlock):
        super().__init__()
        self.block = nn.ModuleList(
            block(cin if i == 0 else cout, cout)
            for i in range(num_res_blocks + 1))
        if upsample:
            self.upsample = Upsample(cout)


class Decoder(nn.Module):
    """The plain decoder: conv_in, the mid block, levels 3..0 (blocks then
    upsample), GN+swish and conv_out, one (N, h, w, z) frame batch at a
    time."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = MidBlock(block_in)
        ups, c = [], block_in
        for level in reversed(range(len(ch_mult))):
            ups.append(UpLevel(c, ch * ch_mult[level], num_res_blocks,
                               upsample=level != 0))
            c = ch * ch_mult[level]
        self.up = nn.ModuleList(reversed(ups))
        self.norm_out = GroupNorm(c, 1e-6, act=True)
        self.conv_out = Conv2d(c, out_ch, 3, padding=1)

    def forward(self, z):
        """z: (N, h, w, z_ch) after post_quant_conv -> (N, H, W, out_ch)."""
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(
            self.conv_in(z))))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h))


class DiagonalGaussian:
    def __init__(self, moments):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator=None):
        return self.mean + self.std * torch.randn(
            self.mean.shape, generator=generator, device=self.mean.device,
            dtype=self.mean.dtype)

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    """Encoder + quant convs + ``decoder``: the dual-reference video decoder
    of a ToonCrafter model (models/vae_dualref.py, which skips
    ``post_quant_conv``), or the plain ``Decoder`` of a DynamiCrafter-style
    one. Both sit under the upstream key ``first_stage_model.decoder``, so
    either checkpoint loads with ``load_state_dict``."""

    def __init__(self, decoder: nn.Module, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 embed_dim: int = 4):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = decoder
        self.quant_conv = Conv1x1(2 * z_channels, 2 * embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, z_channels)

    def encode(self, x):
        """x: (N, H, W, 3) -> (moments (N, h, w, 2*embed_dim), taps)."""
        h, taps = self.encoder(x)
        return self.quant_conv(h), taps

    def decode(self, z):
        """z: (N, h, w, embed_dim) -> (N, H, W, 3) through post_quant_conv
        and the plain decoder."""
        if not isinstance(self.decoder, Decoder):
            raise TypeError("decode runs the plain decoder; this autoencoder "
                            f"holds a {type(self.decoder).__name__}")
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator=None):
        """The round trip: (reconstruction, moments). The latent is drawn
        from the posterior with ``generator`` when one is given, else its
        mode."""
        moments, _ = self.encode(x)
        post = DiagonalGaussian(moments)
        z = post.sample(generator) if generator is not None else post.mode()
        return self.decode(z), moments
