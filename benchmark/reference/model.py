"""The plain reference of the ToonCrafter interpolation model, in float32.

Straightforward PyTorch, written from the published architecture (the
upstream ``lvdm`` modules of ToonCrafter and DynamiCrafter): the UNet with
its temporal blocks, the KL encoder, the dual-reference video decoder, the
OpenCLIP ViT-H/14 text and vision towers and the image-context resampler.
Module and parameter names are the upstream state-dict keys, so one state
dict loads here and into the system under test. It imports nothing but
torch and numpy; no kernel, cache or fused path.

Tensors are channels-last: a video is (B, T, H, W, C), a frame batch
(N, H, W, C). Attention is computed in blocks of queries, so that the
576x1024 shapes fit a card in float32.

Every product (linear, convolution, both attention products) goes through
``Ops``: with ``Ops.fp8`` both operands are rounded to float8 e4m3 with a
per-tensor scale before an fp32 product. That is the control of the
benchmark's comparison, the reference computed one precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

F8_MAX = 448.0  # the largest finite float8 e4m3fn


class Ops:
    """The precision every product of one reference model runs in."""

    def __init__(self, fp8: bool = False,
                 attn_bytes: int = 1 << 30):
        self.fp8 = fp8
        self.attn_bytes = attn_bytes

    def q(self, x):
        """x as the product sees it: itself, or rounded to float8 e4m3
        with one scale for the tensor."""
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float().clamp_min(1e-12)
        s = amax / F8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    def linear(self, x, weight, bias=None):
        return F.linear(self.q(x), self.q(weight), bias)

    def conv(self, x, weight, bias=None, stride=1, padding=0):
        """x (N, H, W, C) through a 2-D conv of an OIHW weight."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(weight), bias,
                     stride, padding)
        return y.permute(0, 2, 3, 1)

    def tconv(self, x, weight, bias):
        """x (B, T, *S, C) through a (3, 1, 1) conv over T, zero-padded:
        the centre tap on every frame, the outer taps on the frames that
        have a neighbour (the 3T - 2 in-clip taps), summed into the centre
        tap's output."""
        w = self.q(weight[:, :, :, 0, 0])          # (Cout, Cin, 3)
        xq = self.q(x)
        out = F.linear(xq, w[:, :, 1], bias)
        out[:, 1:] += F.linear(xq[:, :-1], w[:, :, 0])
        out[:, :-1] += F.linear(xq[:, 1:], w[:, :, 2])
        return out

    def attend(self, q, k, v, heads: int, mask=None, scale=None):
        """q (B, Sq, H*D), k and v (B, Sk, H*D) -> (B, Sq, H*D): softmax
        in fp32, in blocks of queries small enough for ``attn_bytes`` of
        logits. ``mask`` (Sq, Sk) bool, True = keep."""
        b, sq, inner = q.shape
        sk = k.shape[1]
        d = inner // heads
        scale = d ** -0.5 if scale is None else scale
        qh = self.q(q).reshape(b, sq, heads, d).transpose(1, 2)
        kh = self.q(k).reshape(b, sk, heads, d).transpose(1, 2)
        vh = self.q(v).reshape(b, sk, heads, d).transpose(1, 2)
        out = torch.empty_like(qh)
        per_row = heads * sk * 4
        rows = max(1, self.attn_bytes // per_row)
        bstep = max(1, min(b, rows // sq))
        qstep = sq if bstep > 1 else max(1, min(sq, rows))
        for b0 in range(0, b, bstep):
            for s0 in range(0, sq, qstep):
                logits = torch.matmul(qh[b0:b0 + bstep, :, s0:s0 + qstep],
                                      kh[b0:b0 + bstep].transpose(-1, -2))
                logits = logits.float() * scale
                if mask is not None:
                    logits = logits.masked_fill(
                        ~mask[s0:s0 + qstep],
                        torch.finfo(torch.float32).min)
                p = torch.softmax(logits, dim=-1)
                out[b0:b0 + bstep, :, s0:s0 + qstep] = torch.matmul(
                    self.q(p), vh[b0:b0 + bstep])
        return out.transpose(1, 2).reshape(b, sq, inner)


class Linear(nn.Linear):
    ops = Ops()

    def forward(self, x):
        return self.ops.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """OIHW weight applied to (N, H, W, C)."""

    ops = Ops()

    def forward(self, x):
        return self.ops.conv(x, self.weight, self.bias, self.stride,
                             self.padding)


class Conv1x1(nn.Conv2d):
    ops = Ops()

    def __init__(self, cin, cout, bias=True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        return self.ops.linear(x, self.weight[:, :, 0, 0], self.bias)


class Conv1d1(nn.Conv1d):
    ops = Ops()

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return self.ops.linear(x, self.weight[:, :, 0], self.bias)


class TemporalConv(nn.Conv3d):
    ops = Ops()

    def __init__(self, c):
        super().__init__(c, c, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        return self.ops.tconv(x, self.weight, self.bias)


def set_ops(model: nn.Module, ops: Ops) -> nn.Module:
    """Give every product of ``model`` the precision of ``ops``."""
    model.ops = ops
    for m in model.modules():
        if hasattr(type(m), "ops"):
            m.ops = ops
    return model


def group_norm(x, norm: nn.GroupNorm, shift=None):
    """GroupNorm over every axis but the first and last (channels-last),
    statistics in fp32; ``shift`` (N, C) added to x first. Without
    autograd the result is formed in place (the 576x1024 decoder's
    activations are 4.5 GiB each in fp32)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if shift is not None:
        xf = xf + shift.float().reshape((n,) + (1,) * (x.ndim - 2) + (c,))
    g = xf.reshape(n, -1, norm.num_groups, c // norm.num_groups)
    var, mean = torch.var_mean(g, dim=(1, 3), correction=0, keepdim=True)
    if torch.is_grad_enabled():
        y = ((g - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
        return y * norm.weight + norm.bias
    y = (g - mean).mul_(torch.rsqrt(var + norm.eps)).reshape(x.shape)
    return y.mul_(norm.weight).add_(norm.bias)


def gn(c, eps):
    return nn.GroupNorm(32, c, eps=eps)


def silu(x):
    return F.silu(x)


def timestep_embedding(t, dim: int, max_period: int = 10000):
    half = dim // 2
    ts = torch.as_tensor(t, dtype=torch.float32)
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=ts.device) / half)
    args = ts[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Dropout(nn.Module):
    """Dropout whose mask is drawn as the system under test draws it: a
    ``mask_dtype`` tensor of ones through ``F.dropout`` on the same device
    and stream of the global generator, so the same shapes in the same
    order give the same masks."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.mask_dtype = torch.bfloat16

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = F.dropout(torch.ones(x.shape, dtype=self.mask_dtype,
                                    device=x.device), self.p, True) != 0
        return x * keep / (1.0 - self.p)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

class TemporalConvBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Sequential(gn(c, 1e-5), nn.SiLU(), TemporalConv(c))
        for i in (2, 3, 4):
            setattr(self, f"conv{i}", nn.Sequential(
                gn(c, 1e-5), nn.SiLU(), Dropout(0.1), TemporalConv(c)))

    def forward(self, x):
        h = x
        for i in (1, 2, 3, 4):
            seq = getattr(self, f"conv{i}")
            h = silu(group_norm(h, seq[0]))
            if i > 1:
                h = seq[2](h)
            h = seq[-1](h)
        return x + h


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_ch):
        super().__init__()
        self.in_layers = nn.Sequential(gn(cin, 1e-5), nn.SiLU(),
                                       Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(gn(cout, 1e-5), nn.SiLU(),
                                        Dropout(0.1),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = (Conv1x1(cin, cout) if cin != cout
                                else nn.Identity())
        self.temopral_conv = TemporalConvBlock(cout)

    def forward(self, x, emb, t: int):
        e = self.emb_layers[1](silu(emb))
        h = self.in_layers[2](silu(group_norm(x, self.in_layers[0])))
        h = self.out_layers[2](silu(group_norm(h, self.out_layers[0], e)))
        h = self.skip_connection(x) + self.out_layers[3](h)
        h5 = h.reshape((-1, t) + h.shape[1:])
        return self.temopral_conv(h5).reshape(h.shape)


class CrossAttention(nn.Module):
    def __init__(self, qdim, heads, dim_head, ctx_dim=None,
                 image_branch=False, ip_learnable=False, text_len=77):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = ctx_dim or qdim
        self.heads, self.text_len = heads, text_len
        self.image_branch = image_branch
        self.to_q = Linear(qdim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, qdim), nn.Dropout(0.0))
        if image_branch:
            self.to_k_ip = Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = Linear(ctx_dim, inner, bias=False)
            if ip_learnable:
                self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, x, context=None):
        ops = self.to_q.ops
        if x.ndim == 5:  # self-attention over T, per pixel
            b, t, hh, ww, c = x.shape
            flat = lambda a: a.permute(0, 2, 3, 1, 4).reshape(
                b * hh * ww, t, a.shape[-1])
            out = ops.attend(flat(self.to_q(x)), flat(self.to_k(x)),
                             flat(self.to_v(x)), self.heads)
            out = out.reshape(b, hh, ww, t, -1).permute(0, 3, 1, 2, 4)
            return self.to_out(out)
        q = self.to_q(x)
        if context is None:
            return self.to_out(ops.attend(q, self.to_k(x), self.to_v(x),
                                          self.heads))
        text = context[:, :self.text_len]
        out = ops.attend(q, self.to_k(text), self.to_v(text), self.heads)
        if self.image_branch:
            img = context[:, self.text_len:]
            out_ip = ops.attend(q, self.to_k_ip(img), self.to_v_ip(img),
                                self.heads)
            if hasattr(self, "alpha"):
                out_ip = out_ip * (torch.tanh(self.alpha) + 1.0)
            out = out + out_ip
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.proj = Linear(din, dout * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


def layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight, norm.bias,
                        norm.eps)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim, image_branch=False,
                 ip_learnable=False, cross=True):
        super().__init__()
        self.cross = cross
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, heads, dim_head,
                                    ctx_dim if cross else None,
                                    image_branch=image_branch,
                                    ip_learnable=ip_learnable)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = self.attn1(layer_norm(x, self.norm1)) + x
        x = self.attn2(layer_norm(x, self.norm2),
                       context if self.cross else None) + x
        return self.ff(layer_norm(x, self.norm3)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, c, heads, dim_head, depth, ctx_dim, ip_learnable):
        super().__init__()
        inner = heads * dim_head
        self.norm = gn(c, 1e-6)
        self.proj_in = Linear(c, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, ctx_dim,
                                  image_branch=True,
                                  ip_learnable=ip_learnable)
            for _ in range(depth))
        self.proj_out = Linear(inner, c)

    def forward(self, x, context):
        n, hh, ww, c = x.shape
        h = self.proj_in(group_norm(x, self.norm).reshape(n, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return x + self.proj_out(h).reshape(n, hh, ww, c)


class TemporalTransformer(nn.Module):
    def __init__(self, c, heads, dim_head, depth, linear=True):
        super().__init__()
        inner = heads * dim_head
        self.norm = gn(c, 1e-6)
        proj = Linear if linear else Conv1d1
        self.proj_in = proj(c, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, None, cross=False)
            for _ in range(depth))
        self.proj_out = proj(inner, c)

    def forward(self, x):
        h = self.proj_in(group_norm(x, self.norm))
        for blk in self.transformer_blocks:
            h = blk(h)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.op = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2))


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        mc = cfg["model_channels"]
        ted = mc * 4
        nhc = cfg["num_head_channels"]
        depth = cfg["transformer_depth"]
        self.mc = mc
        self.text_len = 77
        self.img_tokens = cfg["resampler_queries"]
        self.attn_res = tuple(cfg["attention_resolutions"])
        self.use_checkpoint = bool(cfg.get("use_checkpoint", False))

        def spatial(ch):
            return SpatialTransformer(
                ch, ch // nhc, nhc, depth, cfg["context_dim"],
                cfg["image_cross_attention_scale_learnable"])

        def temporal(ch):
            return TemporalTransformer(ch, ch // nhc, nhc, depth)

        self.time_embed = nn.Sequential(Linear(mc, ted), nn.SiLU(),
                                        Linear(ted, ted))
        self.fps_embedding = nn.Sequential(Linear(mc, ted), nn.SiLU(),
                                           Linear(ted, ted))
        self.input_blocks = nn.ModuleList([nn.ModuleList(
            [Conv2d(cfg["unet_in_channels"], mc, 3, padding=1)])])
        self.init_attn = nn.ModuleList([TemporalTransformer(
            mc, 8, nhc, depth, linear=False)])
        chans, ch, ds = [mc], mc, 1
        mults = cfg["channel_mult"]
        nres = cfg["num_res_blocks"]
        for level, mult in enumerate(mults):
            for _ in range(nres):
                blk = [ResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in self.attn_res:
                    blk += [spatial(ch), temporal(ch)]
                self.input_blocks.append(nn.ModuleList(blk))
                chans.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted), spatial(ch), temporal(ch),
            ResBlock(ch, ch, ted)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(nres + 1):
                blk = [ResBlock(ch + chans.pop(), mult * mc, ted)]
                ch = mult * mc
                if ds in self.attn_res:
                    blk += [spatial(ch), temporal(ch)]
                if level and i == nres:
                    blk.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(blk))
        self.out = nn.Sequential(gn(mc, 1e-5), nn.SiLU(),
                                 Conv2d(mc, cfg["unet_out_channels"], 3,
                                        padding=1))

    def _call(self, layer, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            from torch.utils import checkpoint
            return checkpoint.checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def forward(self, x, timesteps, context, fs, cfg_groups: int = 1):
        """x (B, T, H, W, C_in), timesteps and fs (B,), context (B, 77 +
        T * queries, D) -> (B, T, H, W, C_out). ``cfg_groups`` n: the batch
        is n CFG branches of the same x, t and fs, so the layers before the
        first cross-attention run once per clip and are tiled (the same
        values as running them on every row)."""
        b, t, hh, ww, _ = x.shape
        g = cfg_groups
        emb = self.time_embed(timestep_embedding(timesteps, self.mc))
        emb = emb + self.fps_embedding(timestep_embedding(fs, self.mc))
        emb = emb.repeat_interleave(t, 0)
        text = context[:, :self.text_len].repeat_interleave(t, 0)
        img = context[:, self.text_len:].reshape(b * t, self.img_tokens,
                                                 context.shape[-1])
        ctx = torch.cat([text, img], dim=1)
        shared = g > 1
        rows = (b // g) * t

        def widen(h):
            nonlocal shared
            if shared:
                shared = False
                return h.repeat((g,) + (1,) * (h.ndim - 1))
            return h

        def run(blk, h):
            for layer in blk:
                if isinstance(layer, ResBlock):
                    h = self._call(layer, h, emb[:rows] if shared else emb, t)
                elif isinstance(layer, SpatialTransformer):
                    h = self._call(layer, widen(h), ctx)
                elif isinstance(layer, TemporalTransformer):
                    h5 = h.reshape((-1, t) + h.shape[1:])
                    h = self._call(layer, h5).reshape(h.shape)
                else:
                    h = layer(h)
            return h

        h = x.reshape(b * t, hh, ww, -1)
        if shared:
            h = h[:rows]
        hs = []
        h = run(self.init_attn, self.input_blocks[0][0](h))
        hs.append(h.repeat(g, 1, 1, 1) if shared else h)
        for blk in self.input_blocks[1:]:
            h = run(blk, h)
            hs.append(h.repeat(g, 1, 1, 1) if shared else h)
        h = run(self.middle_block, widen(h))
        for blk in self.output_blocks:
            h = run(blk, torch.cat([h, hs.pop()], dim=-1))
        h = self.out[2](silu(group_norm(h, self.out[0])))
        return h.reshape(b, t, hh, ww, -1)


# ---------------------------------------------------------------------------
# VAE: encoder and the dual-reference video decoder ('conv-only' mode)
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = gn(cin, 1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = gn(cout, 1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv1x1(cin, cout)

    def forward(self, x):
        h = self.conv1(silu(group_norm(x, self.norm1)))
        h = self.conv2(silu(group_norm(h, self.norm2)))
        skip = self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x
        return skip + h


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = gn(c, 1e-6)
        self.q, self.k, self.v = Conv1x1(c, c), Conv1x1(c, c), Conv1x1(c, c)
        self.proj_out = Conv1x1(c, c)

    def forward(self, x):
        n, hh, ww, c = x.shape
        h = group_norm(x, self.norm)
        tok = lambda a: a.reshape(n, hh * ww, c)
        out = self.q.ops.attend(tok(self.q(h)), tok(self.k(h)),
                                tok(self.v(h)), 1)
        return x + self.proj_out(out.reshape(n, hh, ww, c))


class DownLevel(nn.Module):
    def __init__(self, cin, cout, nres, down):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(cin if i == 0 else cout, cout)
                                   for i in range(nres))
        if down:
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(cout, cout, 3, stride=2)


class MidBlock(nn.Module):
    def __init__(self, c, block):
        super().__init__()
        self.block_1 = block(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = block(c, c)


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, nres, z_ch):
        super().__init__()
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        mults = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList(
            DownLevel(ch * mults[i], ch * mults[i + 1], nres,
                      i != len(ch_mult) - 1) for i in range(len(ch_mult)))
        c = ch * ch_mult[-1]
        self.mid = MidBlock(c, ResnetBlock)
        self.norm_out = gn(c, 1e-6)
        self.conv_out = Conv2d(c, 2 * z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        feat, taps = h, []
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            taps.append(h)
            if hasattr(level, "downsample"):
                h = level.downsample.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(silu(group_norm(h, self.norm_out))), taps + [feat]


def fold(x):
    return x.reshape((-1,) + x.shape[2:])


class TimeStack(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.in_layers = nn.Sequential(gn(c, 1e-5), nn.SiLU(),
                                       TemporalConv(c))
        self.out_layers = nn.Sequential(gn(c, 1e-5), nn.SiLU(),
                                        nn.Dropout(0.0), TemporalConv(c))

    def forward(self, x):
        h = self.in_layers[2](silu(group_norm(x, self.in_layers[0])))
        return self.out_layers[3](silu(group_norm(h, self.out_layers[0])))


class VideoResBlock(ResnetBlock):
    def __init__(self, cin, cout):
        super().__init__(cin, cout)
        self.time_stack = TimeStack(cout)
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, t = x.shape[:2]
        x = super().forward(fold(x))
        x = x.reshape((b, t) + x.shape[1:])
        return x + torch.sigmoid(self.mix_factor)[0] * self.time_stack(x)


class UpLevel(nn.Module):
    def __init__(self, cin, cout, nres, up):
        super().__init__()
        self.block = nn.ModuleList(VideoResBlock(cin if i == 0 else cout,
                                                 cout)
                                   for i in range(nres + 1))
        if up:
            self.upsample = Upsample(cout)


class FusionCrossAttention(nn.Module):
    def __init__(self, c, heads=8, dim_head=64):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = gn(c, 1e-6)
        self.to_q = Linear(c, inner, bias=False)
        self.to_k = Linear(c, inner, bias=False)
        self.to_v = Linear(c, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, c), nn.Dropout(0.0))

    def forward(self, x, context):
        b, t, hh, ww, c = x.shape
        h = group_norm(fold(x), self.norm).reshape(b, t * hh * ww, c)
        ctx = context.reshape(b, -1, c)
        out = self.to_q.ops.attend(self.to_q(h), self.to_k(ctx),
                                   self.to_v(ctx), self.heads)
        return x + self.to_out(out).reshape(b, t, hh, ww, c)


class Combiner(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv1x1(c, c)

    def forward(self, x, context):
        ctx = self.conv(context)
        return torch.cat([x[:, :1] + ctx[:, :1], x[:, 1:-1],
                          x[:, -1:] + ctx[:, 1:2]], dim=1)


class AE3DConv(Conv2d):
    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, padding=1)
        self.time_mix_conv = TemporalConv(cout)

    def forward(self, x):
        b, t = x.shape[:2]
        y = super().forward(fold(x))
        return self.time_mix_conv(y.reshape((b, t) + y.shape[1:]))


class DualRefDecoder(nn.Module):
    def __init__(self, ch, ch_mult, nres, attn_level, z_ch):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_ch, c, 3, padding=1)
        self.mid = MidBlock(c, VideoResBlock)
        ups, refine = [], []
        for level in reversed(range(len(ch_mult))):
            cout = ch * ch_mult[level]
            ups.append(UpLevel(c, cout, nres, level != 0))
            refine.append(FusionCrossAttention(cout) if level in attn_level
                          else Combiner(cout))
            c = cout
        self.up = nn.ModuleList(reversed(ups))
        self.attn_refinement = nn.ModuleList(list(reversed(refine))
                                             + [Combiner(c)])
        self.norm_out = gn(c, 1e-6)
        self.conv_out = AE3DConv(c, 3)

    def forward(self, z, refs):
        b, t = z.shape[:2]
        h = self.conv_in(fold(z))
        h = h.reshape((b, t) + h.shape[1:])
        h = self.mid.block_1(h)
        h = self.mid.attn_1(fold(h)).reshape(h.shape)
        h = self.mid.block_2(h)
        for level in reversed(range(len(self.up))):
            up = self.up[level]
            for blk in up.block:
                h = blk(h)
            h = self.attn_refinement[level](h, refs[level])
            if hasattr(up, "upsample"):
                f = up.upsample(fold(h))
                h = f.reshape((b, t) + f.shape[1:])
        f = silu(group_norm(fold(h), self.norm_out))
        h = self.attn_refinement[-1](f.reshape(h.shape[:2] + f.shape[1:]),
                                     refs[-1])
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mult = cfg["vae_ch"], tuple(cfg["vae_ch_mult"])
        nres, zc = cfg["vae_num_res_blocks"], cfg["z_channels"]
        self.encoder = Encoder(ch, mult, nres, zc)
        self.decoder = DualRefDecoder(ch, mult, nres,
                                      tuple(cfg["dualref_attn_level"]), zc)
        self.quant_conv = Conv1x1(2 * zc, 2 * zc)
        self.post_quant_conv = Conv1x1(zc, zc)


# ---------------------------------------------------------------------------
# OpenCLIP towers and the resampler
# ---------------------------------------------------------------------------

class MultiheadAttention(nn.Module):
    ops = Ops()

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        q, k, v = self.ops.linear(x, self.in_proj_weight,
                                  self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(self.ops.attend(q, k, v, self.heads, mask))


class Mlp(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = Mlp(width)

    def forward(self, x, mask=None):
        x = x + self.attn(layer_norm(x, self.ln_1), mask)
        return x + self.mlp(layer_norm(x, self.ln_2))


class Transformer(nn.Module):
    def __init__(self, width, heads, layers):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class TextTower(nn.Module):
    """The penultimate layer's tokens: one block fewer, then ln_final."""

    def __init__(self, width, heads, layers):
        super().__init__()
        self.token_embedding = nn.Embedding(49408, width)
        self.positional_embedding = nn.Parameter(torch.zeros(77, width))
        self.transformer = Transformer(width, heads, layers - 1)
        self.ln_final = nn.LayerNorm(width)

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding
        s = tokens.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        return layer_norm(self.transformer(x, mask), self.ln_final)


class VisionTower(nn.Module):
    def __init__(self, width, heads, layers, image_size, patch=14):
        super().__init__()
        self.patch = patch
        n_tok = (image_size // patch) ** 2 + 1
        self.conv1 = Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tok, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, heads, layers)

    def forward(self, images):
        b = images.shape[0]
        x = self.conv1(images).reshape(b, -1, self.class_embedding.shape[0])
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1)
        x = x + self.positional_embedding
        return self.transformer(layer_norm(x, self.ln_pre))


def _cubic(x, a):
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
                    np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2
                             + 8 * a * ax - 4 * a, 0.0))


def antialias_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of torch's antialiased bicubic resize with
    align_corners (the PIL-derived kernel, a = -0.5, renormalised)."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else n_in / n_out
    ss = max(scale, 1.0)
    mat = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = scale * (i + 0.5)
        lo = max(int(center - 2 * ss + 0.5), 0)
        hi = min(int(center + 2 * ss + 0.5), n_in)
        idx = np.arange(lo, hi)
        w = _cubic((idx - center + 0.5) / ss, -0.5)
        mat[i, lo:hi] = w / w.sum()
    return mat


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(frames, size: int):
    """(B, H, W, 3) in [-1, 1] -> (B, size, size, 3) CLIP-normalised."""
    h, w = frames.shape[1:3]
    dev = frames.device
    mh = torch.as_tensor(antialias_bicubic_matrix(h, size), device=dev,
                         dtype=torch.float32)
    mw = torch.as_tensor(antialias_bicubic_matrix(w, size), device=dev,
                         dtype=torch.float32)
    x = torch.einsum("oh,bhwc->bowc", mh, frames.float())
    x = torch.einsum("pw,bowc->bopc", mw, x)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head, heads):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, inner * 2, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x = layer_norm(x, self.norm1)
        latents = layer_norm(latents, self.norm2)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        return self.to_out(self.to_q.ops.attend(self.to_q(latents), k, v,
                                                self.heads))


class LNLinears(nn.Sequential):
    """The resampler's feed-forward: LayerNorm, Linear, GELU, Linear."""

    def forward(self, x):
        x = layer_norm(x, self[0])
        return self[3](F.gelu(self[1](x)))


class Resampler(nn.Module):
    def __init__(self, dim, depth, heads, queries, emb_dim, out_dim,
                 video_length, dim_head=64, ff_mult=4):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, queries * video_length,
                                                dim))
        self.proj_in = Linear(emb_dim, dim)
        self.proj_out = Linear(dim, out_dim)
        self.norm_out = nn.LayerNorm(out_dim)
        self.layers = nn.ModuleList(nn.ModuleList([
            PerceiverAttention(dim, dim_head, heads),
            LNLinears(nn.LayerNorm(dim),
                      Linear(dim, dim * ff_mult, bias=False), nn.GELU(),
                      Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth))

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return layer_norm(self.proj_out(latents), self.norm_out)


class Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class ToonCrafterRef(nn.Module):
    """The whole model under the upstream state-dict prefixes."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.model = Holder(diffusion_model=UNet(cfg))
        self.first_stage_model = AutoencoderKL(cfg)
        self.cond_stage_model = Holder(model=TextTower(
            cfg["clip_text_width"], cfg["clip_text_heads"],
            cfg["clip_text_layers"]))
        self.embedder = Holder(model=Holder(visual=VisionTower(
            cfg["clip_vision_width"], cfg["clip_vision_heads"],
            cfg["clip_vision_layers"], cfg["clip_image_size"])))
        self.image_proj_model = Resampler(
            cfg["context_dim"], cfg["resampler_depth"],
            cfg["resampler_heads"], cfg["resampler_queries"],
            cfg["clip_vision_width"], cfg["context_dim"],
            cfg["video_length"])
        set_ops(self, Ops())

    @property
    def unet(self) -> UNet:
        return self.model.diffusion_model

    # ---- the stages ----

    def encode(self, video, noise):
        """video (B, T, H, W, 3) in [-1, 1], noise (B, T, h, w, z) ->
        (scaled latents z, refs: per tap the first and last frame's
        features), one frame at a time."""
        b, t = video.shape[:2]
        vae = self.first_stage_model
        moments, taps = [], None
        for i in range(b * t):
            h, tp = vae.encoder(fold(video)[i:i + 1].float())
            moments.append(vae.quant_conv(h))
            if i % t in (0, t - 1):
                taps = [[] for _ in tp] if taps is None else taps
                for lst, x in zip(taps, tp):
                    lst.append(x)
        m = torch.cat(moments)
        mean, logvar = m.chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        z = (mean + std * noise.reshape(mean.shape)).reshape(
            (b, t) + mean.shape[1:]) * self.cfg["scale_factor"]
        refs = [torch.cat(lst).reshape((b, 2) + lst[0].shape[1:])
                for lst in taps]
        return z, refs

    def text(self, tokens):
        return self.cond_stage_model.model(tokens)

    def image_context(self, frame):
        x = clip_preprocess(frame, self.cfg["clip_image_size"])
        return self.image_proj_model(self.embedder.model.visual(x))

    def conditioning(self, tokens, null_tokens, frame0):
        """[uncond, cond] stacked: (2, B, 77 + T * queries, D)."""
        text, uc_text = self.text(tokens), self.text(null_tokens)
        img = self.image_context(frame0)
        uc_img = self.image_context(torch.zeros_like(frame0))
        return torch.stack([torch.cat([uc_text, uc_img], 1),
                            torch.cat([text, img], 1)])

    def decode(self, z, refs):
        return self.first_stage_model.decoder(
            z / self.cfg["scale_factor"], refs)

    def decode_spliced(self, z, refs):
        """The full decode with its two centre frames from a decode of the
        latents without frames 1 and T - 2."""
        full = self.decode(z, refs)
        t = z.shape[1]
        keep = [i for i in range(t) if i not in (1, t - 2)]
        part = self.decode(z[:, keep], refs)
        mid = full.shape[1] // 2
        full[:, mid - 1:mid + 1] = part[:, mid - 2:mid]
        return full


def interp_concat(z):
    """The interpolation condition: the first and last latent frames, zeros
    between."""
    return torch.cat([z[:, :1], torch.zeros_like(z[:, 1:-1]), z[:, -1:]],
                     dim=1)
