"""Spatio-temporal UNet denoiser (tooncrafter_tpu/models/unet.py).

Per level: ResBlock (+ TemporalConvBlock) -> SpatialTransformer ->
TemporalTransformer; an init temporal attention after the input conv; fps
conditioning added to the time embedding; cross-attention context of 77
text tokens + 16 image tokens per frame, routed per frame.

Video tensors are (B, T, H, W, C); spatial modules run on (B*T, H, W, C).
Module and parameter names follow the upstream ``openaimodel3d`` state dict
(``input_blocks.1.0.in_layers.0.weight`` ...).

Inference (eval mode, or dropout 0: where the JAX package's ``fused`` flag
is true) takes the fused branch: spatial self-attention through the packed
flash kernels; ``ff(norm3(x)) + x`` as one fused GEGLU feed-forward; each
GroupNorm + SiLU folded into a per-sample affine (A, B) that the next
conv (the GN+SiLU+3x3 conv, the (3,1,1) temporal conv) applies as it
reads its input, each conv emitting the per-channel sums that feed the
next norm, and the ResBlock's time embedding folded into that affine; the
two temporal self-attention sub-blocks of a temporal transformer block as
one call of the temporal attention pair. The unfused branch keeps dropout
where upstream has it and takes the kernels where the JAX package's
training branch does: each ResBlock conv by its ``_impl`` dispatch
(``spatial_conv3x3``: #13, #14, #15 on their tables and rule, else
``F.conv2d``), each temporal conv through the temporal conv kernel (at
every shape, as in inference), both under autograd through their
Functions.

In the fused branch per-channel sums (s1, s2) also travel across blocks, as
the JAX package chains them (tooncrafter_tpu/models/unet.py:844-970): each
ResBlock returns the per-frame sums of its output (from its TemporalConvBlock's
last conv), each transformer the sums of its output, the skip stack keeps
(h, sums) and a channel concat concatenates them, a Downsample or Upsample
resets them, and the next norm folds them instead of reading its input.
``cfg_groups`` runs the stem on one CFG branch's rows and tiles it back
(unet.py:777-807). ``use_relative_position`` adds learned relative-position
tables to the temporal attentions, which then take the plain route (the JAX
package's XLA layout).

The temporal blocks take their kernel by the JAX package's coverage rules
(tooncrafter_tpu/models/unet.py:547-567, 688-700): the pair where
``use_pair_kernel`` holds (and, under the default TC_TATTN_PAIR=1, also
where the JAX package runs its XLA chain: the same function, or the plain
chain where the pair's CUDA kernel takes no such shape, ``ta.covers``); under
TC_TATTN_PAIR=0 each sub-block through the single-stage kernel (#10) where
``use_fused_kernel`` holds, else the T-attention core (#11) where
``use_kernel`` does, else the plain chain. A GroupNorm that the JAX package
applies without producer sums (every norm of the training branch, the init
attention's) goes through ``fused_norms.group_norm_silu``: the one-pass
kernel (#16) under TOONCRAFTER_FUSED_GN=1.

Under tensor parallelism (``parallel/tensor.py``: ``shard_`` gives each
transformer block, its attentions and its feed-forward the attribute ``tp``)
a block holds its rank's heads and its share of the feed-forward width:
each sub-block reads its input through ``copy_to_model`` and sums its
partial output over the model group before its out bias and residual; the
fused feed-forward and the temporal single stage take their kernels'
partial mode, attn1 the flash kernels at the local heads (named by the
whole call's route), and a temporal block whose route is the pair takes
the single stage instead (the pair's stage 2 reads stage 1's whole
output).

Training with ``use_checkpoint`` recomputes each ResBlock, SpatialTransformer
and TemporalTransformer in the backward (the JAX package's ``rematted``,
tooncrafter_tpu/models/unet.py:851-866): ``remat_policy`` None saves
nothing inside a block, 'dots' keeps the matrix products' outputs (mm,
addmm, bmm) and 'dots_no_batch' those without a batch dimension (mm,
addmm). Dropout replays the same mask in the recomputation (the RNG state is
stashed). Only while grad is enabled; inference runs the blocks as before.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops.fused_ff import finish, fused_geglu_ff
from tooncrafter_tpu_torch.parallel import tensor as TP
from tooncrafter_tpu_torch.ops.attention import (attention,
                                                 temporal_attention_inplace)
from tooncrafter_tpu_torch.ops.norms import (GroupNorm, LayerNorm,
                                             concat_sums, layer_norm_ex2,
                                             output_sums, sums_over_frames)
from tooncrafter_tpu_torch.ops.schedule import timestep_embedding
from tooncrafter_tpu_torch.ops.spatial_conv import (Conv1d1, Conv1x1, Conv2d,
                                                    Downsample, Upsample,
                                                    gn_silu_conv3x3,
                                                    spatial_conv3x3)
from tooncrafter_tpu_torch.ops.temporal_conv import TemporalConv3


class TemporalConvBlock(nn.Module):
    """4x (GN+SiLU+Conv3d(3,1,1)) residual stack over (B, T, H, W, C);
    ``conv1`` is [GN, SiLU, conv], ``conv2..4`` are [GN, SiLU, Dropout,
    conv] as in the upstream Sequential."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(GroupNorm(c, 1e-5, act=True), nn.SiLU(),
                                   TemporalConv3(c, c))
        for i in (2, 3, 4):
            setattr(self, f"conv{i}", nn.Sequential(
                GroupNorm(c, 1e-5, act=True), nn.SiLU(), nn.Dropout(0.1),
                TemporalConv3(c, c)))

    def forward(self, x, stats=None, return_stats: bool = False):
        """x: (B, T, H, W, C); ``stats`` (s1, s2), each (B, C): sums of x
        over (T, H, W) from the producer, for conv1's norm. With
        ``return_stats`` also the per-frame sums of the output, each (B, T,
        C), from conv4's epilogue (None on the training branch)."""
        if self.training and self.conv2[2].p > 0:
            # each conv through the kernel without a prologue (the JAX
            # package's TemporalConv3 with no prologue); dropout between the
            # norm and the conv; the block's residual added after conv4
            h = x
            for i in (1, 2, 3, 4):
                seq = getattr(self, f"conv{i}")
                h = seq[0](h)
                if i > 1:
                    h = seq[2](h)
                h = seq[-1].fused(h, None)
            return (x + h, None) if return_stats else x + h
        # each conv's stats epilogue feeds the next norm; the closing
        # residual (and the sums of the block's output) ride conv4's
        h = x
        for i in (1, 2, 3):
            seq = getattr(self, f"conv{i}")
            h, s1, s2 = seq[-1].fused(h, seq[0].folded(h, stats=stats),
                                      return_stats=True)
            stats = (s1.sum(1), s2.sum(1))  # per-frame -> over (T, H, W)
        out = self.conv4[-1].fused(h, self.conv4[0].folded(h, stats=stats),
                                   residual=x, return_stats=return_stats)
        return (out[0], out[1:]) if return_stats else out


class ResBlock(nn.Module):
    """GN+SiLU+conv x2 with the time-embedding add and a temporal conv
    block; spatial part on (B*T, H, W, C)."""

    def __init__(self, cin: int, cout: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(cin, 1e-5, act=True),
                                       nn.SiLU(),
                                       Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(GroupNorm(cout, 1e-5, act=True),
                                        nn.SiLU(), nn.Dropout(0.1),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = (Conv1x1(cin, cout) if cin != cout
                                else nn.Identity())
        self.temopral_conv = TemporalConvBlock(cout)  # upstream spelling

    @property
    def unfused(self) -> bool:
        """The training branch (dropout on): the JAX package's ``fused``
        (and its UNet's stats ``chain``) is false."""
        return self.training and self.out_layers[2].p > 0

    def forward(self, x, emb, num_frames: int, stats=None,
                return_stats: bool = False):
        """x: (B*T, H, W, C); ``stats``: the producer's per-frame sums of x,
        each (B*T, C), for in_norm. With ``return_stats`` also the
        per-frame sums of the output (None on the training branch)."""
        e = self.emb_layers[1](F.silu(emb))
        skip = self.skip_connection(x)
        if self.unfused:
            # each conv through the JAX package's dispatch with no prologue
            # (an identity affine, no SiLU): a kernel where it takes one
            h = spatial_conv3x3(self.in_layers[0](x), None, self.in_layers[2],
                                silu=False)
            h = self.out_layers[2](self.out_layers[0](h, shift=e))
            h = skip + spatial_conv3x3(h, None, self.out_layers[3],
                                       silu=False)
            h5 = h.reshape((-1, num_frames) + h.shape[1:])
            h = self.temopral_conv(h5).reshape(h.shape)
            return (h, None) if return_stats else h
        # in_conv's sums feed out_norm, whose affine folds the time
        # embedding; out_conv adds the skip and its sums, over (T, H, W),
        # seed the temporal block's first norm
        in_norm, out_norm = self.in_layers[0], self.out_layers[0]
        h, s1, s2 = gn_silu_conv3x3(x, in_norm.folded(x, stats=stats),
                                    self.in_layers[2], return_stats=True)
        aff = out_norm.folded(h, shift=e, stats=(s1, s2))
        h, s1, s2 = gn_silu_conv3x3(h, aff, self.out_layers[3], residual=skip,
                                    return_stats=True)
        b = h.shape[0] // num_frames
        tstats = (s1.reshape(b, num_frames, -1).sum(1),
                  s2.reshape(b, num_frames, -1).sum(1))
        h5 = h.reshape((b, num_frames) + h.shape[1:])
        out = self.temopral_conv(h5, stats=tstats, return_stats=return_stats)
        if not return_stats:
            return out.reshape(h.shape)
        # per-frame (B, T, C) -> (B*T, C): the next spatial norm spans (H, W)
        return out[0].reshape(h.shape), tuple(s.reshape(h.shape[0], -1)
                                              for s in out[1])


class RelativePosition(nn.Module):
    """A learned (2L + 1, d) table of relative-position embeddings, read at
    clip(k - q, -L, L) + L for each (query, key) frame pair (upstream
    ``attention.RelativePosition``)."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(torch.empty(
            2 * max_relative_position + 1, num_units))
        nn.init.xavier_uniform_(self.embeddings_table)

    def forward(self, length_q: int, length_k: int):
        """(length_q, length_k, d): the embedding of each pair's offset."""
        dev = self.embeddings_table.device
        lim = self.max_relative_position
        dist = (torch.arange(length_k, device=dev)[None, :]
                - torch.arange(length_q, device=dev)[:, None])
        return self.embeddings_table[dist.clamp(-lim, lim) + lim]


class CrossAttention(nn.Module):
    """Multi-head attention; as self-attention on (B, S, C) it runs the
    packed flash path, on (B, T, H, W, C) it attends over T (with learned
    relative-position tables when ``relative_position``), and with a
    context and ``image_branch`` it adds the image-token attention, scaled
    by tanh(alpha)+1 when that scale is learnable. Under tensor parallelism
    (``tp``) ``heads`` is this rank's share and ``to_out`` row-parallel."""

    tp = None  # a parallel.tensor.Shard, set by parallel.tensor.shard_

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None,
                 image_branch: bool = False,
                 ip_scale_learnable: bool = False, text_len: int = 77,
                 relative_position: bool = False,
                 temporal_length: int = 16):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.image_branch = image_branch
        self.text_len = text_len
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim),
                                    nn.Dropout(0.0))
        if relative_position:
            self.relative_position_k = RelativePosition(dim_head,
                                                        temporal_length)
            self.relative_position_v = RelativePosition(dim_head,
                                                        temporal_length)
        if image_branch:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)
            if ip_scale_learnable:
                self.alpha = nn.Parameter(torch.zeros(()))

    def out(self, o):
        """to_out; under tensor parallelism its row-parallel form (this
        rank's heads' columns, the sum over the model group, the bias once)."""
        if self.tp is None:
            return self.to_out(o)
        return self.to_out[1](TP.row_parallel(o, self.to_out[0],
                                              self.tp.group))

    def forward(self, x, context=None, mask=None):
        if self.tp is not None and context is not None:
            context = TP.copy_to_model(context, self.tp.group)
        if context is None and x.ndim == 3 and mask is None:
            s, inner = x.shape[1], self.heads * self.dim_head
            whole = (inner if self.tp is None
                     else self.tp.heads * self.dim_head)
            if fa.use_packed_kernel(s, whole, whole // self.dim_head):
                w = torch.cat([self.to_q.weight, self.to_k.weight,
                               self.to_v.weight])
                out = fa.flash_attention_packed(F.linear(x, w), self.heads,
                                                whole_c=whole)
            else:
                out = attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                heads=self.heads)
            return self.out(out)
        if x.ndim == 5:
            assert context is None
            rel_k = rel_v = None
            if hasattr(self, "relative_position_k"):
                t = x.shape[1]
                rel_k = self.relative_position_k(t, t).to(x.dtype)
                rel_v = self.relative_position_v(t, t).to(x.dtype)
            out = temporal_attention_inplace(
                self.to_q(x), self.to_k(x), self.to_v(x), heads=self.heads,
                mask=mask, rel_k=rel_k, rel_v=rel_v)
            return self.out(out)
        q = self.to_q(x)
        if self.image_branch and context is not None:
            ctx_text = context[:, :self.text_len]
            ctx_img = context[:, self.text_len:]
            out = attention(q, self.to_k(ctx_text), self.to_v(ctx_text),
                            heads=self.heads, mask=mask)
            out_ip = attention(q, self.to_k_ip(ctx_img),
                               self.to_v_ip(ctx_img), heads=self.heads)
            if hasattr(self, "alpha"):
                out_ip = out_ip * (torch.tanh(self.alpha) + 1.0)
            out = out + out_ip
        else:
            ctx = x if context is None else context[:, :self.text_len]
            out = attention(q, self.to_k(ctx), self.to_v(ctx),
                            heads=self.heads, mask=mask)
        return self.out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward, ``net`` = [GEGLU, Dropout, Linear]; under tensor
    parallelism (``tp``) a rank's share of the hidden width, ``net[2]``
    row-parallel."""

    tp = None  # a parallel.tensor.Shard, set by parallel.tensor.shard_

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        h = self.net[1](self.net[0](x))
        if self.tp is None:
            return self.net[2](h)
        return TP.row_parallel(h, self.net[2], self.tp.group)

    def fused(self, x, norm: nn.LayerNorm):
        """ff(norm(x)) + x in one call of the fused feed-forward (the
        LayerNorm prologue, the residual in the epilogue); under tensor
        parallelism its partial call on this rank's share of D, the fp32
        accumulators summed over the model group, then the bias and the
        residual (``fused_ff.finish``)."""
        proj, out = self.net[0].proj, self.net[2]
        if self.tp is None:
            return fused_geglu_ff(x, proj.weight, proj.bias, out.weight,
                                  out.bias, norm.weight, norm.bias, norm.eps,
                                  residual=True)
        g = self.tp.group
        part = fused_geglu_ff(TP.copy_to_model(x, g), proj.weight, proj.bias,
                              out.weight, None, norm.weight, norm.bias,
                              norm.eps, partial=True, name_d=self.tp.d_ff)
        return finish(TP.reduce_from_model(part, g), out.bias, x)


class BasicTransformerBlock(nn.Module):
    tp = None  # a parallel.tensor.Shard, set by parallel.tensor.shard_

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int], image_branch: bool = False,
                 ip_scale_learnable: bool = False, cross: bool = True,
                 relative_position: bool = False, temporal_length: int = 16):
        super().__init__()
        self.cross = cross
        rel = dict(relative_position=relative_position,
                   temporal_length=temporal_length)
        self.attn1 = CrossAttention(dim, heads, dim_head, **rel)
        self.attn2 = CrossAttention(
            dim, heads, dim_head, context_dim if cross else None,
            image_branch=image_branch, ip_scale_learnable=ip_scale_learnable,
            **rel)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, mask=None, route: str = "pair"):
        """``route`` picks a 5-D (temporal) block's kernels: 'pair', 'single'
        (#10 for each sub-block), 'ptc' (the LayerNorm, projections and
        out-projection plain around #11) or 'plain'."""
        fused = not (self.training and self.ff.net[1].p > 0)
        if fused and x.ndim == 5 and mask is None and route != "plain":
            x = {"pair": self.temporal_pair, "single": self.temporal_single,
                 "ptc": self.temporal_ptc}[route](x)
        else:
            x = self.attn1(self.norm1(self._in(x)), None, mask) + x
            x = self.attn2(self.norm2(self._in(x)),
                           context if self.cross else None, mask) + x
        if not fused:
            return self.ff(self.norm3(self._in(x))) + x
        return self.ff.fused(x, self.norm3)

    def _in(self, x):
        """A sub-block's input: under tensor parallelism through
        ``copy_to_model`` (its gradient summed over the model group)."""
        return x if self.tp is None else TP.copy_to_model(x, self.tp.group)

    def temporal_pair(self, x):
        """Both sub-blocks of a temporal block, x + attn1(norm1(x)), then
        the same with attn2 and norm2, as one call of the temporal attention
        pair; x: (B, T, H, W, C)."""
        stages = [(norm.weight, norm.bias, attn.to_q.weight, attn.to_k.weight,
                   attn.to_v.weight, attn.to_out[0].weight,
                   attn.to_out[0].bias)
                  for norm, attn in ((self.norm1, self.attn1),
                                     (self.norm2, self.attn2))]
        y = ta._fused_tpair_call(x.reshape(x.shape[:2] + (-1, x.shape[-1])),
                                 *stages, self.attn1.heads,
                                 self.attn1.dim_head ** -0.5, self.norm1.eps)
        return y.reshape(x.shape)

    def temporal_single(self, x):
        """The two sub-blocks as two calls of the single-stage kernel (the
        JAX package's ``ln=`` path under TC_TATTN_PAIR=0; under tensor
        parallelism each a partial call on this rank's heads, summed over
        the model group and finished with the bias and the residual)."""
        y = x.reshape(x.shape[:2] + (-1, x.shape[-1]))
        for norm, attn in ((self.norm1, self.attn1), (self.norm2, self.attn2)):
            stage = (norm.weight, norm.bias, attn.to_q.weight,
                     attn.to_k.weight, attn.to_v.weight,
                     attn.to_out[0].weight, attn.to_out[0].bias)
            args = (attn.heads, attn.dim_head ** -0.5, norm.eps)
            if self.tp is None:
                y = ta._fused_tattn_call(y, stage, *args)
                continue
            part = ta._fused_tattn_call(self._in(y), stage, *args,
                                        partial=True)
            y = finish(TP.reduce_from_model(part, self.tp.group),
                       attn.to_out[0].bias, y)
        return y.reshape(x.shape)

    def temporal_ptc(self, x):
        """The ``ln=`` path's fallback: the LayerNorm (E[x^2] - mean^2, as
        the JAX package's ``norms.layer_norm``), one packed q | k | v
        projection whose slices the T-attention core reads at their
        strides, the out-projection and the residual."""
        y = x.reshape(x.shape[:2] + (-1, x.shape[-1]))
        for norm, attn in ((self.norm1, self.attn1), (self.norm2, self.attn2)):
            w = torch.cat([attn.to_q.weight, attn.to_k.weight,
                           attn.to_v.weight])
            z = layer_norm_ex2(self._in(y), norm.weight, norm.bias, norm.eps,
                               y.dtype)
            q, k, v = F.linear(z, w).chunk(3, dim=-1)
            o = ta.temporal_attention_ptc(q, k, v, heads=attn.heads,
                                          scale=attn.dim_head ** -0.5)
            y = y + attn.out(o)
        return y.reshape(x.shape)


class SpatialTransformer(nn.Module):
    """Attention over the h*w tokens of each frame, linear projections."""

    def __init__(self, c: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, ip_scale_learnable: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(c, 1e-6)
        self.proj_in = nn.Linear(c, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim,
                                  image_branch=True,
                                  ip_scale_learnable=ip_scale_learnable)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, c)

    def forward(self, x, context, stats=None, return_stats: bool = False):
        """x: (B*T, H, W, C); ``stats``: the producer's per-frame sums of x,
        each (B*T, C), for the norm. With ``return_stats`` also the sums of
        the output over (H, W), taken once, as the JAX package takes them
        (unet.py:646-653)."""
        bt, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x, stats=stats).reshape(bt, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        out = x + self.proj_out(h).reshape(bt, hh, ww, c)
        return (out, output_sums(out, (1, 2))) if return_stats else out


class TemporalTransformer(nn.Module):
    """Self-attention over T per pixel on (B, T, H, W, C); ``linear``
    False gives the init attention's kernel-size-1 Conv1d projections."""

    def __init__(self, c: int, heads: int, dim_head: int, depth: int,
                 causal: bool = False, linear: bool = True,
                 relative_position: bool = False, temporal_length: int = 16):
        super().__init__()
        inner = heads * dim_head
        self.causal = causal
        self.relative_position = relative_position
        self.norm = GroupNorm(c, 1e-6)
        proj = nn.Linear if linear else Conv1d1
        self.proj_in = proj(c, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, None, cross=False,
                                  relative_position=relative_position,
                                  temporal_length=temporal_length)
            for _ in range(depth))
        self.proj_out = proj(inner, c)

    def route(self, t: int, p: int) -> str:
        """The kernels of this transformer's blocks at T frames of P
        pixels, by the JAX package's rules (see the module docstring)."""
        if self.relative_position:
            # the JAX package's 5-D XLA layout (unet.py:537, 691)
            return "plain"
        blk = self.transformer_blocks[0]
        d = blk.attn1.dim_head
        inner = (blk.attn1.heads if blk.tp is None else blk.tp.heads) * d
        fused_ok = ta.use_fused_kernel(t, p, d, inner, inner)
        fast = not self.causal and (
            ta.use_kernel(t, p, d, inner=inner) or fused_ok)
        # under tensor parallelism the pair's two stages run as two single
        # stages, each reduced over the model group before the next reads it
        pair = "pair" if blk.tp is None else "single"
        if ta.use_pair_kernel(t, p, d, inner, inner):
            # the JAX package's Pallas pair kernel: the CUDA pair, which
            # raises on the card at a shape it does not take
            return pair
        if ta._PAIR and not fast:
            # the JAX package's XLA chain: the same function through the
            # CUDA pair where it takes the shape, else the plain chain
            # (heads other than 64 wide, T not dividing 16, C > 1280)
            return pair if ta.covers(t, d, inner) else "plain"
        if fast:
            return "single" if fused_ok else "ptc"
        return "plain"

    def forward(self, x, stats=None, return_stats: bool = False):
        """x: (B, T, H, W, C); ``stats``: the producer's sums of x over (T,
        H, W), each (B, C), for the norm. With ``return_stats`` also the
        per-frame sums of the output, each (B, T, C) (unet.py:715-720)."""
        t = x.shape[1]
        mask = None
        if self.causal:
            mask = torch.ones(t, t, dtype=torch.bool,
                              device=x.device).tril()
        route = self.route(t, x.shape[2] * x.shape[3])
        h = self.proj_in(self.norm(x, stats=stats))
        for blk in self.transformer_blocks:
            h = blk(h, None, mask, route)
        out = x + self.proj_out(h)
        return (out, output_sums(out, (2, 3))) if return_stats else out


# remat_policy -> the aten products whose outputs a checkpointed block keeps
REMAT_POLICIES = {None: None, "dots": ("mm", "addmm", "bmm"),
                  "dots_no_batch": ("mm", "addmm")}


def checkpoint_context(policy):
    """context_fn for torch.utils.checkpoint under ``policy`` (None: the
    default, which saves nothing inside the block)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={policy!r}; expected one of "
                         f"{sorted(REMAT_POLICIES, key=str)}")
    names = REMAT_POLICIES[policy]
    if names is None:
        return None
    ops = [getattr(torch.ops.aten, n).default for n in names]
    return functools.partial(ckpt.create_selective_checkpoint_contexts, ops)


class UNetModel(nn.Module):
    def __init__(self, in_channels: int = 8, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: int = 1024, temporal_length: int = 16,
                 fs_condition: bool = True, default_fs: int = 24,
                 text_len: int = 77, img_tokens_per_frame: int = 16,
                 image_cross_attention_scale_learnable: bool = False,
                 use_causal_attention: bool = False,
                 use_relative_position: bool = False,
                 use_checkpoint: bool = False, remat_policy=None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self._context_fn = (checkpoint_context(remat_policy)
                            if use_checkpoint else None)
        mc = model_channels
        ted = mc * 4
        self.model_channels = mc
        self.out_channels = out_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.fs_condition = fs_condition
        self.default_fs = default_fs
        self.text_len = text_len
        self.img_tokens = img_tokens_per_frame
        nhc = num_head_channels

        def spatial(ch):
            return SpatialTransformer(
                ch, ch // nhc, nhc, transformer_depth, context_dim,
                image_cross_attention_scale_learnable)

        rel = dict(causal=use_causal_attention,
                   relative_position=use_relative_position,
                   temporal_length=temporal_length)

        def temporal(ch):
            return TemporalTransformer(ch, ch // nhc, nhc, transformer_depth,
                                       **rel)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        if fs_condition:
            self.fps_embedding = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(),
                                               nn.Linear(ted, ted))
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])])
        self.init_attn = nn.ModuleList([TemporalTransformer(
            mc, 8, nhc, transformer_depth, linear=False, **rel)])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = [ResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in self.attention_resolutions:
                    blk += [spatial(ch), temporal(ch)]
                self.input_blocks.append(nn.ModuleList(blk))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList(
                    [Downsample(ch, asymmetric=False, name="op")]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted), spatial(ch), temporal(ch),
            ResBlock(ch, ch, ted)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                blk = [ResBlock(ch + chans.pop(), mult * mc, ted)]
                ch = mult * mc
                if ds in self.attention_resolutions:
                    blk += [spatial(ch), temporal(ch)]
                if level and i == num_res_blocks:
                    blk.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(blk))
        self.out = nn.Sequential(GroupNorm(mc, 1e-5, act=True), nn.SiLU(),
                                 Conv2d(mc, out_channels, 3, padding=1))

    def _block(self, layer, *args):
        """One ResBlock or transformer, recomputed in the backward when
        checkpointing is on and grad is enabled."""
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return layer(*args)
        kw = {} if self._context_fn is None else {
            "context_fn": self._context_fn}
        return ckpt.checkpoint(layer, *args, use_reentrant=False, **kw)

    def forward(self, x, timesteps, context, fs=None, cfg_groups: int = 1):
        """x: (B, T, H, W, C_in); timesteps, fs: (B,); context:
        (B, text_len + T*img_tokens, context_dim) -> (B, T, H, W, C_out)
        fp32.

        ``cfg_groups`` n declares the batch to be n CFG branches stacked over
        B/n clips with the same x, timesteps and fs (only the context
        differs, as the DDIM sampler batches them): the stem before the
        first cross-attending SpatialTransformer (the input conv, the init
        attention, the blocks before it) then runs on B/n rows and is tiled
        back to B, as the JAX package does (unet.py:777-807)."""
        b, t, hh, ww, _ = x.shape
        g = cfg_groups
        if b % g:
            raise ValueError(f"cfg_groups={g} does not divide the batch {b}")
        bs = b // g  # the stem's clips
        dt = self.input_blocks[0][0].weight.dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.model_channels).to(dt))
        if self.fs_condition:
            if fs is None:
                fs = torch.full((b,), float(self.default_fs),
                                device=x.device)
            emb = emb + self.fps_embedding(
                timestep_embedding(fs, self.model_channels).to(dt))
        emb = emb.repeat_interleave(t, dim=0)

        # text tokens broadcast per frame, image tokens routed per frame
        if context.shape[1] == self.text_len + t * self.img_tokens:
            ctx_text = context[:, :self.text_len].repeat_interleave(t, 0)
            ctx_img = context[:, self.text_len:].reshape(
                b * t, self.img_tokens, context.shape[-1])
            ctx = torch.cat([ctx_text, ctx_img], dim=1)
        else:
            ctx = context.repeat_interleave(t, dim=0)
        ctx = ctx.to(dt)

        # the JAX package's stats chain: per-frame sums (s1, s2) travel with
        # h from block to block, on unless the ResBlocks train with dropout;
        # a Downsample or Upsample resets them
        chain = not self.middle_block[0].unfused
        shared = g > 1

        def widen(h, st):
            """Tile the stem's rows (and their sums) back to the batch."""
            nonlocal shared
            if shared:
                h = h.repeat((g,) + (1,) * (h.ndim - 1))
                st = None if st is None else tuple(s.repeat(g, 1) for s in st)
                shared = False
            return h, st

        def push(h, st):
            """A skip-stack entry, (h, sums), stem-tiled to the batch."""
            if shared:
                h = h.repeat(g, 1, 1, 1)
                st = None if st is None else tuple(s.repeat(g, 1) for s in st)
            hs.append((h, st))

        def run(blk, h, st):
            for layer in blk:
                if isinstance(layer, ResBlock):
                    e = emb[:bs * t] if shared else emb
                    out = self._block(layer, h, e, t, st, chain)
                elif isinstance(layer, SpatialTransformer):
                    h, st = widen(h, st)
                    out = self._block(layer, h, ctx, st, chain)
                elif isinstance(layer, TemporalTransformer):
                    nb = h.shape[0] // t
                    st5 = None if st is None else sums_over_frames(st, nb, t)
                    out = self._block(layer, h.reshape((nb, t) + h.shape[1:]),
                                      st5, chain)
                    if chain:
                        out = (out[0].reshape(h.shape),
                               tuple(s.reshape(nb * t, -1) for s in out[1]))
                    else:
                        out = out.reshape(h.shape)
                else:  # Downsample, Upsample
                    out = (layer(h), None)
                h, st = out if isinstance(out, tuple) else (out, None)
            return h, st

        h = x.reshape(b * t, hh, ww, x.shape[-1]).to(dt)
        if shared:
            h = h[:bs * t]  # branch 0's clips: every branch's rows are equal
        hs = []
        h, st = run(self.init_attn, self.input_blocks[0][0](h), None)
        push(h, st)
        for blk in self.input_blocks[1:]:
            h, st = run(blk, h, st)
            push(h, st)
        h, st = widen(h, st)  # a no-op unless no level has attention
        h, st = run(self.middle_block, h, st)
        for blk in self.output_blocks:
            skip, skip_st = hs.pop()
            h, st = run(blk, torch.cat([h, skip], dim=-1),
                        concat_sums(st, skip_st))
        h = self.out[2](self.out[0](h, stats=st))
        return h.reshape(b, t, hh, ww, self.out_channels).float()
