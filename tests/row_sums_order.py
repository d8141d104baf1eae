"""The sums of the one-pass GroupNorm (#16, ``csrc/group_norm_silu.cu``)
and of the channel sums (#18, ``csrc/channel_sums.cu``) taken in torch in
the kernels' own order, from their plans (``fused_norms.plan``,
``stats.plan``; ``csrc/row_sums.cuh``):

- a block's thread (column, row offset ro) adds its rows ro, ro + rstep,
  ... of the block's slice in order; the block adds the row offsets'
  sums per channel in the order 0 .. rstep - 1;
- #16: each rank of a sample's cluster adds its channel sums per group, in
  channel order; every rank adds the k ranks' group partials in rank order;
  then the kernel's (A, B) and y;
- #18: the last block of a sample adds the chunks' partials per channel
  in chunk order.

Each step is an fp32 elementwise add in a fixed order, so #18's sums here
are the kernel's bit for bit (its squares are rounded to fp32 before the
add); #16's output is not (the card contracts the affine into fused
multiply-adds). Device-agnostic: the CPU tests hold these against the plain
versions and the JAX kernels, the card tests against the kernels.
"""

import torch
import torch.nn.functional as F


def slices(x: torch.Tensor, rows: int, blocks: int) -> torch.Tensor:
    """x (N, S, C) -> (N, blocks, rows, C): block b's rows [b rows, (b + 1)
    rows), zero rows past S (adding +0 changes no sum)."""
    n, s, c = x.shape
    return F.pad(x, (0, 0, 0, blocks * rows - s)).reshape(n, blocks, rows, c)


def block_sums(xs: torch.Tensor, rstep: int) -> torch.Tensor:
    """(..., R, C) fp32 rows of a block -> (..., C): each row offset's rows
    in order, then the row offsets in order."""
    r, c = xs.shape[-2:]
    xs = F.pad(xs, (0, 0, 0, -r % rstep))
    xs = xs.reshape(xs.shape[:-2] + (-1, rstep, c))
    acc = torch.zeros(xs.shape[:-3] + (rstep, c), dtype=torch.float32,
                      device=xs.device)
    for j in range(xs.shape[-3]):
        acc = acc + xs[..., j, :, :]
    out = torch.zeros(xs.shape[:-3] + (c,), dtype=torch.float32,
                      device=xs.device)
    for ro in range(rstep):
        out = out + acc[..., ro, :]
    return out


def in_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one index after another, from 0."""
    out = torch.zeros_like(t.select(dim, 0))
    for i in range(t.shape[dim]):
        out = out + t.select(dim, i)
    return out


def gn_stats(x: torch.Tensor, groups: int, plan):
    """#16's per-group (S1, S2) of bf16 x (N, HW, C), each (N, G): what
    every rank of a sample's cluster holds after the exchange."""
    n, hw, c = x.shape
    xs = slices(x, plan.rows, plan.k)
    xf = xs.float()
    sq = (xs * xs).float()  # bf16 x * x: exact in fp32, rounded once
    cg = c // groups
    out = []
    for t in (xf, sq):
        chan = block_sums(t, plan.rstep)                     # (N, k, C)
        grp = in_order(chan.reshape(n, plan.k, groups, cg), 3)
        out.append(in_order(grp, 1))                         # rank order
    return out


def gn(x, scale, bias, groups: int, eps: float, silu: bool, plan):
    """#16's output for bf16 x (N, HW, C), fp32 scale and bias (C)."""
    n, hw, c = x.shape
    s1, s2 = gn_stats(x, groups, plan)
    cg = c // groups
    cnt = torch.tensor(float(hw), dtype=torch.float32) * float(cg)
    mean = s1 / cnt
    var = (s2 / cnt - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    a = inv.repeat_interleave(cg, 1) * scale.float()
    b = bias.float() - mean.repeat_interleave(cg, 1) * a
    y = x.float() * a[:, None] + b[:, None]
    if silu:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.to(x.dtype)


def channel_sums(x: torch.Tensor, plan):
    """#18's (s1, s2) of x (N, S, C), each (N, C) fp32."""
    xs = slices(x.float(), plan.rows, plan.chunks)
    parts = [block_sums(t, plan.rstep) for t in (xs, xs * xs)]
    return tuple(in_order(p, 1) for p in parts)              # chunk order
