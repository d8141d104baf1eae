"""Tensor parallelism over the mesh's ``model`` axis (the JAX package shards
the 2-D projection kernels' output features over 'model' and lets GSPMD
place the collectives, tooncrafter_tpu/parallel/mesh.py:53-55; here the
layout and the collectives are explicit, Megatron-style).

Only the UNet's transformer blocks (``BasicTransformerBlock``: spatial,
temporal and the init attention's) shard, each over the model group:

  * attention: the heads go to the model ranks in contiguous groups,
    ``batch_slice(heads, r, n)`` (5 heads: 3 + 2 at n = 2, 2 + 1 + 1 + 1 at
    4). to_q, to_k, to_v, to_k_ip and to_v_ip are column-parallel (a rank
    holds its heads' rows of the weight), to_out.0 row-parallel (their
    columns).
  * feed-forward: the GEGLU width D the same way, in units of 64 columns
    (the kernels' tile). ff.net.0.proj keeps rank r's value rows s_r and
    its gate rows D + s_r, concatenated, so that the local ``chunk(2)``
    pairs each value column with its own gate; ff.net.2 holds columns s_r.

Every other parameter (the norms, both out biases, proj_in / proj_out, the
convs, the embeddings, CLIP, the resampler, the VAE) stays whole on every
rank, and so does every activation between the sharded sub-blocks. Each
sharded sub-block reads its input through ``copy_to_model`` (identity;
the backward sums the gradient over the model group) and ends in
``reduce_from_model`` (the ranks' fp32 partial outputs summed in rank
order; identity backward), after which the out bias and the residual are
added once, as the whole block adds them.

Gradients: a sharded tensor's gradient is its rank's own. A replicated
parameter that a sharded sub-block reads before its reduction (norm1,
norm2, norm3, the image attention's ``alpha``, the relative-position
tables) gets this rank's part of its gradient, which the trainer sums over
the model group (``grad_roles``); every other replicated parameter gets the
same gradient on every model rank.

The model knows its group through one attribute, ``tp`` (a ``Shard``), that
``shard_`` sets on each sharded block and on its attentions and
feed-forward; without it (the default, None) a block runs whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.parallel import mesh as M

_ROWS = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
_FF_UNIT = 64


@dataclasses.dataclass(frozen=True)
class Shard:
    """A sharded block's place: the model group, this rank's index in it
    and the group's size, and the block's whole head count, head width and
    feed-forward width D."""
    group: object
    rank: int
    size: int
    heads: int
    dim_head: int
    d_ff: int

    def heads_of(self, r: int) -> slice:
        return M.batch_slice(self.heads, r, self.size)

    def ff_of(self, r: int) -> slice:
        unit = _FF_UNIT if self.d_ff % _FF_UNIT == 0 else 1
        s = M.batch_slice(self.d_ff // unit, r, self.size)
        return slice(s.start * unit, s.stop * unit)

    @property
    def local_heads(self) -> int:
        s = self.heads_of(self.rank)
        return s.stop - s.start


# a sharded tensor's layout: the dimension it is split along and, for each
# rank, the slices of that dimension it holds, concatenated in order
Layout = Tuple[int, List[List[slice]]]


def block_layouts(sh: Shard, block: nn.Module) -> Dict[str, Layout]:
    """The layout of each sharded parameter of a BasicTransformerBlock, by
    its name in the block."""
    def rows(r):
        s = sh.heads_of(r)
        return [slice(s.start * sh.dim_head, s.stop * sh.dim_head)]

    def ff(r):
        return [sh.ff_of(r)]

    def geglu(r):
        s = sh.ff_of(r)
        return [s, slice(sh.d_ff + s.start, sh.d_ff + s.stop)]

    ranks = range(sh.size)
    out = {}
    for a in ("attn1", "attn2"):
        attn = getattr(block, a)
        for lin in _ROWS:
            if hasattr(attn, lin):
                out[f"{a}.{lin}.weight"] = (0, [rows(r) for r in ranks])
        out[f"{a}.to_out.0.weight"] = (1, [rows(r) for r in ranks])
    out["ff.net.0.proj.weight"] = (0, [geglu(r) for r in ranks])
    out["ff.net.0.proj.bias"] = (0, [geglu(r) for r in ranks])
    out["ff.net.2.weight"] = (1, [ff(r) for r in ranks])
    return out


def local_of(whole: torch.Tensor, layout: Layout, rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of a whole tensor."""
    dim, per_rank = layout
    return torch.cat([whole.narrow(dim, s.start, s.stop - s.start)
                      for s in per_rank[rank]], dim).contiguous()


def whole_of(pieces: List[torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole tensor from every rank's piece, in rank order."""
    dim, per_rank = layout
    size = max(s.stop for slices in per_rank for s in slices)
    shape = list(pieces[0].shape)
    shape[dim] = size
    out = pieces[0].new_empty(shape)
    for piece, slices in zip(pieces, per_rank):
        at = 0
        for s in slices:
            n = s.stop - s.start
            out.narrow(dim, s.start, n).copy_(piece.narrow(dim, at, n))
            at += n
    return out


def _unet_blocks(model: nn.Module) -> Iterable[Tuple[str, nn.Module]]:
    from tooncrafter_tpu_torch.models.unet import (BasicTransformerBlock,
                                                   UNetModel)
    for prefix, unet in model.named_modules():
        if isinstance(unet, UNetModel):
            for name, blk in unet.named_modules():
                if isinstance(blk, BasicTransformerBlock):
                    yield (f"{prefix}.{name}" if prefix else name), blk


def shard_(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's share of every UNet transformer block's attention
    and feed-forward weights, in place (the parameters keep their objects
    and their ``lvdm`` names), and give each block its ``Shard``. Every rank
    must hold the same whole weights before. Nothing happens where the
    mesh's model axis has one rank."""
    group = M.model_group(mesh)
    if group is None:
        return model
    rank, size = M.rank_world(group)
    for _, blk in _unet_blocks(model):
        if blk.tp is not None:
            raise RuntimeError("shard_: the model is sharded already")
        sh = Shard(group, rank, size, blk.attn1.heads, blk.attn1.dim_head,
                   blk.ff.net[2].weight.shape[1])
        if sh.heads < size:
            raise ValueError(f"{sh.heads} heads over {size} model ranks")
        with torch.no_grad():
            for name, layout in block_layouts(sh, blk).items():
                p = blk.get_parameter(name)
                p.data = local_of(p.data, layout, rank)
        for mod in (blk, blk.attn1, blk.attn2, blk.ff):
            mod.tp = sh
        blk.attn1.heads = blk.attn2.heads = sh.local_heads
    return model


def unshard_(model: nn.Module, whole: Dict[str, torch.Tensor]) -> nn.Module:
    """Undo ``shard_``: every block whole again, with the weights and
    buffers of ``whole`` (a state dict of the whole model)."""
    for _, blk in _unet_blocks(model):
        if blk.tp is not None:
            blk.attn1.heads = blk.attn2.heads = blk.tp.heads
            for mod in (blk, blk.attn1, blk.attn2, blk.ff):
                mod.tp = None
    with torch.no_grad():
        for k, p in model.named_parameters():
            if p.shape != whole[k].shape:
                p.data = torch.empty_like(whole[k], device=p.device)
    model.load_state_dict(whole)
    return model


def layouts(model: nn.Module) -> Dict[str, Layout]:
    """Every sharded parameter of a sharded model, by its name in
    ``model.named_parameters()``, with its layout."""
    out = {}
    for prefix, blk in _unet_blocks(model):
        if blk.tp is not None:
            for name, layout in block_layouts(blk.tp, blk).items():
                out[f"{prefix}.{name}"] = layout
    return out


def model_group_of(model: nn.Module):
    """The model group a sharded model runs over (None: unsharded)."""
    for _, blk in _unet_blocks(model):
        return None if blk.tp is None else blk.tp.group
    return None


def grad_roles(model: nn.Module) -> Tuple[set, set]:
    """(names of the sharded parameters, names of the replicated ones whose
    gradient on a model rank is that rank's part: the norms, ``alpha`` and
    the relative-position tables of each sharded block)."""
    sharded, partial = set(), set()
    for prefix, blk in _unet_blocks(model):
        if blk.tp is None:
            continue
        mine = block_layouts(blk.tp, blk)
        sharded |= {f"{prefix}.{n}" for n in mine}
        for n, _ in blk.named_parameters():
            if n not in mine and not n.endswith(("to_out.0.bias",
                                                  "ff.net.2.bias")):
                partial.add(f"{prefix}.{n}")
    return sharded, partial


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def sum_in_rank_order(x: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum of every rank's ``x`` (same shape), added in rank order
    on every rank, so every rank holds the same bits."""
    xf = x.float().contiguous()
    _, size = M.rank_world(group)
    parts = [torch.empty_like(xf) for _ in range(size)]
    dist.all_gather(parts, xf, group=group)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, sum_in_rank_order(g, ctx.group).to(g.dtype)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return sum_in_rank_order(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a sharded sub-block: x itself; its gradient summed
    over the model group."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(group, x)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial outputs summed in fp32, in rank order; the
    gradient passes to each rank's partial unchanged."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(group, x)
    return sum_in_rank_order(x, group)


def row_parallel(x: torch.Tensor, linear: nn.Linear, group) -> torch.Tensor:
    """A row-parallel Linear's output: this rank's columns' product in fp32
    (the operands' exact products summed in fp32, as the whole GEMM
    accumulates; a bf16 partial would round each rank's share once more),
    summed over the model group, then the bias added once and rounded to
    the compute dtype, where the whole Linear rounds."""
    with torch.autocast(x.device.type, enabled=False):
        part = nn.functional.linear(x.float(), linear.weight.float())
    acc = reduce_from_model(part, group)
    return (acc + linear.bias.float()).to(_launch.compute_dtype(x))


@torch.no_grad()
def sum_over_model_(tensors: List[torch.Tensor], group) -> None:
    """In place: each tensor becomes its sum over the model group (fp32,
    rank order)."""
    for bucket in M.buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        M._scatter_back(bucket, sum_in_rank_order(flat, group))


def global_norm(grads: List[torch.Tensor], sharded: List[bool],
                group) -> torch.Tensor:
    """sqrt of the sum of squares of the whole gradient: the sharded
    tensors' squares summed over the model group, each replicated tensor's
    counted once."""
    def sq(ts):
        if not ts:
            return torch.zeros((), device=grads[0].device)
        return torch.stack([n.float() ** 2
                            for n in torch._foreach_norm(ts)]).sum()
    mine = sq([g for g, s in zip(grads, sharded) if s])
    rep = sq([g for g, s in zip(grads, sharded) if not s])
    return torch.sqrt(sum_in_rank_order(mine, group) + rep)


@torch.no_grad()
def gather_tensors(tensors: Dict[str, torch.Tensor],
                   lays: Dict[str, Layout], group) -> Dict[str, torch.Tensor]:
    """Whole tensors by name: those with a layout gathered over the model
    group (every rank of it calls this, with the same names in the same
    order), the rest as they are."""
    out = {}
    for name, t in tensors.items():
        if name not in lays:
            out[name] = t
            continue
        dim, per_rank = lays[name]
        sizes = [sum(s.stop - s.start for s in sl) for sl in per_rank]
        rows = M.all_gather_rows(t.movedim(dim, 0).float(), sizes, group)
        out[name] = whole_of([p.movedim(0, dim).to(t.dtype)
                              for p in rows.split(sizes)], lays[name])
    return out


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded tensor whole (every rank
    of the model group calls it); the model's own state dict where it is
    not sharded."""
    sd = model.state_dict()
    group = model_group_of(model)
    if group is None:
        return sd
    return gather_tensors(sd, layouts(model), group)


def local_tensors(tensors: Dict[str, torch.Tensor], lays: Dict[str, Layout],
                  rank: int) -> Dict[str, torch.Tensor]:
    """This rank's pieces of whole tensors by name (those without a layout
    as they are)."""
    return {n: local_of(t, lays[n], rank) if n in lays else t
            for n, t in tensors.items()}
