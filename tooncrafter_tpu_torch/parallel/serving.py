"""Rank-sharded batched serving (tooncrafter_tpu/parallel/serving.py).

The JAX package serves a clip batch as one program with the batch sharded
over the mesh's ``data`` axis. Here each rank runs its ``batch_slice`` of
the clips through its own copy of the Pipeline, each clip's noise from a
generator keyed by its global index (``utils/rngs.per_item_generators``),
and the clips are all-gathered, so every rank returns the whole batch in
order and a clip does not depend on the world size. Ragged batches are
served: a rank's slice may be shorter (or empty), and the gather pads
every slice to the longest and trims it.

With ``shard_params`` (the JAX ``BatchedPipeline(shard_params=True)``) and
a mesh whose model axis has more than one rank, ``place_params`` gives
every rank global rank 0's weights and then shards the UNet's transformer
blocks over the model group (``parallel/tensor.py``). The ranks of one
model group serve the same clips with the same per-clip generators, so
their outputs are equal; the clips are split and gathered over the data
group only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from tooncrafter_tpu_torch.parallel import mesh as M
from tooncrafter_tpu_torch.parallel import tensor as TP
from tooncrafter_tpu_torch.utils import rngs as R


class BatchedPipeline:
    """Wraps ``models.diffusion.Pipeline`` over a process group (or a
    ``DeviceMesh``'s ``data`` axis, and with ``shard_params`` its ``model``
    axis); without one, the pipeline alone."""

    def __init__(self, pipeline, group=None, shard_params: bool = False):
        self.pipe = pipeline
        self.mesh = group
        self.group = M.data_group(group)
        self.model_group = M.model_group(group) if shard_params else None

    def place_params(self, src: int = 0) -> None:
        """Every rank takes rank ``src``'s weights and buffers (``src``
        counted in the data group; under ``shard_params`` the global rank),
        then, under ``shard_params``, keeps its share of the UNet's
        transformer blocks."""
        model = self.pipe.model
        if self.model_group is not None and TP.model_group_of(model) is None:
            M.replicate_(model, src, dist.group.WORLD)
            TP.shard_(model, self.mesh)
        else:  # a sharded model (a trained state) keeps its shards
            M.replicate_(model, src, self.group)

    @torch.no_grad()
    def __call__(self, video, tokens, null_tokens, fs, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """video (B, T, H, W, 3), tokens and null_tokens (B, 77), fs (B,),
        every rank the whole batch. Clip i draws its posterior, x_T and
        step noise from the generator of (``seed``, ``indices[i]``)
        (default: i). With ``x_T`` (B, ...) nothing is drawn: the
        posterior's mode and ``x_T[i]``, at eta 0. Returns (B, T, H, W, 3)
        fp32 on every rank."""
        b = video.shape[0]
        indices = list(range(b)) if indices is None else list(indices)
        if len(indices) != b:
            raise ValueError(f"{len(indices)} clip indices for a batch of "
                             f"{b}")
        if x_T is not None and self.pipe.ddim["eta"]:
            raise ValueError("x_T draws nothing: it needs eta 0")
        rank, world = M.rank_world(self.group)
        rows = [M.batch_slice(b, r, world) for r in range(world)]
        mine = rows[rank]
        if mine.stop > mine.start:
            gens = (None if x_T is not None else R.per_item_generators(
                seed, indices[mine], video.device))
            out = self.pipe(video[mine], tokens[mine], null_tokens[mine],
                            fs[mine], generator=gens,
                            x_T=None if x_T is None else x_T[mine]).float()
        else:
            out = torch.zeros((0,) + tuple(video.shape[1:]),
                              device=video.device)
        return M.all_gather_rows(out, [s.stop - s.start for s in rows],
                                 self.group)
