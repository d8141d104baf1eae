"""The process group, its (data, model) mesh and the split rules
(tooncrafter_tpu/parallel/mesh.py).

The JAX package declares a 2-D mesh and lets GSPMD place the batch and
the parameters. The port runs one process per rank over torch.distributed:

  * ``data``: each rank takes a slice of the batch (``batch_slice``, the
    JAX CLI's ``host_shard`` rule); the trainer all-reduces the gradients
    to their mean in fp32 and shards the optimizer state by whole-tensor
    ownership (torch's ``ZeroRedundancyOptimizer``). The JAX rule splits a
    large tensor along its largest axis; Adafactor's factored moments of a
    slice would not be those of the tensor, so here each trainable is owned
    whole by one rank, which keeps 'adamw', 'adamw_lowmem' and 'adafactor'
    exact.
  * ``model``: tensor parallelism (``parallel/tensor.py``): the UNet's
    transformer blocks hold their share of the attention heads and of the
    feed-forward's hidden width, Megatron-style, with one fp32 reduction
    over the model group after each attention and each feed-forward. The
    ranks of one model group are consecutive (the mesh is
    ``arange(world).reshape(n_data, n_model)``, as the JAX package lays
    out its devices), see the same batch rows and hold the same activations
    between the sharded sub-blocks.

Collectives are ``all_reduce``, ``broadcast`` and ``all_gather`` only
(gloo has all three for CUDA tensors too: two ranks sharing one card run
over gloo, since NCCL refuses a duplicate GPU), on flat buckets of at most
``BUCKET_BYTES``, in a fixed order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class Dist:
    """This process's place: its rank, the world size, its device and the
    process group (None when no group was started: one process)."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None


def init_distributed(device, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> Dist:
    """Join the process group. With ``init_method`` (a ``file://`` store:
    tests and spawned phases) ``rank`` and ``world_size`` are given;
    without it torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are read, and where torchrun set
    none the process runs alone (no group); a process that has joined a
    group already keeps it. The backend is NCCL on CUDA
    and gloo on the CPU unless ``backend`` says otherwise (gloo on CUDA:
    ranks sharing a card). On CUDA the rank takes ``cuda:{local_rank}``
    (``LOCAL_RANK``, else the rank); a local rank past the card count is
    an error, and nothing moves to the CPU."""
    device = torch.device(device)
    if dist.is_initialized():  # joined already (by a spawned rank)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return Dist(dist.get_rank(), dist.get_world_size(), device,
                    dist.group.WORLD)
    launched = init_method is not None or "WORLD_SIZE" in os.environ
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if device.type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(f"rank {rank} wants cuda:{local_rank} and the "
                               f"process sees {n} CUDA devices")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"no distributed run on a {device.type} device")
    if not launched:
        return Dist(0, 1, device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return Dist(dist.get_rank(), dist.get_world_size(), device,
                dist.group.WORLD)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cpu"):
    """A ``DeviceMesh`` over the process group with dims ("data",
    "model"), rank r at (r // n_model, r % n_model); ``n_data`` defaults
    to the world size over ``n_model``. A shape that does not factor the
    world is refused."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"a mesh of {n_data} x {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} for {world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def data_group(mesh_or_group):
    """The process group of the ``data`` axis of a ``DeviceMesh``; a
    process group (or None) as it is."""
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group("data")
    return mesh_or_group


def model_group(mesh_or_group):
    """The process group of the ``model`` axis of a ``DeviceMesh``, or None
    where that axis has one rank (and for a bare process group or None:
    data parallel only)."""
    if hasattr(mesh_or_group, "get_group") and \
            mesh_or_group.shape[mesh_or_group.mesh_dim_names.index("model")] > 1:
        return mesh_or_group.get_group("model")
    return None


def rank_world(group) -> tuple:
    """(rank in ``group``, its size); (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def batch_slice(n_items: int, rank: int, world: int) -> slice:
    """The items rank ``rank`` of ``world`` owns: contiguous, in rank
    order, the remainder on the first ranks, none dropped (the JAX CLI's
    ``host_shard``)."""
    share, rem = divmod(n_items, world)
    lo = rank * share + min(rank, rem)
    return slice(lo, lo + share + (1 if rank < rem else 0))


def global_rank(group, r: int) -> int:
    """The global rank of rank ``r`` of ``group``."""
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive tensors of one dtype and device, at most BUCKET_BYTES a
    bucket (a larger tensor alone)."""
    out, nbytes = [], 0
    for t in tensors:
        b = t.numel() * t.element_size()
        if (not out or nbytes + b > BUCKET_BYTES
                or out[-1][0].dtype != t.dtype
                or out[-1][0].device != t.device):
            out.append([])
            nbytes = 0
        out[-1].append(t)
        nbytes += b
    return out


def _scatter_back(bucket: List[torch.Tensor], flat: torch.Tensor) -> None:
    pieces = flat.split([t.numel() for t in bucket])
    for t, p in zip(bucket, pieces):
        t.copy_(p.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors: List[torch.Tensor], group) -> None:
    """In place: each tensor becomes its mean over the group's ranks,
    summed in fp32 over flat buckets in list order."""
    _, world = rank_world(group)
    for bucket in buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= world
        _scatter_back(bucket, flat)


@torch.no_grad()
def broadcast_(tensors: List[torch.Tensor], src: int, group) -> None:
    """In place: every rank's tensors take rank ``src``'s values (``src``
    counted in the group), over flat buckets in list order."""
    for bucket in buckets(tensors):
        flat = (torch.cat([t.reshape(-1) for t in bucket]) if len(bucket) > 1
                else bucket[0].reshape(-1).clone())
        dist.broadcast(flat, src=global_rank(group, src), group=group)
        _scatter_back(bucket, flat)


def replicate_(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Every rank's parameters and buffers take rank ``src``'s (the JAX
    package's replicated placement)."""
    if group is None:
        return
    broadcast_([t.data for t in module.parameters()]
               + [b for b in module.buffers()], src, group)


def barrier(group, device: torch.device) -> None:
    """Wait for every rank of ``group`` (an all-reduce of one element on
    ``device``, which every backend takes)."""
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=device), group=group)


def all_gather_rows(x: torch.Tensor, n_rows: List[int], group) -> torch.Tensor:
    """Rank r's ``x`` holds ``n_rows[r]`` rows (it may hold fewer than
    x.shape[0]: padding); every rank gets their concatenation in rank
    order. Each rank sends max(n_rows) rows."""
    if group is None:
        return x[:n_rows[0]]
    most = max(n_rows)
    pad = x.new_zeros((most,) + tuple(x.shape[1:]))
    pad[:min(x.shape[0], most)] = x[:most]
    parts = [torch.empty_like(pad) for _ in n_rows]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, n_rows)])
