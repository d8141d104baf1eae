"""Training-state checkpoints with ``torch.save`` (the JAX package uses
orbax; tooncrafter_tpu/training/checkpoints.py).

``save_train_state`` writes ``step_<n>.pt`` under a directory (atomically:
a temporary file, then a rename) and keeps the newest ``keep``;
``restore_train_state`` loads the newest (or a given step) into a live
``TrainState``: trainable weights, optimizer and schedule state, the EMA
shadow, the accumulated gradients and the step. ``save_params`` /
``load_params`` export and read a weights-only dictionary.

A checkpoint does not depend on the world size. Under data parallel (a
``ZeroRedundancyOptimizer``: each rank's optimizer holds its owned
tensors' state) ``save_train_state`` consolidates the owners' state on rank
0 in the one-process layout (indices over every trainable in
``train_params`` order), takes the accumulated gradients as the ranks'
mean, and rank 0 alone writes and prunes; ``restore_train_state`` reads
the file on every rank, whose optimizer keeps its owned tensors' state.
So a checkpoint written by N ranks resumes in one process, and the
reverse.

Under tensor parallelism (a state with a ``model_group``) the file still
holds whole tensors under the ``lvdm`` names: the model group of data rank
0 gathers the trainables, the EMA, the accumulated gradients and every
per-tensor optimizer state of the sharded tensors (``parallel/tensor.py``)
after the data group's consolidation, and global rank 0 writes. A rank
that restores keeps its own piece of each. So a checkpoint moves between
any (n_data, n_model).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from tooncrafter_tpu_torch.parallel import mesh as M

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _device(state) -> torch.device:
    return next(iter(state.train_params.values())).device


def save_train_state(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write the state at ``step`` (synchronously); drop all but the newest
    ``keep``. Under a process group every rank calls it: the owners'
    optimizer state is consolidated on rank 0, which writes and prunes, and
    every rank waits for the write."""
    group, mgroup = state.group, state.model_group
    rank, _ = M.rank_world(group)
    if group is not None:
        state.optimizer.consolidate_state_dict(to=0)
    accum = state.accum
    if accum is not None and group is not None:
        accum = [a.clone() for a in accum]
        M.all_reduce_mean_(accum, group)
    path = _path(ckpt_dir, step)
    if rank == 0:
        payload = {
            "step": int(state.step),
            "train_params": {k: p.detach() for k, p in
                             state.train_params.items()},
            "opt_state": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "micro": state.micro,
        }
        if state.ema_params is not None:
            payload["ema_params"] = state.ema_params
        if accum is not None:
            payload["accum"] = dict(zip(state.train_params, accum))
        if mgroup is not None:
            payload = _whole(payload, state, mgroup)
        if "accum" in payload:
            payload["accum"] = list(payload["accum"].values())
        if M.rank_world(mgroup)[0] == 0:
            _atomic_save(payload, path)
            for old in _steps(ckpt_dir)[:-keep]:
                os.remove(_path(ckpt_dir, old))
    if mgroup is not None:
        import torch.distributed as dist
        M.barrier(dist.group.WORLD, _device(state))
    else:
        M.barrier(group, _device(state))
    return path


def _optimizer_tensors(opt_state, names):
    """{(param name, key): tensor} of an optimizer state dict's per-tensor
    states (indices over ``names``, the trainables' order), in that order
    (the dict's own follows the owner split, which model ranks of unequal
    shards sort apart)."""
    st = opt_state["state"]
    return {(names[i], k): st[i][k] for i in sorted(st) for k in sorted(st[i])
            if torch.is_tensor(st[i][k]) and st[i][k].ndim}


def _whole(payload, state, mgroup):
    """The payload's sharded tensors made whole over the model group (every
    rank of it calls this, with the same payload's keys)."""
    from tooncrafter_tpu_torch.parallel import tensor as TP

    lays = TP.layouts(state.model)
    names = list(state.train_params)
    out = dict(payload)
    for key in ("train_params", "ema_params", "accum"):
        if key in payload:
            out[key] = TP.gather_tensors(payload[key], lays, mgroup)
    opt = payload["opt_state"]
    flat = _optimizer_tensors(opt, names)
    whole = TP.gather_tensors(
        {k: v for k, v in flat.items() if k[0] in lays},
        {k: lays[k[0]] for k in flat if k[0] in lays}, mgroup)
    state_dict = {i: dict(st) for i, st in opt["state"].items()}
    for (name, k), v in whole.items():
        state_dict[names.index(name)][k] = v
    out["opt_state"] = {**opt, "state": state_dict}
    return out


def _local(payload, state):
    """This model rank's pieces of a whole payload's sharded tensors."""
    from tooncrafter_tpu_torch.parallel import tensor as TP

    lays = TP.layouts(state.model)
    rank, _ = M.rank_world(state.model_group)
    names = list(state.train_params)
    out = dict(payload)
    for key in ("train_params", "ema_params"):
        if key in payload:
            out[key] = TP.local_tensors(payload[key], lays, rank)
    if payload.get("accum") is not None:
        out["accum"] = list(TP.local_tensors(
            dict(zip(names, payload["accum"])), lays, rank).values())
    opt = payload["opt_state"]
    state_dict = {i: dict(st) for i, st in opt["state"].items()}
    for (name, k), v in _optimizer_tensors(opt, names).items():
        if name in lays:
            state_dict[names.index(name)][k] = TP.local_of(v, lays[name],
                                                           rank)
    out["opt_state"] = {**opt, "state": state_dict}
    return out


@torch.no_grad()
def restore_train_state(ckpt_dir: str, state,
                        step: Optional[int] = None) -> Tuple[object, int]:
    """Load the newest checkpoint (or ``step``) into ``state`` in place.
    Returns (state, step restored), or (state, 0) when there is none. Under
    a process group each rank keeps its owned tensors' optimizer state."""
    steps = _steps(ckpt_dir)
    step = steps[-1] if step is None and steps else step
    if step is None:
        return state, 0
    payload = torch.load(_path(ckpt_dir, step), map_location=_device(state),
                         weights_only=True)
    if state.model_group is not None:
        payload = _local(payload, state)
    for k, p in state.train_params.items():
        p.copy_(payload["train_params"][k])
    state.optimizer.load_state_dict(payload["opt_state"])
    if state.group is not None:
        # the ZeroRedundancyOptimizer's own table keeps the loaded values
        # (cast to the parameters' dtype) beside its local optimizer's,
        # which alone are used
        state.optimizer.state.clear()
    state.scheduler.load_state_dict(payload["scheduler"])
    if state.ema_params is not None and "ema_params" in payload:
        for k, e in state.ema_params.items():
            e.copy_(payload["ema_params"][k])
    state.accum = payload.get("accum")
    state.micro = payload.get("micro", 0)
    state.step = int(payload["step"])
    return state, int(step)


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Weights-only export (an inference artifact)."""
    _atomic_save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read an export (CPU tensors by name)."""
    return torch.load(path, map_location="cpu", weights_only=True)
