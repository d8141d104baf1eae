"""Training-state checkpoints with ``torch.save`` (the JAX package uses
orbax; tooncrafter_tpu/training/checkpoints.py).

``save_train_state`` writes ``step_<n>.pt`` under a directory (atomically:
a temporary file, then a rename) and keeps the newest ``keep``;
``restore_train_state`` loads the newest (or a given step) into a live
``TrainState``: trainable weights, optimizer and schedule state, the EMA
shadow, the accumulated gradients and the step. ``save_params`` /
``load_params`` export and read a weights-only dictionary.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

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


def save_train_state(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write the state at ``step`` (synchronously); drop all but the newest
    ``keep``."""
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
    if state.accum is not None:
        payload["accum"] = state.accum
    path = _path(ckpt_dir, step)
    _atomic_save(payload, path)
    for old in _steps(ckpt_dir)[:-keep]:
        os.remove(_path(ckpt_dir, old))
    return path


@torch.no_grad()
def restore_train_state(ckpt_dir: str, state,
                        step: Optional[int] = None) -> Tuple[object, int]:
    """Load the newest checkpoint (or ``step``) into ``state`` in place.
    Returns (state, step restored), or (state, 0) when there is none."""
    steps = _steps(ckpt_dir)
    step = steps[-1] if step is None and steps else step
    if step is None:
        return state, 0
    dev = next(iter(state.train_params.values())).device
    payload = torch.load(_path(ckpt_dir, step), map_location=dev,
                         weights_only=True)
    for k, p in state.train_params.items():
        p.copy_(payload["train_params"][k])
    state.optimizer.load_state_dict(payload["opt_state"])
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
