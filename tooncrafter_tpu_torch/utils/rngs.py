"""Batch-size-invariant noise (the torch counterpart of
tooncrafter_tpu/utils/rngs.py).

A run keyed per *item* draws the same noise for a clip whether it runs at
B = 1 or inside a batch, so ``--bs 2`` writes the videos ``--bs 1`` writes.
Each global item index gets its own ``torch.Generator``, seeded from
(seed, index) by ``numpy.random.SeedSequence([seed, index])`` (its first 64
bits of state). The streams are torch's, not ``jax.random``'s: the same seed
gives other numbers than the JAX package.

Every draw accepts one ``torch.Generator`` (or None: torch's default), which
draws the whole batch at once as before, or a sequence of generators, one
per item along the first axis.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def item_seed(seed: int, index: int) -> int:
    """The 64-bit seed of item ``index`` in a run seeded with ``seed``."""
    hi, lo = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    return (int(hi) << 32) | int(lo)


def per_item_generators(seed: int, indices: Iterable[int],
                        device="cpu") -> List[torch.Generator]:
    """One generator on ``device`` per global item index."""
    return [torch.Generator(device).manual_seed(item_seed(seed, int(i)))
            for i in indices]


def is_batched(gen: Generators) -> bool:
    return gen is not None and not isinstance(gen, torch.Generator)


def normal(gen: Generators, shape: Sequence[int],
           device: Optional[torch.device] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal of ``shape``. With one generator (or None) the whole
    tensor is one draw; with a sequence, shape[0] must be its length and
    item i's slice shape[1:] is drawn from gen[i]."""
    if not is_batched(gen):
        return torch.randn(tuple(shape), generator=gen, device=device,
                           dtype=dtype)
    if len(gen) != shape[0]:
        raise ValueError(f"{len(gen)} per-item generators for a leading "
                         f"dim of {shape[0]}")
    return torch.stack([torch.randn(tuple(shape[1:]), generator=g,
                                    device=device, dtype=dtype)
                        for g in gen])
