"""Random weights from the seed, made on the device in a few large calls.

The rule is the port's ``init_random_`` (the JAX package's default): a
norm's weight 1 and bias 0; a bias, a scalar and a ``mix_factor`` 0; any
other tensor a normal with std fan_in ** -0.5, fan_in the input features
of a linear or conv weight and the last axis elsewhere. The normals come
from one generator in chunks of ``CHUNK`` elements, each parameter taking
its slice of the stream by its name's place in sorted order, so a model
whose parameters carry the same names (the system under test, the plain
reference) gets the same tensors whatever order it registers them in.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

CHUNK = 1 << 28
_CONVS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def seed64(*keys: int) -> int:
    """A 63-bit seed from integers (any size) through numpy's
    SeedSequence."""
    hi, lo = np.random.SeedSequence([int(k) % (1 << 64) for k in keys]) \
        .generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def rules(model: nn.Module) -> List[Tuple[str, nn.Parameter, object]]:
    """(name, parameter, rule) with rule 1.0 or 0.0 (a constant) or
    ('normal', std), sorted by name."""
    out = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                rule = 1.0 if pname == "weight" else 0.0
            elif pname == "bias" or p.ndim == 0 or pname == "mix_factor":
                rule = 0.0
            else:
                fan_in = (int(np.prod(p.shape[1:]))
                          if isinstance(mod, _CONVS) and pname == "weight"
                          else p.shape[-1])
                rule = ("normal", fan_in ** -0.5)
            out.append((name, p, rule))
    return sorted(out, key=lambda r: r[0])


def _stream(gen: torch.Generator, dtype, device) -> Iterator[torch.Tensor]:
    while True:
        yield torch.randn(CHUNK, generator=gen, dtype=dtype, device=device)


@torch.no_grad()
def fill_(model: nn.Module, seed: int, dtype: torch.dtype) -> None:
    """Fill every parameter of ``model`` (already on its device) from
    ``seed``: the normals drawn in ``dtype`` (the type they are served in)
    and cast to each parameter's own."""
    items = rules(model)
    device = items[0][1].device
    gen = torch.Generator(device).manual_seed(seed64(seed, 0x5EED))
    chunks = _stream(gen, dtype, device)
    buf, pos = next(chunks), 0
    for _, p, rule in items:
        if not isinstance(rule, tuple):
            p.fill_(rule)
            continue
        flat, done = p.view(-1) if p.is_contiguous() else None, 0
        n = p.numel()
        parts = []
        while done < n:
            take = min(n - done, CHUNK - pos)
            parts.append(buf[pos:pos + take])
            pos += take
            done += take
            if pos == CHUNK:
                buf, pos = next(chunks), 0
        vals = (parts[0] if len(parts) == 1 else torch.cat(parts)) * rule[1]
        if flat is not None:
            flat.copy_(vals)
        else:
            p.copy_(vals.view(p.shape))
