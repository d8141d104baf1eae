"""Checks shared by the kernel wrappers (flash attention, fused FF, temporal
conv, GN+SiLU+3x3 conv): which side of a call runs, and what the CUDA
kernels accept. A wrapper given CPU tensors runs its plain version; given
CUDA tensors it launches its kernel or raises."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def is_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def on_cpu(what: str, *ts: Optional[torch.Tensor]) -> bool:
    """True when the call takes the plain version; raises for tensors that
    are neither all on the CPU nor all on a CUDA device."""
    ts = [t for t in ts if t is not None]
    if all(not is_cuda(t) and t.device.type == "cpu" for t in ts):
        return True
    if all(is_cuda(t) for t in ts):
        return False
    raise ValueError(f"{what} takes CPU tensors (plain version) or CUDA "
                     "tensors (kernel); got "
                     + ", ".join(str(t.device) for t in ts))


def needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    """Is autograd recording a call on these tensors? Then a wrapper takes
    its autograd Function (or refuses); otherwise it runs as under
    no_grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def refuse_grad(what: str, *ts: Optional[torch.Tensor]) -> None:
    """For a kernel with no backward: raise, on the card, for a call that
    autograd is recording instead of returning a result cut from the
    graph. Under no_grad, or with no input requiring grad, nothing."""
    if needs_grad(*ts):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and an input requires "
            "grad; call it under torch.no_grad()")


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a fused kernel computes in for a call on ``t``: CUDA
    autocast's for a CUDA tensor while it is on, else t's own."""
    if t.is_cuda and torch.is_autocast_enabled("cuda"):
        return torch.get_autocast_dtype("cuda")
    return t.dtype


def check(name: str, t: torch.Tensor, shape: Sequence[int],
          dtype: torch.dtype, device) -> None:
    """Refuse what the kernels do not take: another dtype, device or
    shape, a non-contiguous tensor or a pointer not 16-byte aligned."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def pixel_tile(pixels: int) -> int:
    """The pixel tile (BM) of the implicit-GEMM convolutions for images or
    frames of ``pixels`` pixels: 128 where it divides them or they are many,
    else 64 (less of a ragged last tile at the UNet's 10x16 and 5x8
    levels). The temporal conv (csrc/implicit_gemm.cuh) splits it over two
    rows of warps, the 3x3 conv (csrc/gn_silu_conv3x3.cu) over BM / 64
    wgmma warpgroups; both write their sums per tile of BM pixels."""
    return 128 if pixels % 128 == 0 or pixels >= 1024 else 64


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")
