"""Frozen operation and byte counts from shapes.

``resblock`` and ``spatial_transformer`` give the least work of one call of
the UNet's ResBlock (its two 3x3 convs, skip, time-embedding projection
and the four (3, 1, 1) temporal convs of its TemporalConvBlock) and of its
SpatialTransformer (projections, both attentions, the GEGLU feed-forward),
whatever kernels implement them. Products count 2 operations a
multiply-add, as the port's ``utils/kernel_check`` cases do: a 3x3 conv
only its in-image taps, (3H - 2)(3W - 2) per image; a temporal conv its
3T - 2 in-clip taps. Bytes: the block's inputs read once and its output
written once in bf16, each weight once (bf16; norms' parameters fp32).

``model_flops`` counts a whole request or training step by running the
plain reference on the meta device under ``FlopCounterMode`` (products
only: linear, conv and both attention products).
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def conv3x3_flops(n: int, h: int, w: int, cin: int, cout: int) -> float:
    return 2.0 * n * (3 * h - 2) * (3 * w - 2) * cin * cout


def tconv_flops(b: int, t: int, p: int, c: int) -> float:
    return 2.0 * b * p * c * c * (3 * t - 2)


def resblock(n: int, h: int, w: int, cin: int, cout: int, t: int,
             emb_ch: int) -> Tuple[float, float]:
    """(operations, bytes) of a ResBlock call on n = B*T frames of h x w."""
    b = n // t
    flops = (conv3x3_flops(n, h, w, cin, cout)
             + conv3x3_flops(n, h, w, cout, cout)
             + 2.0 * n * emb_ch * cout
             + 4 * tconv_flops(b, t, h * w, cout))
    weights = 9 * cin * cout + 9 * cout * cout + emb_ch * cout \
        + 4 * 3 * cout * cout + 6 * cout
    if cin != cout:
        flops += 2.0 * n * h * w * cin * cout
        weights += cin * cout + cout
    norms = 8.0 * (cin + 5 * cout)
    nbytes = 2.0 * (n * h * w * (cin + cout) + n * emb_ch + weights) + norms
    return flops, nbytes


def spatial_transformer(n: int, s: int, c: int, ctx_len: int, ctx_dim: int,
                        text_len: int = 77, ff_mult: int = 4
                        ) -> Tuple[float, float]:
    """(operations, bytes) of a depth-1 SpatialTransformer call on n
    frames of s tokens of width c (= heads * dim_head), with a context of
    ctx_len tokens of ctx_dim (text_len text, the rest image)."""
    d = ff_mult * c
    lin = 2.0 * n * s * c * c
    flops = (lin                                   # proj_in
             + 4 * lin + 4.0 * n * s * s * c       # attn1: q|k|v, out; QK, PV
             + 2 * lin                             # attn2: q, out
             + 4.0 * n * ctx_len * ctx_dim * c     # attn2: k, v (text, image)
             + 4.0 * n * s * ctx_len * c           # attn2: QK, PV
             + 2.0 * n * s * c * 2 * d + 2.0 * n * s * d * c   # GEGLU FF
             + lin)                                # proj_out
    weights = (c * c + c) + (4 * c * c + c) + (2 * c * c + c) \
        + 4 * ctx_dim * c + (c * 2 * d + 2 * d) + (d * c + c) + (c * c + c)
    norms = 8.0 * 4 * c
    nbytes = 2.0 * (2 * n * s * c + n * ctx_len * ctx_dim + weights) + norms
    return flops, nbytes


def model_flops(fn) -> float:
    """The products ``fn()`` runs, counted on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())
