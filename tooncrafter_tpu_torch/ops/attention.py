"""Attention entry points, with the dispatch rule of
tooncrafter_tpu/ops/attention.py.

``attention`` splits heads and sends shapes inside the flash envelope
(``flash_attention._use_kernel``) to the flash wrappers; everything else
(cross-attention over 77/16/257 context tokens, masked attention) runs the
plain fp32-softmax form here, as the TPU package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from tooncrafter_tpu_torch.ops import flash_attention as fa


def dot_product_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None):
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) -> (B, Sq, H, D) in v.dtype.
    Logits and softmax in fp32; probabilities cast to v.dtype for the PV
    product. ``mask`` (bool, True = keep) broadcasts to (B, H, Sq, Sk)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    # fp32 logits also where autocast runs the product in bf16
    logits = torch.matmul(q.float().transpose(1, 2),
                          k.float().permute(0, 2, 3, 1)).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


def attention(q, k, v, *, heads: int, mask=None, scale=None):
    """Multi-head attention over flat (B, S, H*D) projections."""
    b, sq, inner = q.shape
    sk = k.shape[1]
    d = inner // heads
    qh = q.reshape(b, sq, heads, d)
    kh = k.reshape(b, sk, heads, d)
    vh = v.reshape(b, sk, heads, d)
    if mask is None and fa._use_kernel(sq, sk, d):
        out = fa.flash_attention(qh, kh, vh, scale=scale)
    else:
        out = dot_product_attention(qh, kh, vh, mask=mask, scale=scale)
    return out.reshape(b, sq, inner)


def temporal_attention_inplace(q, k, v, *, heads: int, mask=None,
                               scale: Optional[float] = None,
                               rel_k=None, rel_v=None):
    """Self-attention over the T axis of (B, T, H, W, heads*D) tensors;
    ``mask`` is an optional (T, T) bool (True = keep). ``rel_k``, ``rel_v``:
    optional (T, T, D) relative-position embeddings, added to the logits
    (q . rel_k, scaled) and to the output (probs @ rel_v), as
    tooncrafter_tpu/ops/attention.py:95-124 adds them."""
    b, t, hh, ww, inner = q.shape
    d = inner // heads
    scale = d ** -0.5 if scale is None else scale

    def split(x):  # -> (B, H*W, heads, T, D)
        return x.reshape(b, t, hh * ww, heads, d).permute(0, 2, 3, 1, 4)

    qs = split(q).float()
    # fp32 logits also where autocast runs the products in bf16
    logits = torch.matmul(qs, split(k).float().transpose(-1, -2)).float() \
        * scale
    if rel_k is not None:
        logits = logits + torch.einsum("bpntd,tsd->bpnts", qs,
                                       rel_k.float()).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, split(v))
    if rel_v is not None:
        out = out + torch.einsum("bpnts,tsd->bpntd", probs.float(),
                                 rel_v.float()).float().to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hh, ww, inner)
