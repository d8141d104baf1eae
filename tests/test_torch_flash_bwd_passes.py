"""The flash-attention backward kernel's Python side on the CPU: the
wrapper's scratch (shapes, strides, padding to whole query tiles), the
plain versions of its pre-pass and post-pass (the dq accumulator in the
order of the main pass's wgmma fragments) and of its three passes together
against ``_plain_bwd_bh`` and against the JAX package's ``_flash_bwd_bh``
in Pallas interpret mode, and the key tiles the forward kernel rounds p at,
read from its CUDA source. Inputs come from numpy with a seed; fp32 sums in
another order than the reference: max |difference| <= 1e-5 of the largest
magnitude (1e-4 against the JAX kernel, as tests/test_torch_flash_backward
holds the plain version).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import flash_attention as jfa
from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


def _close(actual, expected, tol):
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape, (a.shape, e.shape)
    rel = float(np.abs(a - e).max()) / max(1e-6, float(np.abs(e).max()))
    assert rel <= tol, f"max rel err {rel:.3e} > {tol}"


def _operands(seed, n, sq, sk):
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.normal(size=(n, sq, 64)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(n, sk, 64)).astype(
        np.float32)) for _ in range(2))
    return q, k, v, dout


@pytest.mark.parametrize("bh,sq", [(1, 64), (3, 333), (160, 2560), (2, 1)])
def test_scratch_covers_whole_query_tiles(bh, sq):
    scratch = fa.bwd_scratch(bh, sq, torch.device("cpu"))
    pad = -(-sq // 64) * 64
    assert scratch["dsum"].shape == scratch["lse2"].shape == (bh, pad)
    assert scratch["dq_acc"].shape == (bh, pad, 64)
    for t in scratch.values():
        assert t.dtype == torch.float32 and t.is_contiguous()
    # one allocation; each query tile's dq, D and lse start 256 bytes apart
    # (bulk copies and reductions need 16)
    base = scratch["dq_acc"].data_ptr()
    assert scratch["dsum"].data_ptr() == base + bh * pad * 64 * 4
    assert scratch["lse2"].data_ptr() == base + bh * pad * 65 * 4
    assert scratch["dq_acc"].stride() == (pad * 64, 64, 1)
    assert scratch["dsum"].stride() == scratch["lse2"].stride() == (pad, 1)


def test_dq_tile_order_is_the_fragment_order():
    order = fa.dq_tile_order()
    assert order.flatten().sort().values.equal(torch.arange(4096))
    # row 16w + g + 8r, column 8j + 2t + e -> 2 (128 (2j + r) + 32w + 4g + t)
    # + e
    assert order[0, 0] == 0 and order[0, 1] == 1 and order[0, 2] == 2
    assert order[1, 0] == 8 and order[8, 0] == 256 and order[16, 0] == 64
    assert order[0, 8] == 512 and order[63, 63] == 2 * (128 * 15 + 127) + 1


def test_prep_pads_with_zero_and_inf():
    q, k, v, dout = _operands(1, 2, 70, 90)
    out, lse = fa._plain_bh(q, k, v, 0.125)
    dsum, lse2 = fa._plain_bwd_prep(out, dout, lse)
    assert dsum.shape == lse2.shape == (2, 128)
    torch.testing.assert_close(dsum[:, :70], (out * dout).sum(-1))
    torch.testing.assert_close(lse2[:, :70], lse * 1.4426950408889634)
    assert (dsum[:, 70:] == 0).all() and torch.isinf(lse2[:, 70:]).all()


def test_post_reads_the_fragment_order():
    acc = torch.arange(2 * 128 * 64, dtype=torch.float32).reshape(2, 128, 64)
    dq = fa._plain_bwd_post(acc, 0.5, 100)
    tiles = acc.reshape(2, 2, 4096)
    want = tiles[..., fa.dq_tile_order().flatten()].reshape(2, 128, 64)
    assert dq.shape == (2, 100, 64)
    assert torch.equal(dq, 0.5 * want[:, :100])


@pytest.mark.parametrize("n,sq,sk", [(3, 200, 97), (2, 64, 333), (2, 3, 5),
                                     (1, 257, 256)])
def test_three_passes_match_the_plain_backward(n, sq, sk):
    """Ragged query tiles and key blocks, Sq != Sk, one query row."""
    q, k, v, dout = _operands(sq + sk, n, sq, sk)
    out, lse = fa._plain_bh(q, k, v, 0.125)
    ref = fa._plain_bwd_bh(q, k, v, dout, 0.125, out, lse)
    got = fa._plain_bwd_passes(q, k, v, dout, 0.125, out, lse)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_three_passes_match_the_jax_kernel(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, dout = _operands(7, 2, 256, 256)
    ref = jfa._flash_bwd_bh(*(jnp.asarray(t.numpy()) for t in (q, k, v,
                                                               dout)), 0.125)
    out, lse = fa._plain_bh(q, k, v, 0.125)
    got = fa._plain_bwd_passes(q, k, v, dout, 0.125, out, lse)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def _source_key_tiles():
    """{head_dim: keys a tile} as csrc/flash_attention.cu states them:
    ``tc_flash_key_tile``'s namespaces and their kBN."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    body = text[text.index('extern "C" int tc_flash_key_tile'):]
    tiles = {}
    for d, ns in re.findall(r"head_dim == (\d+) \? (\w+)::kBN", body):
        block = text[text.index(f"namespace {ns} {{"):]
        tiles[int(d)] = int(re.search(r"constexpr int kBN = (\d+);",
                                      block).group(1))
    return tiles


@pytest.mark.parametrize("d", [64, 512])
def test_key_tile_contract(d):
    """The kernel library reports each head dim's key tile from the
    kernel's own constant (``key_tile`` reads it; the references take it as
    ``_plain_bh_ones``'s block): 128 keys at d = 64, 64 at d = 512. A
    reference rounding at the key tile agrees with an online softmax over
    tiles of that many keys."""
    tile = _source_key_tiles()[d]
    assert tile == {64: 128, 512: 64}[d]
    q, k, v = (torch.from_numpy(np.random.default_rng(d + i).normal(
        size=(1, n, d)).astype(np.float32)).bfloat16().float()
        for i, n in enumerate((40, 300, 300)))
    scale = d ** -0.5
    s = q @ k.transpose(1, 2) * (scale * 1.4426950408889634)
    m = torch.full((1, 40), -float("inf"))
    l = torch.zeros(1, 40)
    acc = torch.zeros(1, 40, d)
    for n0 in range(0, 300, tile):
        t = s[..., n0:n0 + tile]
        mn = torch.maximum(m, t.amax(-1))
        p = torch.exp2(t - mn[..., None]).bfloat16().float()
        corr = torch.exp2(m - mn)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ v[:, n0:n0 + tile]
        m = mn
    out, lse = fa._plain_bh_ones(q, k, v, scale, cdt=torch.bfloat16,
                                 block=tile)
    torch.testing.assert_close(lse, (m + torch.log2(l)) * np.log(2), rtol=0,
                               atol=2e-6)
    torch.testing.assert_close(out.float(), acc / l[..., None], rtol=0,
                               atol=2e-6)
