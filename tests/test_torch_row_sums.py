"""The plans and the summation orders of the one-pass GroupNorm (#16, one
cluster launch a call, ``fused_norms.plan``) and the channel sums (#18, one
launch whose last block a sample folds the partials, ``stats.plan``), on
the CPU: the plans at every shape the switched 512 path launches #16 with
(read off the model on the meta device, as tests/test_torch_selectors_
switched.py walks it) and at every #18 shape of phase 2, and the kernels'
folds emulated in torch (tests/row_sums_order.py) against the plain
versions and the JAX package's Pallas kernels in interpret mode.

Bounds. #16 in bf16: the emulated order and the plain version (or the
interpret kernel) square x in bf16, sum in fp32 and round once, so they
differ where the two summation orders straddle a bf16 tie: 2^-7 of max
|out| anywhere, as tests/test_torch_fused_norms.py. #18: fp32 sums in
another order, 1e-5 of sum |x| (s1) or of sum x^2 (s2), as
tests/test_torch_stats.py.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import row_sums_order as order
from test_torch_selectors_switched import _moved, _switches, _walk
from tooncrafter_tpu.ops import fused_norms as jfn
from tooncrafter_tpu.ops import stats as jst
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import row_sums as rs
from tooncrafter_tpu_torch.ops import stats as st
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

GN_TOL = 2.0 ** -7
SUMS_REL = 1e-5


@pytest.fixture(scope="module")
def gn_sites():
    """(N, HW, C, silu) -> launches of #16: in one training UNet call, and
    in one UNet call, one per-frame encode and one decode in inference."""
    with pytest.MonkeyPatch.context() as mp:
        _switches(mp, jax_too=False)
        walked = _walk(mp)
    out = {}
    for part in ("train", "infer"):
        log = (walked["train"] if part == "train"
               else walked["unet"] + walked["vae"])
        seen = collections.Counter()
        for (shape, act, _, _), moved in _moved(log, "gn"):
            if moved == ["_pallas_gn"]:
                hw = int(np.prod(shape[1:-1]))
                seen[(shape[0], hw, shape[-1], act)] += 1
        out[part] = seen
    return out


def test_phase2_checks_16_at_every_site_the_switched_path_launches(gn_sites):
    """``kernel_check.GN_512`` is the switched path's #16 sites, with their
    launches in one training UNet forward; the encoder's norm_out is the
    one inference site (once an encoded frame)."""
    train = collections.Counter()
    for _, shape, silu, count in kc.GN_512:
        if count:
            train[shape + (silu,)] += count
    assert train == gn_sites["train"]
    infer = [shape + (silu,) for _, shape, silu, count in kc.GN_512
             if not count]
    assert collections.Counter(infer) == gn_sites["infer"]
    assert sum(train.values()) == 89


def _covers(rows: int, blocks: int, s: int) -> None:
    """Blocks of ``rows`` rows cover [0, s) once, none empty."""
    spans = [(b * rows, min(s, (b + 1) * rows)) for b in range(blocks)]
    assert all(lo < hi for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("row", kc.GN_512 + kc.GN_L2,
                         ids=[r[0] for r in kc.GN_512 + kc.GN_L2])
def test_gn_plan(row):
    """One cluster of k <= 16 blocks a sample, the grid N k; every row in
    one block; each slice in shared memory beside the partials, or else
    the L2 branch named (a ring streamed twice) where no cluster holds the
    sample (GN_L2's rows) or where a wave of resident slices at one
    block an SM would leave the card's memory idle."""
    label, (n, hw, c), _, _ = row
    p = fn.plan(n, hw, c)
    assert p.k in fn.CLUSTER_SIZES and p.k <= 16
    _covers(p.rows, p.k, hw)
    assert p.threads == c // 8 * p.rstep <= fn.MAX_THREADS
    assert p.stage_rows % p.rstep == 0 and p.slots <= rs.MAX_SLOTS
    assert p.smem <= rs.SMEM_BLOCK and p.per_sm >= 1
    assert p.resident == (p.slots * p.stage_rows >= p.rows)
    data = (p.rows if p.resident else p.slots * p.stage_rows) * 2 * c
    assert p.smem == fn.smem_bytes(c, 32, p.rstep, data)
    held = fn.smem_bytes(c, 32, p.rstep, p.rows * 2 * c)
    per_sm = rs.blocks_an_sm(held, p.threads)
    # resident where the slice fits two blocks an SM, or one where the
    # batch is one wave; else the L2 branch, always where no cluster
    # holds the sample (GN_L2)
    assert p.resident == (held <= rs.SMEM_BLOCK and (
        per_sm >= 2 or n <= fn.CLUSTERS_AT_ONE_AN_SM[p.k]))
    if row in kc.GN_L2:
        assert not p.resident
        assert fn.smem_bytes(c, 32, p.rstep, -(-hw // 16) * 2 * c) > \
            rs.SMEM_BLOCK
    if (n, hw, c) == (32, 2560, 320):
        # 102 KB slices, two blocks an SM: 512 blocks, about two waves
        assert (p.k, n * p.k, p.per_sm) == (16, 512, 2)


@pytest.mark.parametrize("row", kc.STATS_512, ids=[r[0] for r in
                                                   kc.STATS_512])
def test_sums_plan(row):
    """Chunks cover every row once, none empty; the grid (chunks, N) within
    CUDA's limits; the ring holds the row offsets' fold and the partials'
    stages; every thread folds at most 4 of the 2 C / 4 float4 partial
    columns."""
    _, (n, s, c), _ = row
    p = st.plan(n, s, c, 2)
    _covers(p.rows, p.chunks, s)
    assert p.chunks * n <= 4 * 132 and n <= 65535
    assert p.threads == c // 8 * p.rstep <= 1024
    assert p.stage_rows % p.rstep == 0
    data = p.slots * p.stage_rows * 2 * c
    assert p.smem == rs.BAR_BYTES + data <= rs.SMEM_BLOCK - 128
    assert 4 * p.rstep * c <= data
    assert p.fold_slots * p.fold_rows * 8 * c <= data and p.fold_slots >= 1
    assert c // 2 <= 4 * p.threads


def _gn_inputs(shape, seed):
    """bf16 x with a mean that ramps down the rows (kernel_check's
    gn_input), fp32 scale and bias."""
    rng = np.random.default_rng(seed)
    n, hw, c = shape
    x = (rng.normal(size=shape) * 2.0 + 0.5
         + np.linspace(-kc.GN_RAMP, kc.GN_RAMP, hw)[:, None])
    w = rng.normal(size=c) * 0.2 + 1.0
    b = rng.normal(size=c) * 0.2
    return (torch.from_numpy(x.astype(np.float32)).bfloat16(),
            torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def _gn_close(got, want):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=GN_TOL * np.abs(want).max())


# (N, H, W, C): a ragged last slice (63 rows over 4 blocks of 16), 120
# rows over 4 blocks of 30, and one 4 MiB sample, which takes the L2 branch
GN_SHAPES = [(3, 7, 9, 96), (2, 8, 15, 320), (1, 128, 128, 128)]


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_fold_matches_plain_and_the_interpret_kernel(monkeypatch, shape,
                                                        silu):
    monkeypatch.setattr(jfn, "_FUSED_GN", True)
    monkeypatch.setattr(jfn, "_INTERPRET", True)
    n, h, w, c = shape
    x, scale, bias = _gn_inputs((n, h * w, c), seed=c)
    p = fn.plan(n, h * w, c)
    assert p.resident == (shape != (1, 128, 128, 128))
    if shape == (3, 7, 9, 96):
        assert p.k * p.rows > h * w  # the last slice is short
    got = order.gn(x, scale, bias, 32, 1e-5, silu, p)
    _gn_close(got, fn._plain_gn(x, scale, bias, 32, 1e-5, silu))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).reshape(shape)
    want = jfn._pallas_gn(jx, jnp.asarray(scale.numpy()),
                          jnp.asarray(bias.numpy()), 32, 1e-5, silu)
    _gn_close(got, np.asarray(want.astype(jnp.float32)).reshape(
        n, h * w, c))


def test_gn_fold_is_the_plain_statistics_up_to_order():
    """The exchanged group sums against the plain sums in fp64: within
    summation-order error (1e-6 of sum |x| and of sum x^2)."""
    x, _, _ = _gn_inputs((2, 120, 320), seed=4)
    p = fn.plan(2, 120, 320)
    s1, s2 = order.gn_stats(x, 32, p)
    xd = x.double().reshape(2, 120, 32, 10)
    sq = (x * x).double().reshape(2, 120, 32, 10)
    np.testing.assert_array_less(
        (s1.double() - xd.sum((1, 3))).abs().numpy(),
        1e-6 * xd.abs().sum((1, 3)).numpy())
    np.testing.assert_array_less(
        (s2.double() - sq.sum((1, 3))).abs().numpy(),
        1e-6 * sq.sum((1, 3)).numpy())


def test_gn_fold_reading_rank_0_twice_fails_the_phase2_bounds():
    """The mutation the card tests build (the exchange reads rank 0's
    partials for rank 1's), emulated at the encoder norm_out's shape with
    phase 2's ramped input: off the bounds of ``error_bounds``."""
    x, scale, bias = _gn_inputs((1, 2560, 512), seed=9)
    p = fn.plan(1, 2560, 512)
    assert p.k > 1
    ref = fn._plain_gn(x.float(), scale, bias, 32, 1e-5, True,
                       cdt=torch.bfloat16)
    good = order.gn(x, scale, bias, 32, 1e-5, True, p)
    xs = x.clone()
    xs[:, p.rows:2 * p.rows] = x[:, :p.rows]  # rank 1 sums rank 0's rows
    s1, s2 = order.gn_stats(xs, 32, p)
    cnt = 2560.0 * 16
    mean = s1 / cnt
    inv = 1.0 / torch.sqrt((s2 / cnt - mean * mean).clamp_min(0) + 1e-5)
    a = inv.repeat_interleave(16, 1) * scale
    y = x.float() * a[:, None] + (bias - mean.repeat_interleave(16, 1)
                                  * a)[:, None]
    bad = (y * torch.sigmoid(y)).bfloat16()
    max_bound, mean_bound = fa.error_bounds(ref)
    err = (good.float() - ref).abs()
    assert err.max() <= max_bound and err.mean() <= mean_bound
    err = (bad.float() - ref).abs()
    assert err.max() > max_bound or err.mean() > mean_bound


def _sums_close(got, x):
    xf = x.double()
    for g, want, scale in zip(got, (xf.sum(1), xf.square().sum(1)),
                              (xf.abs().sum(1), xf.square().sum(1))):
        assert g.dtype == torch.float32
        np.testing.assert_array_less((g.double() - want).abs().numpy(),
                                     SUMS_REL * scale.numpy() + 1e-30)


# (N, S, C, dtype): 4 whole chunks; a ragged last chunk (264 = 4 x 53 +
# 52); fp32 columns of 4 values; ragged and outside the JAX kernel's tiles
SUMS_SHAPES = [(2, 256, 128, "bfloat16"), (2, 264, 128, "bfloat16"),
               (2, 512, 320, "float32"), (3, 300, 64, "float32")]


@pytest.mark.parametrize("n,s,c,dtype", SUMS_SHAPES)
def test_sums_fold_matches_plain_and_the_interpret_kernel(monkeypatch, n, s,
                                                          c, dtype):
    monkeypatch.setattr(jst, "_INTERPRET", True)
    x = torch.from_numpy(np.random.default_rng(s).normal(
        size=(n, s, c)).astype(np.float32) * 2 + 0.5).to(getattr(torch,
                                                               dtype))
    p = st.plan(n, s, c, x.element_size())
    assert p.chunks > 1
    got = order.channel_sums(x, p)
    _sums_close(got, x)
    plain = st._plain_sums(x)
    _sums_close(plain, x)
    if s % 8 == 0:
        jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
        want = [torch.from_numpy(np.array(w))
                for w in jst._pallas_sums(jx)]
        _sums_close(want, x)
        xf = x.double()
        for g, w, scale in zip(got, want, (xf.abs().sum(1),
                                           xf.square().sum(1))):
            np.testing.assert_array_less(
                (g.double() - w.double()).abs().numpy(),
                SUMS_REL * scale.numpy() + 1e-30)


def test_sums_fold_skipping_the_last_chunk_fails():
    """The card tests' mutation, emulated on phase 2's kind of input: the
    last chunk's partial left out of the fold puts the sums far (> 100x)
    past the bound of ``kernel_check._sums_row``."""
    x = (torch.randn(2, 2560, 320, generator=torch.Generator().manual_seed(0))
         * 2 + 0.5).bfloat16()
    p = st.plan(2, 2560, 320, 2)
    cut = order.channel_sums(x[:, :(p.chunks - 1) * p.rows], p._replace(
        chunks=p.chunks - 1))
    row = kc._sums_row(cut, kc.sums_reference(x))
    assert row["rel_err"] > 100 * kc.STATS_REL
    assert kc._sums_row(order.channel_sums(x, p), kc.sums_reference(x))["ok"]
