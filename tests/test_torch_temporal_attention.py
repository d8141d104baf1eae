"""The port's temporal attention pair (plain version, CPU) against the JAX
package's Pallas kernel ``_fused_tpair_call`` in interpret mode: two stages
of LayerNorm -> q, k, v -> attention over T per pixel -> out-projection ->
residual, C = 128 (two heads of 64), at T = 16 (where the TPU kernel packs
eight pixels into a 128-row block behind a block-diagonal mask) and T = 4.

Bounds: in fp32 the two differ only in summation order, 1e-5 of max |out|.
In bf16 both round z, q, k, v, the probabilities, o, the out-GEMM, + bo
and + x at the same points; a rounding that flips between the two
summation orders moves an intermediate by one bf16 ulp, which the later
products carry on: 2 ulps of max |out| anywhere and 2 % of the elements
off at all, against the JAX package's single-stage kernel (the same
``_attn_stage``) called once per stage. The interpret-mode pair kernel
itself differs from those two calls at ~29 % of the elements (each of its
stages alone matches the single-stage kernel exactly; the chained run on
the CPU rounds differently), so against it the bound is 2 ulps anywhere and
a mean error of half an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu_torch.models.unet import BasicTransformerBlock
from tooncrafter_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

B, P, C, HEADS = 2, 16, 128, 2


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    stage = lambda: dict(lnw=f(C, sc=0.1, off=1.0), lnb=f(C, sc=0.1),
                         wq=f(C, C, sc=C ** -0.5), wk=f(C, C, sc=C ** -0.5),
                         wv=f(C, C, sc=C ** -0.5), wo=f(C, C, sc=C ** -0.5),
                         bo=f(C, sc=0.1))
    # x in the TPU kernel's (B, P, T, C) layout; weights (in, out)
    return dict(x=f(B, P, t, C, sc=2.0, off=0.5), stages=(stage(), stage()))


def _jax(p, dtype):
    stages = []
    for s in p["stages"]:
        wqkv = jnp.concatenate([s["wq"], s["wk"], s["wv"]], axis=1)
        stages.append((jnp.asarray(s["lnw"]), jnp.asarray(s["lnb"]),
                       wqkv.astype(dtype), jnp.asarray(s["wo"]).astype(dtype),
                       jnp.asarray(s["bo"]).astype(dtype)))
    out = jta._fused_tpair_call(jnp.asarray(p["x"]).astype(dtype), *stages,
                                HEADS, 0.125, 1e-5)
    return np.asarray(out, np.float32)


def _port(p, dtype):
    # (B, P, T, C) -> the port's (B, T, P, C); weights to torch's (out, in)
    x = torch.from_numpy(p["x"]).transpose(1, 2).contiguous().to(dtype)
    stages = [(torch.from_numpy(s["lnw"]), torch.from_numpy(s["lnb"]),
               *(torch.from_numpy(s[k]).T.contiguous().to(dtype)
                 for k in ("wq", "wk", "wv", "wo")),
               torch.from_numpy(s["bo"]).to(dtype)) for s in p["stages"]]
    out = ta._fused_tpair_call(x, *stages, HEADS, 0.125)
    assert out.dtype == dtype
    return out.float().transpose(1, 2).numpy()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jta, "_INTERPRET", True)


@pytest.mark.parametrize("t", [16, 4])
def test_plain_matches_the_interpret_kernel_fp32(interpret, t):
    p = _inputs(t, seed=t)
    got, want = _port(p, torch.float32), _jax(p, jnp.float32)
    assert got.shape == want.shape == (B, P, t, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def test_plain_matches_the_interpret_kernel_bf16(interpret):
    p = _inputs(16, seed=3)
    got, want = _port(p, torch.bfloat16), _jax(p, jnp.bfloat16)
    diff = np.abs(got - want)
    assert diff.max() <= 2 * _ulp(want), (diff.max(), _ulp(want))
    assert diff.mean() <= 0.5 * _ulp(want), (diff.mean(), _ulp(want))


def test_rounding_points_match_the_stage_kernel_bf16(interpret):
    """The rounding points of the TPU kernel's ``_attn_stage`` in bf16,
    through the JAX package's single-stage kernel once per stage."""
    p = _inputs(16, seed=3)
    y = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    for s in p["stages"]:
        wqkv = jnp.concatenate([s["wq"], s["wk"], s["wv"]], axis=1)
        y = jta._fused_tattn_call(
            y, jnp.asarray(s["lnw"]), jnp.asarray(s["lnb"]),
            wqkv.astype(jnp.bfloat16), jnp.asarray(s["wo"]).astype(
                jnp.bfloat16), jnp.asarray(s["bo"]).astype(jnp.bfloat16),
            HEADS, 0.125, 1e-5)
    want = np.asarray(y, np.float32)
    diff = np.abs(_port(p, torch.bfloat16) - want)
    assert diff.max() <= 2 * _ulp(want), (diff.max(), _ulp(want))
    assert (diff > 0).mean() <= 0.02, (diff > 0).mean()


def test_block_pair_matches_its_unfused_sub_blocks():
    """BasicTransformerBlock on (B, T, H, W, C) in eval mode (the pair) ==
    its sub-modules called one by one (the unfused branch's chain)."""
    torch.manual_seed(0)
    blk = BasicTransformerBlock(C, HEADS, 64, None, cross=False).eval()
    for p_ in blk.parameters():  # non-trivial norms and biases
        p_.data += 0.1 * torch.randn_like(p_)
    x = torch.randn(2, 4, 3, 5, C)
    with torch.no_grad():
        got = blk(x)
        h = blk.attn1(blk.norm1(x)) + x
        h = blk.attn2(blk.norm2(h)) + h
        want = blk.ff(blk.norm3(h)) + h
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_covers_the_path_shapes():
    for c in (320, 512, 640, 1280):       # the UNet's temporal blocks
        assert ta.covers(16, 64, c)
    assert ta.covers(4, 64, 320) and ta.covers(1, 64, 64)
    assert not ta.covers(5, 64, 320)      # T must divide 16
    assert not ta.covers(16, 32, 64)      # 64-wide heads only
    assert not ta.covers(16, 64, 1344)    # shared memory


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(ta, "_plain_tpair", lambda *a, **k: called.append(1))
    monkeypatch.setattr(ta._launch, "on_cpu", lambda *a: False)
    monkeypatch.setattr(ta, "_library", lambda: (_ for _ in ()).throw(
        FileNotFoundError("nvcc not found")))
    bf = torch.bfloat16
    x = torch.zeros(1, 16, 2, 64, dtype=bf)
    stage = (torch.ones(64), torch.zeros(64),
             *(torch.zeros(64, 64, dtype=bf) for _ in range(4)),
             torch.zeros(64, dtype=bf))
    with pytest.raises((FileNotFoundError, ValueError)):
        ta._fused_tpair_call(x, stage, stage, 1, 0.125)
    assert not called


@pytest.mark.parametrize("t,p,heads,d,want", [
    (16, 64, 2, 32, "plain"),    # the tiny config: the JAX package's XLA
    (16, 64, 2, 128, "pair"),    # Pallas pair at 128-wide heads
    (20, 64, 2, 64, "pair"),     # Pallas pair at T = 20
    (16, 64, 2, 64, "pair"),     # the shipped configs' heads
])
def test_temporal_transformer_route_follows_the_jax_rule(
        interpret, monkeypatch, t, p, heads, d, want):
    """``TemporalTransformer.route`` takes the pair wherever the JAX package
    runs its Pallas pair kernel, whether or not the CUDA kernel takes the
    shape (then it raises on the card, never runs plain PyTorch in the
    kernel's place); the plain chain only where the JAX package runs XLA
    and the CUDA pair does not cover the shape."""
    from tooncrafter_tpu_torch.models.unet import TemporalTransformer

    c = heads * d
    tt = TemporalTransformer(c, heads, d, depth=1)
    assert tt.route(t, p) == want
    assert jta.use_pair_kernel(t, p, d, c, c) == (want == "pair")
    if want == "pair" and not ta.covers(t, d, c):
        monkeypatch.setattr(ta._launch, "on_cpu", lambda *a: False)
        x = torch.zeros(1, t, 8, 8, c)
        with pytest.raises(ValueError, match="temporal attention kernels"):
            tt.transformer_blocks[0].temporal_pair(x)
