"""The port's one-pass GroupNorm (+SiLU) (ops/fused_norms.py, #16) against
the JAX package's Pallas kernel ``_pallas_gn`` in interpret mode, its
gradients against the JAX custom_vjp, and the dispatch rule's 4 MiB edge.

Bounds: in fp32 the plain version and the interpret kernel differ only in
summation order: 2e-5 of max |out|. In bf16 both square x in bf16, sum in
fp32 and round the output once, so a rounding flips only where the two
summation orders straddle a bf16 tie: 2^-7 of max |out| anywhere (one bf16
ulp at the top of max |out|'s binade). The gradients are the same formula
on both sides (the norm + SiLU in fp32): 1e-5 of max |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import fused_norms as jfn
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import norms

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfn, "_FUSED_GN", True)
    monkeypatch.setattr(jfn, "_INTERPRET", True)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    w = (rng.normal(size=shape[-1]) * 0.2 + 1.0).astype(np.float32)
    b = (rng.normal(size=shape[-1]) * 0.2).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 320), (1, 4, 6, 6, 64)])
def test_plain_matches_the_interpret_kernel(interpret, shape, dtype, silu):
    x, w, b = _inputs(shape, seed=len(shape))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfn._pallas_gn(jnp.asarray(x).astype(jdt),
                                     jnp.asarray(w), jnp.asarray(b), 32,
                                     1e-5, silu).astype(jnp.float32))
    got = fn._pallas_gn(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                        torch.from_numpy(b), 32, 1e-5, silu)
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("silu", [True, False])
def test_gradients_match_the_jax_custom_vjp(interpret, silu):
    x, w, b = _inputs((2, 4, 4, 128), seed=7)
    gy = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def loss(x_, w_, b_):
        return jnp.sum(jfn.group_norm_silu(x_, w_, b_, 32, 1e-5, silu)
                       * jnp.asarray(gy))
    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = fn._pallas_gn(*ts, 32, 1e-5, silu)
    y.backward(torch.from_numpy(gy))
    for t, e in zip(ts, want):
        e = np.asarray(e)
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=0,
                                   atol=1e-5 * np.abs(e).max())


def test_dispatch_rule_at_the_4_mib_edge(monkeypatch):
    """One sample of exactly 4 MiB takes the kernel, one element more does
    not; the switch off, nothing does; the JAX rule agrees."""
    monkeypatch.setattr(fn, "_FUSED_GN", True)
    at = torch.empty(2, 1024, 1024, 2, dtype=torch.bfloat16, device="meta")
    over = torch.empty(2, 1024, 1025, 2, dtype=torch.bfloat16,
                       device="meta")
    assert fn.sample_bytes(at) == jfn._MAX_VMEM_SAMPLE_BYTES
    assert fn.use_kernel(at) and not fn.use_kernel(over)
    # fp32 on the CPU: the same rule in that dtype's bytes
    assert not fn.use_kernel(at.float())
    monkeypatch.setattr(fn, "_FUSED_GN", False)
    assert not fn.use_kernel(at)


def test_group_norm_silu_routes_by_the_rule(monkeypatch):
    """With the switch on, a small sample goes through the wrapper (its
    rounding: the SiLU in fp32, one rounding); with it off, through
    ``norms.group_norm`` unchanged."""
    x, w, b = _inputs((2, 6, 6, 64), seed=3)
    xt = torch.from_numpy(x).bfloat16()
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    plain = norms.group_norm(xt, wt, bt, 32, 1e-5, True)
    monkeypatch.setattr(fn, "_FUSED_GN", False)
    assert torch.equal(fn.group_norm_silu(xt, wt, bt, 32, 1e-5), plain)
    monkeypatch.setattr(fn, "_FUSED_GN", True)
    got = fn.group_norm_silu(xt, wt, bt, 32, 1e-5)
    assert torch.equal(got, fn._plain_gn(xt, wt, bt, 32, 1e-5, True))
    gn = norms.GroupNorm(64, 1e-5, act=True)
    with torch.no_grad():
        gn.weight.copy_(wt)
        gn.bias.copy_(bt)
        assert torch.equal(gn(xt), got)
        # with producer sums: their folded affine, no statistics of x
        chained = gn(xt, stats=norms.channel_sums(xt))
        assert (chained.float() - plain.float()).abs().max() <= (
            2.0 ** -7 * plain.float().abs().max())
        gn.one_pass = False
        assert torch.equal(gn(xt), plain)
