"""The port's dual cross-attention (ops/cross_attention.py, #17) against the
JAX package's ``_dual_kernel_call`` in Pallas interpret mode, its off route
against ``_xla_dual``, the gradients in all six inputs against ``jax.grad``
of the JAX ``dual_cross_attention``, the envelope against the JAX rule, and
the cast point (one rounding after the combine).

Bounds: fp32 at 3e-5, as tests/test_cross_attention.py holds the kernel to
XLA (summation order; exp2 against exp). bf16 inputs: both sides round p
for the product and the output once, so only a rounding that the two
summation orders straddle moves, by one bf16 ulp: 2^-7 of max |out|.
Gradients: 1e-5 as the JAX test (the same two-attention formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu.ops import cross_attention as jca
from tooncrafter_tpu_torch.ops import cross_attention as ca
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six


@pytest.fixture(autouse=True)
def _counts():
    ca.reset_launch_counts()
    yield
    assert ca.LAUNCHES["_dual_kernel_call"] == 0  # the CPU runs no kernel


def _mats(seed, b=2, sq=512, lt=77, li=16, c=128):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32)
            for n in (sq, lt, lt, li, li)]


def _jax_kernel(mats, s_ip, heads, dtype="float32"):
    c = mats[0].shape[-1]
    old = jca._INTERPRET
    jca._INTERPRET = True
    try:
        out = jca._dual_kernel_call(
            *(jnp.asarray(m).astype(getattr(jnp, dtype)) for m in mats),
            jnp.full((1, 1), s_ip, jnp.float32), heads, (c // heads) ** -0.5,
            jca._pick_blk(mats[0].shape[1]))
    finally:
        jca._INTERPRET = old
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 3e-5),
                                        ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("sq,c,heads", [(512, 128, 2), (640, 320, 5)])
def test_plain_matches_the_interpret_kernel(sq, c, heads, dtype, atol):
    mats = _mats(0, sq=sq, c=c)
    ref = _jax_kernel(mats, 0.73, heads, dtype)
    tdt = getattr(torch, dtype)
    got = ca._dual_kernel_call(*(torch.from_numpy(m).to(tdt) for m in mats),
                               0.73, heads, (c // heads) ** -0.5)
    assert got.dtype == tdt and tuple(got.shape) == (2, sq, c)
    scale = np.abs(ref).max() if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=atol * scale)


def test_off_route_matches_xla_dual():
    mats = _mats(1, sq=256, c=128)
    ref = np.asarray(jca._xla_dual(*(jnp.asarray(m) for m in mats),
                                   jnp.float32(0.3), 2, None))
    got = ca.dual_cross_attention(*(torch.from_numpy(m) for m in mats),
                                  torch.tensor(0.3), 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("through", ["function", "entry"])
def test_gradients_match_jax_grad(through):
    """All six inputs, s_ip among them (the learnable gate): the autograd
    Function of the kernel wrapper, and the entry's two-attention route."""
    mats = _mats(2, sq=256, li=32)
    g = np.random.default_rng(3).normal(size=mats[0].shape).astype(np.float32)

    def loss(q, kt, vt, ki, vi, s):
        return jnp.sum(jca.dual_cross_attention(q, kt, vt, ki, vi, s, 2,
                                                None) * jnp.asarray(g))
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(m) for m in mats), jnp.float32(0.3))
    ts = [torch.from_numpy(m).requires_grad_() for m in mats]
    s = torch.tensor(0.3, requires_grad=True)
    if through == "function":
        out = ca._dual_kernel_call(*ts, s, 2, 64 ** -0.5)
        assert out.grad_fn is not None
        assert type(out.grad_fn).__name__.startswith("_DualFunction")
    else:
        out = ca.dual_cross_attention(*ts, s, 2)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts + [s], want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sq,lt,li,c,heads", [
    (2560, 77, 16, 320, 5), (640, 77, 16, 640, 10), (160, 77, 16, 1280, 20),
    (512, 77, 16, 128, 2), (512, 77, 16, 128, 4), (513, 77, 16, 128, 2),
    (512, 2000, 16, 128, 2), (512, 77, 1025, 128, 2), (40, 77, 16, 1280, 20),
    (384, 1024, 1024, 192, 3)])
def test_envelope_equals_the_jax_rule(monkeypatch, sq, lt, li, c, heads):
    assert ca._pick_blk(sq) == jca._pick_blk(sq)
    for switch in (True, False):
        monkeypatch.setattr(ca, "_DUAL_CROSS_PALLAS", switch)
        monkeypatch.setattr(jca, "_DUAL_CROSS_PALLAS", switch)
        for cuda in (True, False):
            monkeypatch.setattr(_dispatch, "on_tpu", lambda v=cuda: v)
            assert (ca.use_kernel(sq, lt, li, c, heads, cuda)
                    == jca.use_kernel(sq, lt, li, c, heads))


def test_entry_takes_the_kernel_only_on_cuda_with_the_switch(monkeypatch):
    calls = []
    monkeypatch.setattr(ca, "_dual_kernel_call",
                        lambda *a: calls.append(a) or ca._plain_dual(*a))
    mats = [torch.from_numpy(m) for m in _mats(4, sq=256)]
    off = ca.dual_cross_attention(*mats, 0.5, 2)
    monkeypatch.setattr(ca, "_DUAL_CROSS_PALLAS", True)
    ca.dual_cross_attention(*mats, 0.5, 2)      # on the CPU: the off route
    assert not calls
    monkeypatch.setattr(ca._launch, "is_cuda", lambda t: True)
    on = ca.dual_cross_attention(*mats, 0.5, 2)
    assert len(calls) == 1 and calls[0][6:] == (2, 0.125)
    torch.testing.assert_close(on, off, rtol=3e-5, atol=3e-5)


def test_one_rounding_after_the_combine():
    """The cast point (kernel_check.dual_pin_inputs), bit for bit."""
    mats, s_ip, heads = kc.dual_pin_inputs()
    ref = _jax_kernel(mats, s_ip, heads, "bfloat16")
    got = ca._dual_kernel_call(*(torch.from_numpy(m).bfloat16() for m in mats),
                               s_ip, heads, 0.125)
    assert np.array_equal(got.float().numpy(), ref)
    # the same through the fp32 plain version, rounded once
    exact = ca._plain_dual(*(torch.from_numpy(m) for m in mats), s_ip, heads,
                           0.125)
    assert np.array_equal(exact.bfloat16().float().numpy(), ref)
    # teeth: each branch rounded before the add moves many outputs
    q, kt, vt, ki, vi = (torch.from_numpy(m) for m in mats)

    def branch(k, v):  # one attention alone (s_ip 0 drops the other)
        return ca._plain_dual(q, k, v, k, v, 0.0, heads, 0.125)
    per_branch = (branch(kt, vt).bfloat16()
                  + (s_ip * branch(ki, vi)).bfloat16())
    moved = (per_branch.float().numpy() != ref).mean()
    print(f"#17 cast point: rounding each branch first moves {moved:.2%}")
    assert moved > 0.05, moved
