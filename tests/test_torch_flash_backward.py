"""The port's flash-attention backward (tooncrafter_tpu_torch) against the
JAX package's on the CPU, in fp32.

``_plain_bwd_bh``, the plain version of the CUDA backward kernel #6, is held
against the JAX package's ``_flash_bwd_bh`` run in Pallas interpret mode at
shapes its ``_pick_block`` tiles; the port's autograd Function (the forward
with its lse, then the backward) against ``jax.grad`` of the JAX
``flash_attention_packed`` and ``flash_attention``. Inputs come from numpy
with a seed. Bar: max |port - jax| <= 1e-4 of the reference's largest
magnitude (fp32 sums of 160-320 products in another order, dq and dk
from differences of such sums; the JAX side also recomputes its lse with
its own kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import flash_attention as jfa
from tooncrafter_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TOL = 1e-4


def _close(actual, expected, tol=TOL):
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape, (a.shape, e.shape)
    rel = float(np.abs(a - e).max()) / max(1e-6, float(np.abs(e).max()))
    assert rel <= tol, f"max rel err {rel:.3e} > {tol}"


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bh,sq,sk", [(2, 256, 256), (3, 320, 160)])
def test_plain_backward_matches_the_jax_kernel(monkeypatch, bh, sq, sk):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.default_rng(sq + sk)
    q, dout = _normal(rng, bh, sq, 64), _normal(rng, bh, sq, 64)
    k, v = _normal(rng, bh, sk, 64), _normal(rng, bh, sk, 64)
    ref = jfa._flash_bwd_bh(*(jnp.asarray(t) for t in (q, k, v, dout)),
                            0.125)
    got = fa._plain_bwd_bh(*(torch.from_numpy(t) for t in (q, k, v, dout)),
                           0.125)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    # the wrapper on CPU tensors is the plain version, with the forward's
    # out and lse given
    out, lse = fa._plain_bh(*(torch.from_numpy(t) for t in (q, k, v)), 0.125)
    again = fa._flash_bwd_bh(*(torch.from_numpy(t) for t in (q, k, v, dout)),
                             out, lse, 0.125)
    for g, r in zip(again, ref):
        _close(g.numpy(), r)
    assert fa.LAUNCHES["_flash_bwd_bh"] == 0


@pytest.mark.parametrize("s,c,heads", [(160, 128, 2), (512, 320, 5)])
def test_function_gradients_match_jax_packed(s, c, heads):
    """The packed entry: (B, S, 3C) -> (B, S, C), its gradient written as
    one (B, S, 3C) tensor; (512, 320) is the packed-direct envelope, (160,
    128) the token-major one."""
    rng = np.random.default_rng(s)
    qkv, g = _normal(rng, 2, s, 3 * c), _normal(rng, 2, s, c)

    def f(x):
        return jnp.sum(jfa.flash_attention_packed(x, heads) * g)
    ref = jax.grad(f)(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = fa.flash_attention_packed(x, heads)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    _close(got.numpy(), ref)


def test_function_gradients_match_jax_flash_attention():
    """(B, S, H, D) operands with Sq != Sk, through the JAX custom_vjp's
    reference backward on the CPU."""
    rng = np.random.default_rng(7)
    q, g = _normal(rng, 1, 192, 2, 64), _normal(rng, 1, 192, 2, 64)
    k, v = _normal(rng, 1, 320, 2, 64), _normal(rng, 1, 320, 2, 64)

    def f(*a):
        return jnp.sum(jfa.flash_attention(*a) * g)
    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*ts), ts, torch.from_numpy(g))
    for a, r in zip(got, ref):
        _close(a.numpy(), r)
