"""The port's GN+SiLU+3x3 conv under autograd (``_ConvFunction``: the
kernel, here the plain version, forward; the gradient of the XLA form
``_xla_conv3x3`` back) against ``jax.grad`` of the JAX package's
``gn_silu_conv3x3`` (its custom_vjp differentiates ``_xla_impl`` whichever
kernel ran): the same numpy inputs and cotangents, the gradients of x, the
folded GroupNorm affine (A, B), the weight, the bias and the residual,
through y and the per-channel sums.

Cases: the training branch's conv (no prologue: the port passes no affine
and the JAX ``SpatialConv3x3`` ones and zeros, ``silu`` off), the same
identity as tensors with a residual and the sums (A and B differentiated),
and the inference form (affine + SiLU + residual + sums).

Bound: in fp32 both differentiate the same formula and differ only in
summation order: 1e-4 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu_torch.ops import spatial_conv as sc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

N, H, W, CIN, COUT = 2, 6, 7, 32, 40
REL = 1e-4


def _inputs(seed, identity):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    p = dict(x=f(N, H, W, CIN, sc=2.0, off=0.5),
             w=f(3, 3, CIN, COUT, sc=(9 * CIN) ** -0.5), b=f(COUT, sc=0.1),
             a=f(N, CIN, sc=0.2, off=1.0), bb=f(N, CIN, sc=0.5),
             res=f(N, H, W, COUT), gy=f(N, H, W, COUT), g1=f(N, COUT),
             g2=f(N, COUT, sc=0.1))
    if identity:
        p["a"], p["bb"] = np.ones_like(p["a"]), np.zeros_like(p["bb"])
    return p


# (identity affine, port's affine given as tensors, SiLU, residual, sums)
CASES = {"training conv: no prologue, silu off": (True, False, False, False,
                                                  False),
         "identity tensors, silu off, residual, sums": (True, True, False,
                                                        True, True),
         "affine + SiLU + residual + sums": (False, True, True, True, True)}


def _loss_terms(y, s1, s2, p, xp):
    total = (y * xp.asarray(p["gy"])).sum()
    if s1 is not None:
        total = (total + (s1 * xp.asarray(p["g1"])).sum()
                 + (s2 * xp.asarray(p["g2"])).sum())
    return total


def _jax_grads(p, identity, tensors, silu, res_on, stats):
    names = ["x", "a", "bb", "w", "b"] + (["res"] if res_on else [])

    def loss(*args):
        v = dict(zip(names, args))
        out = jsc.gn_silu_conv3x3(v["x"], (v["a"], v["bb"]), v["w"], v["b"],
                                  residual=v.get("res"), silu=silu,
                                  return_stats=stats)
        y, s1, s2 = out if stats else (out, None, None)
        return _loss_terms(y, s1, s2, p, jnp)
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(p[n]) for n in names))
    out = {n: np.asarray(g, np.float32) for n, g in zip(names, grads)}
    if not tensors:  # the port has no affine to differentiate
        del out["a"], out["bb"]
    return out


def _through_function(t):
    fns = [t.grad_fn]
    for _ in range(3):
        if any(type(f).__name__ == "_ConvFunctionBackward" for f in fns):
            return True
        fns = [n for f in fns if f is not None
               for n, _ in f.next_functions]
    return False


def _port_grads(p, identity, tensors, silu, res_on, stats):
    leaf = lambda v: torch.from_numpy(np.array(v)).requires_grad_()
    # JAX HWIO (3, 3, Cin, Cout) -> nn.Conv2d (Cout, Cin, 3, 3)
    v = {"x": leaf(p["x"]), "w": leaf(p["w"].transpose(3, 2, 0, 1)),
         "b": leaf(p["b"])}
    if tensors:
        v["a"], v["bb"] = leaf(p["a"]), leaf(p["bb"])
    if res_on:
        v["res"] = leaf(p["res"])
    out = sc.winograd_gn_silu_conv3x3(
        v["x"], v.get("a"), v.get("bb"), v["w"], v["b"], v.get("res"),
        silu=silu, stats=stats)
    y, s1, s2 = out if stats else (out, None, None)
    assert _through_function(y)
    _loss_terms(y, s1, s2, p, torch).backward()
    got = {n: t.grad.numpy() for n, t in v.items()}
    got["w"] = got["w"].transpose(2, 3, 1, 0)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_backward_matches_jax_grad(case):
    p = _inputs(sorted(CASES).index(case), CASES[case][0])
    ref = _jax_grads(p, *CASES[case])
    got = _port_grads(p, *CASES[case])
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        err = np.abs(got[name] - ref[name]).max()
        assert err <= REL * np.abs(ref[name]).max(), (name, err)


def test_training_dispatch_without_affine():
    """``spatial_conv3x3`` with no affine at a shape no TPU kernel takes:
    the XLA form itself, differentiated by autograd, equal to the conv."""
    p = _inputs(7, True)
    conv = sc.Conv2d(CIN, COUT, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(p["w"].transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(p["b"]))
    x = torch.from_numpy(p["x"]).requires_grad_()
    y = sc.spatial_conv3x3(x, None, conv, silu=False)
    assert not _through_function(y)
    torch.testing.assert_close(y, conv(x), rtol=1e-5, atol=1e-5)
