"""The port's temporal conv under autograd (``_TconvFunction``: the
kernels, here the plain version, forward; the gradient of the unfused
XLA form ``_xla_tconv`` back) against ``jax.grad`` of the JAX package's
``temporal_conv3`` (its custom_vjp recomputes through ``_xla_tconv``): the
same numpy inputs and cotangents, gradients of x, the weight, the bias, the
folded GroupNorm affine (A, B), the residual and the out_scale, through y
and the per-frame sums.

Bound: in fp32 both differentiate the same formula and differ only in
summation order: 1e-4 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import temporal_conv as jtc
from tooncrafter_tpu_torch.ops import temporal_conv as tc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

B, T, H, W, CIN, COUT = 2, 4, 3, 5, 32, 48
REL = 1e-4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    return dict(x=f(B, T, H, W, CIN, sc=2.0, off=0.5),
                w=f(3, CIN, COUT, sc=(3 * CIN) ** -0.5), b=f(COUT, sc=0.1),
                a=f(B, CIN, sc=0.2, off=1.0), bb=f(B, CIN, sc=0.5),
                res=f(B, T, H, W, COUT), scale=np.float32(0.7),
                gy=f(B, T, H, W, COUT), g1=f(B, T, COUT), g2=f(B, T, COUT,
                                                             sc=0.1))


# (affine + SiLU, residual, out_scale, stats): the UNet's conv1-3 (sums for
# the next norm), its conv4 and the decoder's out_layers (residual and the
# alpha merge), and the plain conv (z = x)
CASES = {"prologue+stats": (True, False, False, True),
         "prologue+residual+scale+stats": (True, True, True, True),
         "residual+scale, no prologue": (False, True, True, False)}


def _jax_grads(p, prologue, res_on, scale_on, stats):
    names = ["x", "w", "b"] + (["a", "bb"] if prologue else []) + (
        ["res"] if res_on else []) + (["scale"] if scale_on else [])

    def loss(*args):
        v = dict(zip(names, args))
        out = jtc.temporal_conv3(
            v["x"], v["w"], v["b"],
            affine=(v["a"], v["bb"]) if prologue else None, silu=prologue,
            residual=v.get("res"), out_scale=v.get("scale"),
            return_stats=stats)
        y, s1, s2 = out if stats else (out, None, None)
        total = jnp.sum(y * p["gy"])
        if stats:
            total += jnp.sum(s1 * p["g1"]) + jnp.sum(s2 * p["g2"])
        return total
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(p[n]) for n in names))
    return {n: np.asarray(g, np.float32) for n, g in zip(names, grads)}


def _through_function(t):
    """Is the Function's backward node within a few steps of t's?"""
    fns = [t.grad_fn]
    for _ in range(3):
        if any(type(f).__name__ == "_TconvFunctionBackward" for f in fns):
            return True
        fns = [n for f in fns if f is not None
               for n, _ in f.next_functions]
    return False


def _port_grads(p, prologue, res_on, scale_on, stats):
    leaf = lambda v: torch.from_numpy(np.array(v)).requires_grad_()
    v = {"x": leaf(p["x"]),
         # JAX (3, Cin, Cout) -> nn.Conv3d (Cout, Cin, 3, 1, 1)
         "w": leaf(p["w"].transpose(2, 1, 0)[..., None, None]),
         "b": leaf(p["b"])}
    if prologue:
        v["a"], v["bb"] = leaf(p["a"]), leaf(p["bb"])
    if res_on:
        v["res"] = leaf(p["res"])
    if scale_on:
        v["scale"] = leaf(p["scale"])
    out = tc.temporal_conv3(
        v["x"], v["w"], v["b"], (v["a"], v["bb"]) if prologue else None,
        silu=prologue, residual=v.get("res"), out_scale=v.get("scale"),
        return_stats=stats)
    y, s1, s2 = out if stats else (out, None, None)
    assert _through_function(y)
    total = (y * torch.from_numpy(p["gy"])).sum()
    if stats:
        total = (total + (s1 * torch.from_numpy(p["g1"])).sum()
                 + (s2 * torch.from_numpy(p["g2"])).sum())
    total.backward()
    got = {n: t.grad.numpy() for n, t in v.items()}
    got["w"] = got["w"][..., 0, 0].transpose(2, 1, 0)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_backward_matches_jax_grad(case):
    p = _inputs(sorted(CASES).index(case))
    ref = _jax_grads(p, *CASES[case])
    got = _port_grads(p, *CASES[case])
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        err = np.abs(got[name] - ref[name]).max()
        assert err <= REL * np.abs(ref[name]).max(), (name, err)


def test_no_grad_takes_no_function():
    """Outside autograd the wrapper returns the plain (here) or kernel
    result directly, as in inference."""
    p = _inputs(9)
    with torch.no_grad():
        y = tc.temporal_conv3(torch.from_numpy(p["x"]),
                              torch.from_numpy(p["w"].transpose(2, 1, 0)
                                               [..., None, None].copy()),
                              torch.from_numpy(p["b"]))
    assert y.grad_fn is None and y.shape == (B, T, H, W, COUT)
