"""The port's fused GEGLU feed-forward (plain version, CPU) against the JAX
package's Pallas kernels run in interpret mode, fp32, C = 64, D = 256.

Bound. The TPU kernel's gate uses a degree-15 erf polynomial, |erf error|
<= 8.1e-5 on [-3, 3], and clamps beyond (1 - erf(3) = 2.2e-5): ERF_ERR.
gelu(g) = g (1 + erf(g / sqrt 2)) / 2 then differs by at most |g| ERF_ERR
/ 2, the gated product m = h gelu(g) by |h g| ERF_ERR / 2, and output
column j by sum_k |h_k g_k| |w2_kj| ERF_ERR / 2, computed from the inputs
(``_gate_bound``). On top, 1e-5 of max |out| for fp32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.ops import fused_ff as jff
from tooncrafter_tpu_torch.ops import fused_ff as ff

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

ERF_ERR = 8.1e-5 + 2.2e-5
C, D = 64, 256


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(x=f(n, C), w1=f(C, 2 * D, sc=C ** -0.5), b1=f(2 * D, sc=0.1),
                w2=f(D, C, sc=D ** -0.5), b2=f(C, sc=0.1),
                lw=1 + f(C, sc=0.1), lb=f(C, sc=0.1))


def _gate_bound(p, ln):
    x = p["x"].astype(np.float64)
    if ln:
        mu = x.mean(-1, keepdims=True)
        x = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + 1e-5) * p["lw"] \
            + p["lb"]
    a = x @ p["w1"] + p["b1"]
    h, g = a[:, :D], a[:, D:]
    return 0.5 * ERF_ERR * (np.abs(h * g) @ np.abs(p["w2"])).max()


def _port(p, ln, residual):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    # torch's Linear layout: w1 (2D, C), w2 (C, D)
    return ff.fused_geglu_ff(t["x"], t["w1"].T.contiguous(), t["b1"],
                             t["w2"].T.contiguous(), t["b2"],
                             t["lw"] if ln else None, t["lb"] if ln else None,
                             1e-5, residual).numpy()


def _jax(p, ln, residual):
    j = {k: jnp.asarray(v) for k, v in p.items()}
    return np.asarray(jff.fused_geglu_ff(
        j["x"], j["w1"], j["b1"], j["w2"], j["b2"],
        j["lw"] if ln else None, j["lb"] if ln else None, 1e-5, residual))


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("ln,residual", [(False, False), (True, False),
                                         (True, True)])
def test_plain_matches_the_interpret_kernel(monkeypatch, mode, ln, residual):
    monkeypatch.setattr(jff, "_INTERPRET", True)
    n = 256
    if mode == "streamed":
        # no resident tile: the TPU package streams the weight chunks
        monkeypatch.setattr(jff, "_pick_tile", lambda n, c, d, budget=0: 0)
        n = 512  # the streamed kernel's smallest token tile
    assert jff._mode(n, C, D, C) == mode
    p = _inputs(n, seed=2 * ln + residual)
    got, want = _port(p, ln, residual), _jax(p, ln, residual)
    err = np.abs(got - want).max()
    assert err <= _gate_bound(p, ln) + 1e-5 * np.abs(want).max(), err


def test_kernel_name_follows_the_tpu_dispatch():
    # the path's shapes: 2 CFG branches x 16 frames
    assert ff.kernel_name(81920, 320, 1280, 320) == "_pallas_ff"
    assert ff.kernel_name(20480, 640, 2560, 640) == "_pallas_ff"
    assert ff.kernel_name(5120, 1280, 5120, 1280) == "_pallas_ff_streamed"
    assert ff.kernel_name(1280, 1280, 5120, 1280) == "_pallas_ff_streamed"
    assert ff.kernel_name(81920, 512, 2048, 512) == "_pallas_ff_streamed"
    for args in ((81920, 320, 1280, 320), (5120, 1280, 5120, 1280),
                 (81920, 512, 2048, 512), (100, 64, 256, 64)):
        assert ff._mode(*args) == jff._mode(*args), args


def test_rounding_points_in_bf16():
    """bf16 operands: the gated product m rounds to bf16 before the
    out-GEMM, the out-GEMM, + b2 and + x each round once more."""
    p = _inputs(64, seed=5)
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    w1, w2 = t["w1"].T.contiguous(), t["w2"].T.contiguous()
    got = ff.fused_geglu_ff(t["x"], w1, t["b1"], w2, t["b2"])
    a = t["x"].float() @ w1.float().T + t["b1"].float()
    m = (a[:, :D] * torch.nn.functional.gelu(a[:, D:])).to(torch.bfloat16)
    want = (m.float() @ w2.float().T).to(torch.bfloat16) + t["b2"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(ff, "_plain_ff", lambda *a, **k: called.append(1))
    monkeypatch.setattr(ff._launch, "on_cpu", lambda *a: False)
    monkeypatch.setattr(ff, "_library", lambda: (_ for _ in ()).throw(
        FileNotFoundError("nvcc not found")))
    x = torch.zeros(32, C, dtype=torch.bfloat16)
    w1 = torch.zeros(2 * D, C, dtype=torch.bfloat16)
    with pytest.raises((FileNotFoundError, ValueError)):
        ff.fused_geglu_ff(x, w1, torch.zeros(2 * D, dtype=torch.bfloat16),
                          torch.zeros(C, D, dtype=torch.bfloat16),
                          torch.zeros(C, dtype=torch.bfloat16))
    assert not called
