"""The port's fused GEGLU feed-forward (plain version, CPU) against the JAX
package's Pallas kernels run in interpret mode, fp32, C = 64, D = 256; and
the CUDA wrapper's plan (tiles, grids, scratch) at the path's and the card
tests' shapes, and its refusal of shapes outside the kernels' envelope.

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
from tooncrafter_tpu_torch.utils import kernel_check as kc

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


# the card tests' odd shapes (tests/test_torch_cuda_kernels.py): N, C,
# Cout, LayerNorm
ODD = [(77, 320, 320, True), (333, 512, 512, True), (45, 1280, 1280, True),
       (77, 320, 320, False), (129, 640, 640, True), (100, 320, 192, True)]


def _check_gemm(g, n, cols, width):
    """A launchable tiling: every row and column covered, a persistent grid
    of at most one block an SM and at most one a tile."""
    assert g.rows in (64, 128) and g.width == width
    assert g.tiles == -(-n // g.rows) * -(-cols // width)
    assert g.grid == min(g.tiles, ff.H100_SMS) >= 1


@pytest.mark.parametrize("label,n,c", kc.FF_512 + kc.FF_1024)
def test_plan_fills_the_card_at_every_path_shape(label, n, c):
    p = ff.plan(n, c, 4 * c, c, True)
    _check_gemm(p.proj, n, 2 * 4 * c, 128)  # 64 h and 64 g columns a tile
    _check_gemm(p.out, n, c, 160 if c % 160 == 0 else 128)
    # every SM takes a tile: 128-row tiles unless they are fewer than SMs
    for g in (p.proj, p.out):
        assert g.tiles >= ff.H100_SMS and g.grid == ff.H100_SMS
        col_tiles = g.tiles // -(-n // g.rows)
        assert g.rows == 128 or -(-n // 128) * col_tiles < ff.H100_SMS


@pytest.mark.parametrize("n,c,cout,ln", ODD)
def test_plan_and_scratch_at_odd_shapes(n, c, cout, ln):
    d = 4 * c
    p = ff.plan(n, c, d, cout, ln)
    _check_gemm(p.proj, n, 2 * d, 128)
    _check_gemm(p.out, n, cout, 160 if cout % 160 == 0 else 128)
    z, m = ff.scratch(p, "cpu")
    assert m.shape == (n, d) and m.dtype == torch.bfloat16
    if ln:
        assert z.shape == (n, c) and z.dtype == torch.bfloat16
    else:
        assert z is None and p.z is None


def test_the_mid_block_takes_64_row_out_tiles():
    p = ff.plan(1280, 1280, 5120, 1280, True)
    assert (p.proj.rows, p.proj.tiles) == (128, 10 * 80)
    assert (p.out.rows, p.out.width, p.out.tiles) == (64, 160, 20 * 8)


@pytest.mark.parametrize("c,d,cout", [(48, 256, 64), (64, 200, 64),
                                      (64, 256, 36)])
def test_shapes_outside_the_envelope_raise_before_a_launch(monkeypatch, c, d,
                                                           cout):
    monkeypatch.setattr(ff._launch, "on_cpu", lambda *a: False)
    monkeypatch.setattr(ff, "_library", lambda: pytest.fail("launched"))
    bf = torch.bfloat16
    with pytest.raises(ValueError):
        ff.fused_geglu_ff(torch.zeros(40, c, dtype=bf),
                          torch.zeros(2 * d, c, dtype=bf),
                          torch.zeros(2 * d, dtype=bf),
                          torch.zeros(cout, d, dtype=bf),
                          torch.zeros(cout, dtype=bf))
    with pytest.raises(ValueError):
        ff.plan(40, c, d, cout, False)
    assert not any(ff.LAUNCHES.values())


def test_the_out_gemm_is_bound_by_the_bytes_of_m_only_at_c320():
    """``utils/breakdown``'s FF bounds: the projection by its operations,
    the out-GEMM by the bytes of m at C = 320 (C operations a byte of m),
    by its operations at C = 640 and 1280."""
    from tooncrafter_tpu_torch.utils import breakdown as bd

    for n, c in ((81920, 320), (20480, 640), (5120, 1280)):
        b = bd.ff_bounds(n, c, 4 * c)
        ops = {"proj": 4.0 * n * c * 4 * c, "out": 2.0 * n * 4 * c * c}
        assert b["proj"] == pytest.approx(ops["proj"] / kc.PEAK_BF16_FLOPS
                                          * 1e3)
        by_ops = b["out"] == pytest.approx(ops["out"] / kc.PEAK_BF16_FLOPS
                                           * 1e3)
        assert by_ops == (c > 320)
        assert b["ln"] == pytest.approx(
            (4.0 * n * c + 8 * c) / kc.PEAK_BYTES_PER_S * 1e3)
