"""The port's CUDA kernels against their plain versions, on the card:
small shapes with ragged edges (lengths and pixel counts that are not
multiples of the kernels' tiles, odd token counts, Cin != Cout), the strided
packed/token-major attention views, and a mutation check of the fused
kernels' bounds: broken builds of each source (output x1.01, a skipped K
chunk, wrong sums where the kernel has sums) must fail at every path shape
of ``kernel_check`` (the conv's also at the 576x1024 F(2x4)-named shape).
The 576x1024 path's new shapes: attn1 at S = 9216, 2304 and 576 (each at
the UNet's 32 images, through the wrapper the UNet picks), the pair at
P = 144 and 9216, and the F(2x4)-named conv (#14). The d = 512 forward
(#4, and #3 past the single-pass cap) at the VAE mid attention's shapes
(one head at 2560 and 9216 tokens, the encoder's one frame and the
decoder's 16) and at ragged lengths, and against two broken builds (a K/V
tile skipped, output x1.01). The flash-attention backward (#6) is held to
its gradient bounds at the training path's attn1 shapes, ragged and short
lengths, and against three broken builds (dq x1.01, a query tile skipped
in dk/dv, the dq of one key block dropped); every wrapper given a tensor
that requires grad either returns a result with a grad_fn or raises. The
kernels of the JAX package's opt-in switches (#10 the single-stage
temporal attention, #11 the T-attention core, #15 the im2col-named conv
with its fp32 cast point, #16 the one-pass GroupNorm) at ragged shapes,
and each against one broken build that must fail at every one of its
``kernel_check.switched_cases`` shapes; #15's cast point through an
identity conv, and against a build that takes #13's. The CUDA kernels of
the op functions no model reaches (#17 the dual cross-attention,
#18 the per-channel sums, #5 the ones-column flash) at ragged and strided
shapes, at every ``kernel_check.op_cases`` shape, and each one's cast point
against a build that takes the other rounding. The CUDA
kernels have no CPU mode, so without a card these tests skip.

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -s
"""

import functools
import shutil

import numpy as np
import pytest
import torch

from tooncrafter_tpu_torch.ops import _build
from tooncrafter_tpu_torch.ops import attention as attn
from tooncrafter_tpu_torch.ops import cross_attention as ca
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import stats as st
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops import temporal_conv as tc
from tooncrafter_tpu_torch.utils import kernel_check as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kc.reset_launch_counts()
    with kc.fp32_reference():
        yield torch.device("cuda", 0)


def _rand(dev, seed, *shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)


def _f(*ts):
    return [t.float() for t in ts]


def _close(out, ref):
    """bf16 kernel output against the fp32 plain version, within the bounds
    that ``error_bounds`` scales to the reference."""
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    max_bound, mean_bound = fa.error_bounds(ref)
    assert err.max().item() <= max_bound, (err.max().item(), max_bound)
    assert err.mean().item() <= mean_bound, (err.mean().item(), mean_bound)


def test_packed_kernel(dev):
    qkv = _rand(dev, 0, 2, 512, 960)
    out = fa._flash_mh_packed(qkv, 5, 0.125)
    ref = fa._plain_mh(*_f(qkv[..., :320], qkv[..., 320:640], qkv[..., 640:]),
                       5, 0.125)
    _close(out, ref)
    assert fa.LAUNCHES["_flash_mh_packed"] == 1


@pytest.mark.parametrize("sq,sk", [(200, 200), (160, 97)])
def test_mh_kernel_ragged_and_strided(dev, sq, sk):
    q = _rand(dev, 1, 2, sq, 3 * 128)[..., :128]      # a strided view
    k, v = _rand(dev, 2, 2, sk, 128), _rand(dev, 3, 2, sk, 128)
    out = fa._flash_mh(q, k, v, 2, 0.125)
    _close(out, fa._plain_mh(*_f(q, k, v), 2, 0.125))
    assert fa.LAUNCHES["_flash_mh"] == 1


@pytest.mark.parametrize("d,sq,sk", [(64, 333, 4500), (512, 300, 700),
                                     (64, 64, 1)])
def test_bh_kernels_with_lse(dev, d, sq, sk):
    q, k, v = (_rand(dev, 4 + i, 3, s, d) for i, s in enumerate((sq, sk,
                                                                  sk)))
    sc = d ** -0.5
    out, lse = fa._flash_bh_with_lse(q, k, v, sc)
    ref, ref_lse = fa._plain_bh_ones(*_f(q, k, v), sc, cdt=torch.bfloat16,
                                     block=fa.key_tile(d))
    _close(out, ref)
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= fa.LSE_MAX_ABS
    assert sum(fa.LAUNCHES.values()) == 1


def test_mh_kernel_at_1024_ds1(dev):
    """attn1 of the 576x1024 model at ds1: S = 9216 is past the packed
    kernel's S <= 4096, so the packed projection goes to the token-major
    kernel on its slices."""
    qkv = _rand(dev, 8, 2, 9216, 960)
    out = fa.flash_attention_packed(qkv, 5)
    ref = fa._plain_mh(*_f(qkv[..., :320], qkv[..., 320:640], qkv[..., 640:]),
                       5, 0.125)
    _close(out, ref)
    assert fa.LAUNCHES["_flash_mh"] == 1
    assert fa.LAUNCHES["_flash_mh_packed"] == 0


@pytest.mark.parametrize("s,c,heads,name", [
    (2304, 640, 10, "_flash_mh"), (576, 1280, 20, "_flash_bh_with_lse")])
def test_attn1_at_1024_ds2_and_ds4(dev, s, c, heads, name):
    """attn1 of the 576x1024 model at ds2 (2304 % 640 != 0: the token-major
    kernel) and ds4 (S = 576: no packed block, so the head-split view goes
    to the two-pass kernel), at the UNet's 32 images: a grid of 320 and 640
    batch x heads."""
    qkv = _rand(dev, 10, 32, s, 3 * c)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    if fa.use_packed_kernel(s, c, heads):
        out = fa.flash_attention_packed(qkv, heads)
    else:
        out = attn.attention(q, k, v, heads=heads)
    plain = (fa._plain_mh if name == "_flash_mh" else functools.partial(
        fa._plain_mh_ones, cdt=torch.bfloat16, block=fa.key_tile(64)))
    _close(out, plain(*_f(q, k, v), heads, 0.125))
    assert fa.LAUNCHES[name] == 1
    assert sum(fa.LAUNCHES.values()) == 1


def test_flash_attention_entry_counts_one_launch(dev):
    q = _rand(dev, 9, 1, 2560, 1, 512)
    out = fa.flash_attention(q, q, q)
    q3 = q[:, :, 0].float()
    _close(out[:, :, 0], fa._plain_bh_ones(q3, q3, q3, 512 ** -0.5,
                                           cdt=torch.bfloat16,
                                           block=fa.key_tile(512))[0])
    assert fa.LAUNCHES["_flash_bh_single"] == 1


# the head-dim-64 kernel (wgmma, 128 query rows and 128 keys a tile) at
# lengths that are not multiples of its tiles, on the packed projection's
# strides, with the lse and with #5's normalizer
def _flash64_checks(dev):
    """[(label, ok)] of the d = 64 kernel against its plain version."""
    def within(out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        max_bound, mean_bound = fa.error_bounds(ref)
        return (err.max().item() <= max_bound
                and err.mean().item() <= mean_bound)

    rows = []
    qkv = _rand(dev, 150, 3, 333, 3 * 320)
    q, k, v = qkv[..., :320], qkv[..., 320:640], qkv[..., 640:]
    rows.append(("packed S=333", within(fa._flash_mh_packed(qkv, 5, 0.125),
                                        fa._plain_mh(*_f(q, k, v), 5, 0.125))))
    k2, v2 = _rand(dev, 151, 3, 200, 320), _rand(dev, 152, 3, 200, 320)
    rows.append(("token-major Sq=333 Sk=200",
                 within(fa._flash_mh(q, k2, v2, 5, 0.125),
                        fa._plain_mh(*_f(q, k2, v2), 5, 0.125))))
    rows.append(("ones Sq=333 Sk=200",
                 within(fa._flash_mh_ones(q, k2, v2, 5, 0.125),
                        fa._plain_mh_ones(*_f(q, k2, v2), 5, 0.125,
                                          cdt=torch.bfloat16,
                                          block=fa.key_tile(64)))))
    for sq, sk in ((257, 1025), (130, 1000)):  # a last tile of one key
        qb, kb, vb = (_rand(dev, 153 + i, 4, s, 64)
                      for i, s in enumerate((sq, sk, sk)))
        out, lse = fa._flash_bh_with_lse(qb, kb, vb, 0.125)
        ref, ref_lse = fa._plain_bh_ones(*_f(qb, kb, vb), 0.125,
                                         cdt=torch.bfloat16,
                                         block=fa.key_tile(64))
        ok = (within(out, ref)
              and (lse - ref_lse).abs().max().item() <= fa.LSE_MAX_ABS)
        rows.append((f"bh Sq={sq} Sk={sk} + lse", ok,
                     (out.float() - ref).abs().max().item(),
                     (lse - ref_lse).abs().max().item()))
    return rows


def test_flash64_kernel_ragged_strided_lse_and_ones(dev):
    rows = _flash64_checks(dev)
    assert all(r[1] for r in rows), rows


FLASH_MUTATIONS = [
    ("output x1.01", "inv[r] = 1.f / l_r[r];", "inv[r] = 1.01f / l_r[r];"),
    ("skipped key tile",
     "    if (n0 + kBN > p.sk) {  // the ragged last tile: keys past sk",
     "    if (it == 1)\n      for (int i = 0; i < kBN / 2; ++i) sc[i] = "
     "neg_inf();\n    if (n0 + kBN > p.sk) {"),
]


@pytest.mark.parametrize("what,old,new", FLASH_MUTATIONS,
                         ids=[m[0] for m in FLASH_MUTATIONS])
def test_mutated_flash64_kernel_fails_at_every_shape(dev, tmp_path,
                                                     monkeypatch, what, old,
                                                     new):
    src = _broken_copy(tmp_path, "flash_attention.cu", old, new)
    monkeypatch.setattr(fa, "_LIB", fa.bind(
        _build.load_library(*fa.LIBRARY, csrc=src)))
    rows = _flash64_checks(dev)
    print(what, rows)
    assert not any(r[1] for r in rows), rows


# the head-dim-512 kernel (#4, and #3 past the single-pass cap): wgmma,
# 64 query rows and 64 keys a tile, query tiles in cluster pairs
D512_PATH = (("encoder", 1, 2560, 2560), ("decoder", 16, 2560, 2560),
             ("1024 encoder", 1, 9216, 9216),
             ("1024 decoder", 16, 9216, 9216))
# ragged at both ends; the lse is held to LSE_MAX_ABS where no key carries
# more than a few percent of a row's weight: at Sk = 65 (16 x 129 rows) a p
# that the kernel's exp2 and the reference's round to neighbouring bf16
# values moves the lse past it (an mma.sync kernel with 32-key tiles too)
D512_RAGGED = (("ragged", 1, 300, 700), ("ragged", 16, 129, 577),
               ("one key", 1, 64, 1), ("odd tiles, two-pass", 3, 333, 4500))


def _d512_checks(dev, shapes):
    """[(label, ok, max err, lse err)] of the d = 512 kernel against
    ``_plain_bh_ones`` rounding at its key tile, each through the wrapper
    the TPU package's selector picks and counted there."""
    rows = []
    sc = 512 ** -0.5
    for i, (label, bh, sq, sk) in enumerate(shapes):
        q, k, v = (_rand(dev, 170 + 3 * i + j, bh, n, 512)
                   for j, n in enumerate((sq, sk, sk)))
        name = fa._bh_kernel_name(sq, sk, 512)
        before = fa.LAUNCHES[name]
        out, lse = fa._flash_bh_with_lse(q, k, v, sc)
        torch.cuda.synchronize()
        ref, ref_lse = fa._plain_bh_ones(*_f(q, k, v), sc, cdt=torch.bfloat16,
                                         block=fa.key_tile(512))
        err = (out.float() - ref).abs()
        max_bound, mean_bound = fa.error_bounds(ref)
        lerr = (lse - ref_lse).abs().max().item()
        ok = (err.max().item() <= max_bound
              and err.mean().item() <= mean_bound
              and lerr <= fa.LSE_MAX_ABS
              and fa.LAUNCHES[name] == before + 1)
        rows.append((f"{label} BH={bh} Sq={sq} Sk={sk} ({name})", ok,
                     err.max().item(), lerr))
        del q, k, v, out, lse, ref, ref_lse
    return rows


def test_d512_kernel_at_path_and_ragged_shapes(dev):
    rows = _d512_checks(dev, D512_PATH + D512_RAGGED)
    print(rows)
    assert all(r[1] for r in rows), rows


D512_MUTATIONS = [
    ("skipped K/V tile",
     "      if (n0 + kBN > p.sk) {  // keys past sk",
     "      if (it == 1)\n        for (int i = 0; i < kBN / 2; ++i) sc[i] = "
     "neg_inf();\n      if (n0 + kBN > p.sk) {"),
    ("output x1.01",
     "      sm.inv[row0] = 1.f / l_r[0];\n      sm.inv[row0 + 8] = 1.f / l_r[1];",
     "      sm.inv[row0] = 1.01f / l_r[0];\n"
     "      sm.inv[row0 + 8] = 1.01f / l_r[1];"),
]


@pytest.mark.parametrize("what,old,new", D512_MUTATIONS,
                         ids=[m[0] for m in D512_MUTATIONS])
def test_mutated_d512_kernel_fails_at_every_path_shape(dev, tmp_path,
                                                       monkeypatch, what,
                                                       old, new):
    src = _broken_copy(tmp_path, "flash_attention.cu", old, new)
    monkeypatch.setattr(fa, "_LIB", fa.bind(
        _build.load_library(*fa.LIBRARY, csrc=src)))
    rows = _d512_checks(dev, D512_PATH)
    print(what, rows)
    assert not any(r[1] for r in rows), rows


def _fused_close(out, ref):
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    max_bound, mean_bound = fa.error_bounds(ref)
    assert err.max().item() <= max_bound, (err.max().item(), max_bound)
    assert err.mean().item() <= mean_bound, (err.mean().item(), mean_bound)


def _sums_close(y, s1, s2, axes):
    err, ok = kc._stats_error(y, s1, s2, axes)
    assert ok, err


@pytest.mark.parametrize("n,c", [(77, 320), (333, 512), (45, 1280)])
def test_ff_kernel_odd_token_counts(dev, n, c):
    d = 4 * c
    x = _rand(dev, 10, n, c)
    w1, b1 = _rand(dev, 11, 2 * d, c) * c ** -0.5, _rand(dev, 12, 2 * d)
    w2, b2 = _rand(dev, 13, c, d) * d ** -0.5, _rand(dev, 14, c)
    lw = 1 + 0.1 * _rand(dev, 15, c).float()
    lb = 0.1 * _rand(dev, 16, c).float()
    out = ff.fused_geglu_ff(x, w1, b1, w2, b2, lw, lb, 1e-5, True)
    ref = ff._plain_ff(*_f(x, w1, b1, w2, b2), lw, lb, 1e-5, True,
                       cdt=torch.bfloat16)
    _fused_close(out, ref)
    assert sum(ff.LAUNCHES.values()) == 1


@pytest.mark.parametrize("p,c", [(100, 64), (37, 320)])
def test_tconv_kernel_ragged_pixels(dev, p, c):
    x = _rand(dev, 20, 2, 3, p, c)
    w3 = _rand(dev, 21, c, 3, c) * (3 * c) ** -0.5
    bias, res = _rand(dev, 22, c), _rand(dev, 23, 2, 3, p, c)
    a = 1 + 0.2 * _rand(dev, 24, 2, c).float()
    b = 0.1 * _rand(dev, 25, 2, c).float()
    scale = torch.tensor(0.3, device=dev)
    y, s1, s2 = tc._pallas_tconv(x, w3, bias, a, b, res, scale, True, True)
    ref = tc._plain_tconv(*_f(x, w3, bias), a, b, res.float(), scale, True,
                          False, cdt=torch.bfloat16)
    _fused_close(y, ref)
    _sums_close(y, s1, s2, (2,))
    assert tc.LAUNCHES["_pallas_tconv"] == 1


@pytest.mark.parametrize("h,w,cin,cout", [(7, 9, 96, 40), (5, 8, 64, 136)])
def test_conv_kernel_ragged_tile_and_cin_ne_cout(dev, h, w, cin, cout):
    x = _rand(dev, 30, 3, h, w, cin)
    a = 1 + 0.2 * _rand(dev, 31, 3, cin).float()
    b = 0.1 * _rand(dev, 32, 3, cin).float()
    weight = _rand(dev, 33, cout, cin, 3, 3) * (9 * cin) ** -0.5
    bias, res = _rand(dev, 34, cout), _rand(dev, 35, 3, h, w, cout)
    y, s1, s2 = sc.winograd_gn_silu_conv3x3(x, a, b, weight, bias, res,
                                            stats=True)
    ref = sc._plain_conv3x3(x.float(), a, b, *_f(weight, bias, res), True,
                            False, cdt=torch.bfloat16)
    _fused_close(y, ref)
    _sums_close(y, s1, s2, (1, 2))
    assert sc.LAUNCHES["winograd_gn_silu_conv3x3"] == 1


@pytest.mark.parametrize("name", ["winograd_gn_silu_conv3x3",
                                  "_pallas_fused_conv"])
@pytest.mark.parametrize("h,w,cin,cout", [
    (40, 64, 320, 320),    # 20 full tiles of 128 pixels
    (20, 32, 640, 640),
    (10, 16, 1280, 1280),  # 160 pixels: a ragged last tile of 64
    (3, 256, 96, 160),     # W = 256 (the halo's cap); Cin not a multiple
    (7, 9, 160, 320)])     # of the 64-channel chunk
def test_conv_kernel_widths_chunks_and_ragged_tiles(dev, h, w, cin, cout,
                                                    name):
    """The wgmma conv (160 output channels and 64 or 128 pixels a block,
    64-channel chunks) at the UNet's widths, the widest image it takes and
    input widths that end in a half chunk, at both cast points."""
    x = _rand(dev, 160, 2, h, w, cin)
    a = 1 + 0.2 * _rand(dev, 161, 2, cin).float()
    b = 0.1 * _rand(dev, 162, 2, cin).float()
    weight = _rand(dev, 163, cout, cin, 3, 3) * (9 * cin) ** -0.5
    bias, res = _rand(dev, 164, cout), _rand(dev, 165, 2, h, w, cout)
    y, s1, s2 = getattr(sc, name)(x, a, b, weight, bias, res, stats=True)
    ref = sc._plain_conv3x3(x.float(), a, b, *_f(weight, bias, res), True,
                            False, cdt=torch.bfloat16,
                            round_first=name != "_pallas_fused_conv")
    _fused_close(y, ref)
    _sums_close(y, s1, s2, (1, 2))
    assert sc.LAUNCHES[name] == 1


@pytest.mark.parametrize("t,p,c", [(16, 37, 320), (4, 21, 512),
                                   (16, 3, 1280), (8, 5, 64)])
def test_tpair_kernel_ragged_pixels_and_short_clips(dev, t, p, c):
    """Pixel counts that leave the last token tile part empty, and T < 16
    (several pixels per m16 tile, attention masked to each pixel)."""
    x = _rand(dev, 40, 2, t, p, c)
    stages = tuple(
        (1 + 0.1 * _rand(dev, 41 + 10 * i, c).float(),
         0.1 * _rand(dev, 42 + 10 * i, c).float(),
         *(_rand(dev, 43 + 10 * i + j, c, c) * c ** -0.5 for j in range(4)),
         0.1 * _rand(dev, 47 + 10 * i, c)) for i in range(2))
    out = ta._fused_tpair_call(x, *stages, c // 64, 0.125)
    ref = ta._plain_tpair(x.float(), *(tuple(w.float() for w in s_)
                                       for s_ in stages),
                          c // 64, 0.125, 1e-5, cdt=torch.bfloat16)
    _fused_close(out, ref)
    assert ta.LAUNCHES["_fused_tpair_call"] == 1


@pytest.mark.parametrize("p,c", [(144, 1280), (9216, 320)])
def test_tpair_kernel_at_1024_pixel_counts(dev, p, c):
    """The 576x1024 model's mid block (P = 144: no 32-pixel tile divides
    it, a ragged last tile) and its ds1 level (P = 9216)."""
    test_tpair_kernel_ragged_pixels_and_short_clips(dev, 16, p, c)


# the F(2x4)-named conv at the 576x1024 model's ds2 shape, two images
F24_CARD = (("1024 ds2", (2, 36, 64, 640, 640)),)


def _f24_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return [(c, (1, 2)) for c in kc.conv_cases(dev, gen, F24_CARD)]


def test_f24_named_conv_at_its_1024_shape(dev):
    (case, axes), = _f24_cases(dev)
    assert case.name == "winograd24_gn_silu_conv3x3"
    row = kc.run_case(case, axes, timed=False)
    print(kc.line(case, row))
    assert row["ok"]
    # the model's entry names the launch the same way
    n, h, w, cin, cout = F24_CARD[0][1]
    conv = sc.Conv2d(cin, cout, 3, padding=1).to(dev, torch.bfloat16)
    x, res = _rand(dev, 36, n, h, w, cin), _rand(dev, 37, n, h, w, cout)
    a = 1 + 0.2 * _rand(dev, 38, n, cin).float()
    b = 0.1 * _rand(dev, 39, n, cin).float()
    with torch.no_grad():
        y, s1, s2 = sc.gn_silu_conv3x3(x, (a, b), conv, residual=res,
                                       return_stats=True)
        ref = sc._plain_conv3x3(x.float(), a, b, conv.weight.float(),
                                conv.bias.float(), res.float(), True, False,
                                cdt=torch.bfloat16)
    _fused_close(y, ref)
    _sums_close(y, s1, s2, (1, 2))
    assert sc.LAUNCHES == {"winograd_gn_silu_conv3x3": 0,
                           "winograd24_gn_silu_conv3x3": 2,
                           "_pallas_fused_conv": 0}


# (what is broken, the library's source, the file edited, text replaced,
#  replacement); the edited copy is built into the one library under test
_IGEMM = "implicit_gemm.cuh"
MUTATIONS = [
    ("output x1.01", "fused_ff.cu", "fused_ff.cu", "pack_bf16(y0, y1)",
     "pack_bf16(1.01f * y0, 1.01f * y1)"),
    ("skipped K chunk", "fused_ff.cu", "fused_ff.cu",
     "for (int j0 = 0; j0 < p.d; j0 += DK) {",
     "for (int j0 = 0; j0 < p.d; j0 += DK) {\n    if (j0 == DK) continue;"),
] + [
    ("output x1.01", "temporal_conv.cu", _IGEMM, "pack_bf16(y0, y1)",
     "pack_bf16(1.01f * y0, 1.01f * y1)"),
    ("skipped K chunk", "temporal_conv.cu", _IGEMM,
     "const bool ok = n < p.cout;",
     "const bool ok = n < p.cout && !(tap == 1 && k0 == kBK);"),
    ("wrong stats", "temporal_conv.cu", _IGEMM, "p.s2[o] = sStat[2 * BN + c]",
     "p.s2[o] = sStat[0 * BN + c]"),
    # the 3x3 conv: its own source since the wgmma redesign
    ("output x1.01", "gn_silu_conv3x3.cu", "gn_silu_conv3x3.cu",
     "pack_bf16(y0, y1)", "pack_bf16(1.01f * y0, 1.01f * y1)"),
    ("skipped K chunk", "gn_silu_conv3x3.cu", "gn_silu_conv3x3.cu",
     "sm90::wgmma_m64n160k16_rs<0>(acc,",
     "if (!(c == 1 && tap == 1)) sm90::wgmma_m64n160k16_rs<0>(acc,"),
    ("wrong stats", "gn_silu_conv3x3.cu", "gn_silu_conv3x3.cu",
     "p.s2[o] = r2;", "p.s2[o] = r1;"),
] + [
    ("output x1.01", "temporal_attention.cu", "temporal_attention.cu",
     "p.out + row * p.c + col) =\n                  pack_bf16(y0, y1);",
     "p.out + row * p.c + col) =\n                  "
     "pack_bf16(1.01f * y0, 1.01f * y1);"),
    ("skipped K chunk", "temporal_attention.cu", "temporal_attention.cu",
     "load_a_k32(a, sZ, cp, mt * 16, k, lane);",
     "load_a_k32(a, sZ, cp, mt * 16, k, lane);\n            "
     "if (k == 32) continue;"),
]
MODULE_OF = {"fused_ff.cu": ff, "temporal_conv.cu": tc,
             "gn_silu_conv3x3.cu": sc, "temporal_attention.cu": ta}


@pytest.mark.parametrize("what,src,edited,old,new", MUTATIONS,
                         ids=[f"{m[0]}-{m[1]}" for m in MUTATIONS])
def test_mutated_kernel_fails_at_every_path_shape(dev, tmp_path, monkeypatch,
                                                  what, src, edited, old, new):
    """A broken copy of the source, built outside the package, must fail
    the check of chip_smoke.py phase 2 at every path shape of its kernel
    (for wrong sums: every shape that has sums), and the conv's copies also
    at the F(2x4)-named 576x1024 shape."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    text = (tmp_path / edited).read_text()
    assert text.count(old) == 1, (edited, old)
    (tmp_path / edited).write_text(text.replace(old, new))
    mod = MODULE_OF[src]
    name, sources = mod.LIBRARY
    monkeypatch.setattr(mod, "_LIB", mod.bind(
        _build.load_library(name, sources, csrc=tmp_path)))
    checked = 0
    for case, axes in kc.fused_cases(dev) + _f24_cases(dev):
        if case.name not in mod.LAUNCHES:
            continue
        if what == "wrong stats" and axes is None:
            continue
        row = kc.run_case(case, axes, timed=False)
        print(f"{what} in {src}: {kc.line(case, row)}")
        assert not row["ok"], f"{what} passed at {case.label}"
        checked += 1
    assert checked >= 2


# ---------------------------------------------------------------------------
# the kernels of the three opt-in switches (#10, #11, #15, #16)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,p,c", [(16, 37, 320), (4, 21, 512),
                                   (16, 3, 1280)])
def test_single_stage_kernel_ragged_pixels_and_short_clips(dev, t, p, c):
    x = _rand(dev, 70, 2, t, p, c)
    stage = (1 + 0.1 * _rand(dev, 71, c).float(),
             0.1 * _rand(dev, 72, c).float(),
             *(_rand(dev, 73 + j, c, c) * c ** -0.5 for j in range(4)),
             0.1 * _rand(dev, 77, c))
    out = ta._fused_tattn_call(x, stage, c // 64, 0.125)
    ref = ta._plain_stage(x.float(), tuple(w.float() for w in stage),
                          c // 64, 0.125, 1e-5, torch.bfloat16)
    _fused_close(out, ref)
    assert ta.LAUNCHES["_fused_tattn_call"] == 1
    assert ta.LAUNCHES["_fused_tpair_call"] == 0


@pytest.mark.parametrize("t,p,inner,heads", [(16, 37, 320, 5),
                                             (8, 21, 256, 2), (32, 5, 128, 2),
                                             (3, 9, 192, 3)])
def test_ptc_kernel_strided_and_ragged(dev, t, p, inner, heads):
    """q, k, v as slices of one packed projection; T = 32, 3 and 8 (d =
    128 at T = 8), pixel counts no warp count divides."""
    qkv = _rand(dev, 80, 2, t, p, 3 * inner)
    q, k, v = qkv.chunk(3, dim=-1)
    d = inner // heads
    out = ta.temporal_attention_ptc(q, k, v, heads=heads, scale=d ** -0.5)
    ref = ta._xla_ptc(*_f(q, k, v), heads, d ** -0.5, cdt=torch.bfloat16)
    _fused_close(out, ref)
    assert ta.LAUNCHES["_ptc_kernel_call"] == 1


@pytest.mark.parametrize("h,w,cin,cout", [(8, 12, 128, 64), (9, 10, 64, 192)])
def test_im2col_named_conv_fp32_cast_point(dev, h, w, cin, cout):
    x = _rand(dev, 90, 3, h, w, cin)
    a = 1 + 0.2 * _rand(dev, 91, 3, cin).float()
    b = 0.1 * _rand(dev, 92, 3, cin).float()
    weight = _rand(dev, 93, cout, cin, 3, 3) * (9 * cin) ** -0.5
    bias, res = _rand(dev, 94, cout), _rand(dev, 95, 3, h, w, cout)
    y, s1, s2 = sc._pallas_fused_conv(x, a, b, weight, bias, res, stats=True)
    ref = sc._plain_conv3x3(x.float(), a, b, *_f(weight, bias, res), True,
                            False, cdt=torch.bfloat16, round_first=False)
    _fused_close(y, ref)
    _sums_close(y, s1, s2, (1, 2))
    assert sc.LAUNCHES["_pallas_fused_conv"] == 1


def _identity_conv(dev):
    """#15 through a centre-tap identity weight (Cin = Cout = 64, zero
    bias): y is z = bf16(silu(x A + B)) itself, so its cast point shows.
    Returns the kernel's y and the plain version's."""
    x = (_rand(dev, 99, 2, 8, 12, 64).float() * 2 + 0.5).to(torch.bfloat16)
    a = 1 + 0.2 * _rand(dev, 100, 2, 64).float()
    b = 0.1 * _rand(dev, 101, 2, 64).float()
    weight = torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16, device=dev)
    weight[:, :, 1, 1] = torch.eye(64, device=dev)
    bias = torch.zeros(64, dtype=torch.bfloat16, device=dev)
    y = sc._pallas_fused_conv(x, a, b, weight, bias)
    ref = sc._plain_conv3x3(x, a, b, weight, bias, None, True, False,
                            round_first=False)
    return y.float(), ref.float()


def _same_cast_point(y, ref):
    """At most 1 % of the elements off, each by at most one bf16 ulp: the
    kernel's SiLU (__expf) against torch's flips a rare rounding; a
    rounding before the SiLU as well moves ~27 % of them."""
    off = y != ref
    print(f"#15 identity conv: {off.float().mean().item():.4%} of the "
          f"elements off the plain version")
    return bool(off.float().mean().item() <= 0.01
                and ((y - ref).abs() <= 2.0 ** -7 * ref.abs()).all().item())


def test_im2col_named_conv_cast_point_through_an_identity_conv(dev):
    assert _same_cast_point(*_identity_conv(dev))
    assert sc.LAUNCHES["_pallas_fused_conv"] == 1


def test_im2col_named_conv_with_the_ref_cast_point_fails(dev, tmp_path,
                                                         monkeypatch):
    """A build whose #15 launch takes #13's prologue (kRoundFirst)."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    src = tmp_path / "gn_silu_conv3x3.cu"
    text = src.read_text()
    assert text.count("false>(q, wt, n, s)") == 2
    src.write_text(text.replace("false>(q, wt, n, s)", "true>(q, wt, n, s)"))
    built = _build.load_library(*sc.LIBRARY, csrc=tmp_path)
    monkeypatch.setattr(sc, "_LIB", sc.bind(built))
    assert not _same_cast_point(*_identity_conv(dev))


@pytest.mark.parametrize("shape,silu", [((3, 7, 9, 96), True),
                                        ((2, 4, 5, 6, 320), False),
                                        ((1, 1000, 2048), True)])
def test_gn_kernel_ragged_rows(dev, shape, silu):
    x = (_rand(dev, 96, *shape).float() * 2 + 0.5).to(torch.bfloat16)
    c = shape[-1]
    w = 1 + 0.2 * _rand(dev, 97, c).float()
    b = 0.2 * _rand(dev, 98, c).float()
    out = fn._pallas_gn(x, w, b, 32, 1e-5, silu)
    ref = fn._plain_gn(x.float(), w, b, 32, 1e-5, silu, cdt=torch.bfloat16)
    _fused_close(out, ref)
    assert fn.LAUNCHES["_pallas_gn"] == 1


# (the kernel, its library's module and (name, sources), the file edited,
#  the text replaced, the replacement)
SWITCHED_MUTATIONS = [
    ("_fused_tattn_call", "temporal_attention.cu",
     "  if (c <= 640) return launch<4, 5, 1>(q, s);",
     "  q.eps = 0.5f;\n  if (c <= 640) return launch<4, 5, 1>(q, s);"),
    ("_ptc_kernel_call", "temporal_ptc.cu",
     "l[j] = round_bf16(l[j] / den);",
     "l[j] = round_bf16(1.01f * l[j] / den);"),
    ("_pallas_fused_conv", "gn_silu_conv3x3.cu",
     "    if (silu) {\n      z0 = fast_silu(z0);",
     "    if (silu && kRoundFirst) {\n      z0 = fast_silu(z0);"),
    ("_pallas_gn", "group_norm_silu.cu",
     "const float inv = 1.f / sqrtf(var + eps);",
     "const float inv = 1.01f / sqrtf(var + eps);"),
]


def _switched_library(name):
    if name == "_ptc_kernel_call":
        return ta, "_PTC_LIB", ta.PTC_LIBRARY
    mod = {"_fused_tattn_call": ta, "_pallas_fused_conv": sc,
           "_pallas_gn": fn}[name]
    return mod, "_LIB", mod.LIBRARY


@pytest.mark.parametrize("name,edited,old,new", SWITCHED_MUTATIONS,
                         ids=[m[0] for m in SWITCHED_MUTATIONS])
def test_mutated_switched_kernel_fails_at_every_shape(dev, tmp_path,
                                                      monkeypatch, name,
                                                      edited, old, new):
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    text = (tmp_path / edited).read_text()
    assert text.count(old) == 1, (edited, old)
    (tmp_path / edited).write_text(text.replace(old, new))
    mod, attr, (lib, sources) = _switched_library(name)
    built = _build.load_library(lib, sources, csrc=tmp_path)
    if attr == "_PTC_LIB":
        monkeypatch.setattr(ta, "_PTC_LIB", None)
        monkeypatch.setattr(_build, "load_library",
                            lambda *a, **k: built)
        ta._ptc_library()
    else:
        monkeypatch.setattr(mod, attr, mod.bind(built))
    checked = 0
    for case, axes in kc.switched_cases(dev):
        if case.name != name:
            continue
        row = kc.run_case(case, axes, timed=False)
        print(f"{name} broken in {edited}: {kc.line(case, row)}")
        assert not row["ok"], f"the broken {name} passed at {case.label}"
        checked += 1
    assert checked >= 2


# ---------------------------------------------------------------------------
# the flash-attention backward (#6)
# ---------------------------------------------------------------------------

def _bwd_rows(cases, timed=False):
    rows = []
    for case in cases:
        row = kc.run_bwd_case(case, timed=timed)
        print(kc.bwd_line(case, row))
        rows.append(row)
    return rows


def test_bwd_kernel_at_path_shapes(dev):
    rows = _bwd_rows(kc.bwd_cases(dev))
    assert all(r["ok"] for r in rows)
    assert fa.LAUNCHES["_flash_bwd_bh"] == 3


@pytest.mark.parametrize("b,s,heads", [(2, 333, 3), (3, 16, 2), (2, 3, 4),
                                       (1, 200, 5)])
def test_bwd_kernel_ragged_and_short(dev, b, s, heads):
    """Lengths that leave the last 64-row tile part empty, a 16-frame
    sequence (the temporal length) and three tokens (61 of 64 rows
    masked; with one token the exact dq and dk are 0 and only rounding
    noise is left to compare)."""
    rows = _bwd_rows(kc.bwd_cases(dev, shapes=(("ragged", b, s, heads,
                                                 (1, 1)),)))
    assert rows[0]["ok"]


@pytest.mark.parametrize("sq,sk", [(200, 97), (64, 333)])
def test_bwd_wrapper_cross_lengths(dev, sq, sk):
    """The (BH, S, 64) wrapper with Sq != Sk, against the plain version."""
    q, k, v = (_rand(dev, 50 + i, 3, n, 64) for i, n in enumerate((sq, sk,
                                                                    sk)))
    out, lse = fa._flash_bh_with_lse(q, k, v, 0.125)
    dout = _rand(dev, 54, 3, sq, 64)
    got = fa._flash_bwd_bh(q, k, v, dout, out, lse, 0.125)
    refs = fa._plain_bwd_bh(*_f(q, k, v, dout), 0.125, out.float(), lse)
    torch.cuda.synchronize()
    for g, ref in zip(got, refs):
        err = (g.float() - ref).abs()
        max_bound, mean_bound = fa.grad_error_bounds(ref)
        assert err.max().item() <= max_bound, (err.max().item(), max_bound)
        assert err.mean().item() <= mean_bound, (err.mean().item(),
                                                 mean_bound)
    assert fa.LAUNCHES["_flash_bwd_bh"] == 1


BWD_MUTATIONS = [
    ("dq x1.01", "  const float mul = p.scale;  // dq = scale * dS K",
     "  const float mul = 1.01f * p.scale;"),
    ("query tile skipped in dk/dv",
     "    // dV += P^T dO and dK += dS^T Q: the queries are the reduction axis,",
     "    if (it == 1)\n      for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = "
     "da[i / 4][i % 4] = 0u;\n"
     "    // dV += P^T dO and dK += dS^T Q: the queries are the reduction axis,"),
    ("dq of one key block dropped",
     "      if (tw == 0) {\n        sm90::bulk_reduce_add(",
     "      if (tw == 0 && blockIdx.x != 1) {\n        sm90::bulk_reduce_add("),
]


@pytest.mark.parametrize("what,old,new", BWD_MUTATIONS,
                         ids=[m[0] for m in BWD_MUTATIONS])
def test_mutated_bwd_kernel_fails_at_every_path_shape(dev, tmp_path,
                                                      monkeypatch, what, old,
                                                      new):
    name, (src,) = fa.BWD_LIBRARY
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    text = (tmp_path / src).read_text()
    assert text.count(old) == 1, old
    (tmp_path / src).write_text(text.replace(old, new))
    monkeypatch.setattr(fa, "_BWD_LIB", fa.bind_bwd(
        _build.load_library(name, (src,), csrc=tmp_path)))
    rows = _bwd_rows(kc.bwd_cases(dev))
    assert len(rows) == 3
    for row in rows:
        assert not row["ok"], f"{what} passed"


def _grad_inputs(dev, *shapes, dtype=torch.bfloat16):
    return [(_rand(dev, 60 + i, *s).to(dtype)).requires_grad_()
            for i, s in enumerate(shapes)]


def _attached(fn, *inputs):
    """fn(*inputs) has a grad_fn and its backward reaches every input."""
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.float().square().mean().backward()
    for t in inputs:
        assert t.grad is not None and torch.isfinite(t.grad).all()


def test_no_wrapper_returns_a_detached_result(dev):
    """Under grad each kernel wrapper has a Function or raises."""
    f32 = torch.float32
    _attached(lambda x: fa._flash_mh_packed(x, 5, 0.125),
              *_grad_inputs(dev, (2, 512, 960)))
    _attached(lambda x: fa.flash_attention_packed(x, 2),
              *_grad_inputs(dev, (2, 160, 384)))
    _attached(lambda q, k, v: fa._flash_mh(q, k, v, 2, 0.125),
              *_grad_inputs(dev, (2, 160, 128), (2, 97, 128), (2, 97, 128)))
    _attached(fa.flash_attention,
              *_grad_inputs(dev, (1, 200, 2, 64), (1, 300, 2, 64),
                            (1, 300, 2, 64)))
    assert fa.LAUNCHES["_flash_bwd_bh"] == 4
    for call in (
            lambda q: fa._flash_bh_single(q, q, q, 0.125),
            lambda q: fa._flash_bh_with_lse(q, q, q, 0.125)):
        with pytest.raises(RuntimeError, match="no backward"):
            call(*_grad_inputs(dev, (2, 160, 64)))
    with pytest.raises(ValueError, match="head dim"):
        q = _grad_inputs(dev, (1, 256, 1, 512))[0]
        fa.flash_attention(q, q, q)
    c, d = 320, 1280
    x, w1, b1, w2, b2 = _grad_inputs(dev, (77, c), (2 * d, c), (2 * d,),
                                     (c, d), (c,))
    lw, lb = _grad_inputs(dev, (c,), (c,), dtype=f32)
    _attached(lambda *t: ff.fused_geglu_ff(*t, 1e-5, True), x, w1, b1, w2,
              b2, lw, lb)
    c = 128
    x = _grad_inputs(dev, (2, 4, 21, c))[0]
    stages = [tuple(_grad_inputs(dev, (c,), (c,), dtype=f32)
                    + _grad_inputs(dev, (c, c), (c, c), (c, c), (c, c),
                                   (c,))) for _ in range(2)]
    _attached(lambda x, *w: ta._fused_tpair_call(x, w[:7], w[7:], 2, 0.125),
              x, *stages[0], *stages[1])
    x, w3, bias = _grad_inputs(dev, (2, 3, 37, 64), (64, 3, 64), (64,))
    with pytest.raises(RuntimeError, match="no backward"):
        tc._pallas_tconv(x, w3, bias, silu=True)
    x, w, bias = _grad_inputs(dev, (2, 5, 8, 64), (64, 64, 3, 3), (64,))
    a = torch.ones(2, 64, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        sc.winograd_gn_silu_conv3x3(x, a, a * 0, w, bias)


# ---------------------------------------------------------------------------
# the kernels of the op functions no model reaches (#17, #18, #5)
# ---------------------------------------------------------------------------

def _broken_copy(tmp_path, edited, old, new):
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    text = (tmp_path / edited).read_text()
    assert text.count(old) == 1, (edited, old)
    (tmp_path / edited).write_text(text.replace(old, new))
    return tmp_path


def test_op_kernels_at_their_shapes(dev):
    rows = []
    for case, axes in kc.op_cases(dev):
        row = kc.run_case(case, axes, timed=False)
        print(kc.line(case, row))
        rows.append(row["ok"])
    assert all(rows) and len(rows) == 3 + len(kc.STATS_512) + 3


@pytest.mark.parametrize("sq,lt,li,strided", [(200, 77, 16, False),
                                              (64, 100, 32, True),
                                              (37, 1, 1, False)])
def test_dual_kernel_ragged_long_and_strided(dev, sq, lt, li, strided):
    """Query rows that leave the last 64-row tile part empty, contexts
    past one tile (the online rescale), one-token contexts, and q, k, v as
    slices of wider projections."""
    c, heads = 192, 3
    if strided:
        q = _rand(dev, 110, 2, sq, 2 * c)[..., c:]
        kv = _rand(dev, 111, 2, lt, 2 * c)
        kt, vt = kv[..., :c], kv[..., c:]
        kv = _rand(dev, 112, 2, li, 2 * c)
        ki, vi = kv[..., :c], kv[..., c:]
    else:
        q, kt, vt = (_rand(dev, 113 + i, 2, n, c)
                     for i, n in enumerate((sq, lt, lt)))
        ki, vi = _rand(dev, 116, 2, li, c), _rand(dev, 117, 2, li, c)
    s_ip = torch.tensor([0.4], device=dev)
    out = ca._dual_kernel_call(q, kt, vt, ki, vi, s_ip, heads, 0.125)
    ref = ca._plain_dual(*_f(q, kt, vt, ki, vi), s_ip, heads, 0.125,
                         cdt=torch.bfloat16)
    _close(out, ref)
    assert ca.LAUNCHES["_dual_kernel_call"] == 1


def test_dual_entry_follows_the_switch_and_differentiates(dev, monkeypatch):
    q, kt, vt, ki, vi = (_rand(dev, 120 + i, 2, n, 128).requires_grad_()
                         for i, n in enumerate((256, 77, 77, 16, 16)))
    s_ip = torch.tensor(0.3, device=dev, requires_grad=True)
    monkeypatch.setattr(ca, "_DUAL_CROSS_PALLAS", False)
    off = ca.dual_cross_attention(q, kt, vt, ki, vi, s_ip, 2)
    assert ca.LAUNCHES["_dual_kernel_call"] == 0
    monkeypatch.setattr(ca, "_DUAL_CROSS_PALLAS", True)
    on = ca.dual_cross_attention(q, kt, vt, ki, vi, s_ip, 2)
    assert ca.LAUNCHES["_dual_kernel_call"] == 1
    _close(on, ca._plain_dual(*_f(q, kt, vt, ki, vi), s_ip.detach(), 2,
                              0.125, cdt=torch.bfloat16))
    g = _rand(dev, 126, 2, 256, 128)
    grads = torch.autograd.grad((on.float() * g.float()).sum(),
                                (q, kt, vt, ki, vi, s_ip))
    want = torch.autograd.grad((off.float() * g.float()).sum(),
                               (q, kt, vt, ki, vi, s_ip))
    for a, b in zip(grads, want):  # the same formula differentiated
        torch.testing.assert_close(a, b)


def _dual_pin(dev):
    """``kernel_check.dual_pin_inputs`` on the card: the share of the
    kernel's outputs off the fp32 plain version rounded once."""
    mats, s_ip, heads = kc.dual_pin_inputs()
    ts = [torch.from_numpy(m).to(dev) for m in mats]
    out = ca._dual_kernel_call(*(t.bfloat16() for t in ts), s_ip, heads,
                               0.125)
    ref = ca._plain_dual(*ts, s_ip, heads, 0.125).bfloat16()
    torch.cuda.synchronize()
    moved = (out != ref).float().mean().item()
    print(f"#17 pin: {moved:.2%} of the outputs off the one rounding")
    return moved


def test_dual_kernel_rounds_once_after_the_combine(dev):
    assert _dual_pin(dev) == 0.0


def test_dual_kernel_rounding_each_branch_fails(dev, tmp_path, monkeypatch):
    old = "y[e] = __fadd_rn(ot[j][e], __fmul_rn(si, oi[j][e]));"
    new = ("y[e] = __fadd_rn(round_bf16(ot[j][e]), "
           "round_bf16(__fmul_rn(si, oi[j][e])));")
    src = _broken_copy(tmp_path, "dual_cross_attention.cu", old, new)
    monkeypatch.setattr(ca, "_LIB", ca.bind(
        _build.load_library(*ca.LIBRARY, csrc=src)))
    assert _dual_pin(dev) > 0.05


@pytest.mark.parametrize("shape,dtype", [((3, 7, 9, 96), torch.bfloat16),
                                         ((2, 300, 64), torch.float32),
                                         ((2, 5, 61, 2560), torch.float16),
                                         ((1, 1, 8), torch.bfloat16)])
def test_sums_kernel_ragged_and_dtypes(dev, shape, dtype):
    x = (_rand(dev, 130, *shape).float() * 2 + 0.5).to(dtype)
    n, c = shape[0], shape[-1]
    got = st._pallas_sums(x.reshape(n, -1, c))
    row = kc._sums_row(got, kc.sums_reference(x.reshape(n, -1, c)))
    assert row["ok"], row
    assert st.LAUNCHES["_pallas_sums"] == 1


def test_channel_sums_entry_takes_the_kernel_in_the_envelope(dev):
    x = _rand(dev, 131, 2, 16, 16, 128).requires_grad_()
    s1, s2 = st.channel_sums(x)
    assert st.LAUNCHES["_pallas_sums"] == 1
    assert kc._sums_row((s1, s2), kc.sums_reference(
        x.detach().flatten(1, 2)))["ok"]
    (gx,) = torch.autograd.grad((s1 + s2).sum(), x)
    torch.testing.assert_close(gx, (1 + 2 * x.detach().float()).to(x.dtype),
                               rtol=0, atol=0)
    st.channel_sums(_rand(dev, 132, 2, 8, 8, 128))  # S = 64: outside
    assert st.LAUNCHES["_pallas_sums"] == 1


def _sums_pin(dev):
    """x = +-2^k (1 + 2^-7) at the UNet's ds1 GroupNorm input: the fp32
    square is exact, a bf16 square is 6e-5 low."""
    n, s, c = 32, 2560, 320
    k = (torch.arange(c, device=dev) % 5 - 2).float()
    sign = torch.where(_rand(dev, 133, n, s, c) >= 0, 1.0, -1.0)
    x = (sign * torch.exp2(k) * (1 + 2.0 ** -7)).to(torch.bfloat16)
    row = kc._sums_row(st._pallas_sums(x), kc.sums_reference(x))
    print(f"#18 pin: relative error {row['rel_err']:.3e}")
    return row["ok"]


def test_sums_kernel_squares_in_fp32(dev):
    assert _sums_pin(dev)


def test_sums_kernel_squaring_in_bf16_fails(dev, tmp_path, monkeypatch):
    old = "float sq(float v) { return v * v; }"
    new = ("float sq(float v) { "
           "return __bfloat162float(__float2bfloat16(v * v)); }")
    src = _broken_copy(tmp_path, "channel_sums.cu", old, new)
    monkeypatch.setattr(st, "_LIB", st.bind(
        _build.load_library(*st.LIBRARY, csrc=src)))
    assert not _sums_pin(dev)


@pytest.mark.parametrize("sq,sk", [(200, 200), (160, 97), (64, 333)])
def test_ones_kernel_ragged_and_strided(dev, sq, sk):
    q = _rand(dev, 140, 2, sq, 3 * 128)[..., :128]
    k, v = _rand(dev, 141, 2, sk, 128), _rand(dev, 142, 2, sk, 128)
    out = fa._flash_mh_ones(q, k, v, 2, 0.125)
    _close(out, fa._plain_mh_ones(*_f(q, k, v), 2, 0.125,
                                  cdt=torch.bfloat16))
    assert fa.LAUNCHES["_flash_mh_ones"] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        fa._flash_mh_ones(q.detach().requires_grad_(), k, v, 2, 0.125)


def _ones_pin(dev):
    """``kernel_check.ones_pin_inputs`` on the card: #5's output and
    #2's."""
    q, k, v, heads, scale = kc.ones_pin_inputs()
    ts = [torch.from_numpy(t).to(dev).bfloat16() for t in (q, k, v)]
    ones = fa._flash_mh_ones(*ts, heads, scale)
    mh = fa._flash_mh(*ts, heads, scale)
    torch.cuda.synchronize()
    return ones.float(), mh.float()


def test_ones_kernel_divides_by_the_sum_of_rounded_p(dev):
    ones, mh = _ones_pin(dev)
    assert (ones == 1.0).all() and (mh == 0.99609375).all()


# a build of csrc/flash_attention.cu that sums the unrounded p for every
# flag: the ones flag launches the head-dim-64 kernel's unrounded-sum
# instantiation, and the d = 512 kernel's row sum (warpgroup 0's softmax in
# namespace wg512) drops its rounding
_ROUNDED_SUM = (("return ones ? wg::launch<true>(p, batch, s)",
                 "return ones ? wg::launch<false>(p, batch, s)"),
                ("l_r[e >> 1] += round_bf16(pv);", "l_r[e >> 1] += pv;"))


def _unrounded_build(tmp_path, monkeypatch):
    src = _broken_copy(tmp_path, "flash_attention.cu", *_ROUNDED_SUM[0])
    text = (src / "flash_attention.cu").read_text()
    assert text.count(_ROUNDED_SUM[1][0]) == 1
    (src / "flash_attention.cu").write_text(text.replace(*_ROUNDED_SUM[1]))
    monkeypatch.setattr(fa, "_LIB", fa.bind(
        _build.load_library(*fa.LIBRARY, csrc=src)))


def test_ones_kernel_with_the_unrounded_sum_fails(dev, tmp_path,
                                                  monkeypatch):
    _unrounded_build(tmp_path, monkeypatch)
    ones, _ = _ones_pin(dev)
    assert not (ones == 1.0).all()


PIN_LSE = 4.8563027


def _bh_pin(dev, d, monkeypatch):
    """``kernel_check.ones_pin_inputs`` folded to (B*H, S, 64), and at
    d = 512 padded (q, k with zeros, v with ones: the same scores), through
    #3 (the two-pass pick forced) and #4. Row r's top key is key r % 64, in
    the kernel's first key tile (128 keys at d = 64, 64 at d = 512; q is
    one-hot at r % key_tile if that were smaller), so the running max is
    the row's max from the first tile on, as in the TPU kernels' one step
    over these 128 keys, and only the normalizer's cast point shows (the
    lse does not depend on which key is on top). Returns [(out, lse)] of
    each and asserts each counted its own launch."""
    q, k, v, heads, scale = kc.ones_pin_inputs()
    top = min(64, fa.key_tile(d))
    q = np.tile(np.eye(64, dtype=np.float32)[np.arange(q.shape[1]) % top],
                (q.shape[0], 1, heads))
    ts = []
    for t, fill in ((q, 0.0), (k, 0.0), (v, 1.0)):
        t = fa._fold_heads(torch.from_numpy(t), heads)
        pad = torch.full((*t.shape[:2], d - 64), fill)
        ts.append(torch.cat([t, pad], -1).to(dev).bfloat16())
    got = [fa._flash_bh_single(*ts, scale)]
    with monkeypatch.context() as m:
        m.setattr(fa, "_single_pass_blk", lambda *a: 0)
        got.append(fa._flash_bh_with_lse(*ts, scale))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["_flash_bh_single"] == 1
    assert fa.LAUNCHES["_flash_bh_with_lse"] == 1
    return got


def _pinned(out, lse):
    return bool((out.float() == 1.0).all().item()
                and (lse - PIN_LSE).abs().max().item() <= fa.LSE_MAX_ABS)


@pytest.mark.parametrize("d", [64, 512])
def test_bh_kernels_normalize_by_the_sum_of_rounded_p(dev, monkeypatch, d):
    """#3 and #4 as the JAX kernels compute them (the CPU test pins those):
    output exactly 1.0, lse 4.8563027 within LSE_MAX_ABS."""
    assert all(_pinned(*r) for r in _bh_pin(dev, d, monkeypatch))


@pytest.mark.parametrize("d", [64, 512])
def test_bh_kernels_with_the_unrounded_sum_fail(dev, tmp_path, monkeypatch,
                                                d):
    _unrounded_build(tmp_path, monkeypatch)
    assert not any(_pinned(*r) for r in _bh_pin(dev, d, monkeypatch))
