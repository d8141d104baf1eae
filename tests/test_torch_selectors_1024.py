"""Which kernel the port launches at every attention, pair, FF and conv site
of the 576x1024 model, against what the JAX package's selectors pick there.

The port's model is built from configs/inference_1024_v1.0.yaml on the meta
device (no memory, no compute) and driven through one UNet call (2 CFG
branches x 16 frames of the 72x128 latent), one per-frame encode of a
576x1024 frame and one 16-frame dual-ref decode, with the CUDA launches
stubbed out and the wrappers taking their card branch. Spies on the
model-level entry points record each site's shape and the launch counter
that moved. The JAX side is its selectors on the same shapes, as they decide
on a TPU (``_dispatch.on_tpu`` patched true).

Where the two differ, it is by design and asserted as such:
  * the temporal attention pair at the 9x16 mid block (P = 144): the JAX
    package has no kernel there (no pixel tile of 32 or more divides 144)
    and runs its XLA 5-D chain; the port's pair kernel masks ragged pixel
    tiles and runs there too (the same function);
  * the GN+SiLU+3x3 conv: the port's kernel runs at every conv, counted as
    F(2x4) (#14) exactly where the JAX package takes F(2x4) and as F(2x2)
    (#13) everywhere else, where the JAX package runs F(2x2) on its own
    allowlist or XLA;
  * the (3,1,1) temporal conv at the 1280-channel levels, P = 576 (18x32)
    and P = 144 (9x16 and the mid block), where no pixel tile of the JAX
    package's both divides P and fits its VMEM budget, so it runs XLA: the
    port's kernel runs at every shape.
"""

import collections
import inspect
import os

import pytest
import torch

from tooncrafter_tpu.ops import _dispatch
from tooncrafter_tpu.ops import flash_attention as jfa
from tooncrafter_tpu.ops import fused_ff as jff
from tooncrafter_tpu.ops import spatial_conv as jsc
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu.ops import temporal_conv as jtc
from tooncrafter_tpu.ops import winograd as jwg
from tooncrafter_tpu_torch.config import model_config_from_yaml
from tooncrafter_tpu_torch.models import unet as unet_mod
from tooncrafter_tpu_torch.models import vae as vae_mod
from tooncrafter_tpu_torch.models import vae_dualref as dualref_mod
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import _launch
from tooncrafter_tpu_torch.ops import flash_attention as fa
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import spatial_conv as sc
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.ops import temporal_conv as tc
from tooncrafter_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

YAML_1024 = os.path.join(os.path.dirname(__file__), "..", "configs",
                         "inference_1024_v1.0.yaml")

# launches per UNet call (2 CFG branches x 16 frames at 72x128); a DDIM-50
# request runs 50 calls
UNET_LAUNCHES_1024 = {
    "_flash_mh": 10, "_flash_bh_with_lse": 5, "_pallas_ff": 20,
    "_pallas_ff_streamed": 13, "_fused_tpair_call": 17, "_pallas_tconv": 88,
    "winograd_gn_silu_conv3x3": 38, "winograd24_gn_silu_conv3x3": 6}


def _empty_like_sums(x, cout, sums_shape):
    out = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype, device=x.device)
    sums = [torch.empty(sums_shape, device=x.device) for _ in range(2)]
    return out, sums


def _stub_launches(mp):
    """The wrappers take their card branch on meta tensors and their
    launches return empty outputs of the kernels' shapes."""
    mp.setattr(_launch, "on_cpu", lambda what, *ts: False)
    mp.setattr(fa, "_launch", lambda *a, **k: None)

    def conv(x, a, b, w9, bias, res, silu, stats):
        out, sums = _empty_like_sums(x, w9.shape[0], (x.shape[0], w9.shape[0]))
        return (out, *sums) if stats else out

    def tconv(x, w3, bias, a, b, res, scale, silu, stats):
        out, sums = _empty_like_sums(x, w3.shape[0],
                                     x.shape[:2] + (w3.shape[0],))
        return (out, *sums) if stats else out
    mp.setattr(sc, "_launch_conv", conv)
    mp.setattr(tc, "_launch_tconv", tconv)
    mp.setattr(ff, "_launch_ff", lambda x2, w1, b1, w2, *a: torch.empty(
        (x2.shape[0], w2.shape[0]), dtype=x2.dtype, device=x2.device))
    mp.setattr(ta, "_launch_tpair", lambda x, *a: torch.empty_like(x))


def _spy(mp, owner, attr, kind, key, log):
    """Record (kind, key(args), the launch counter that moved or 'plain')
    for every call of owner.attr."""
    fn = getattr(owner, attr)

    def spied(*args, **kwargs):
        before = kc.launch_counts()
        out = fn(*args, **kwargs)
        moved = [k for k, v in kc.launch_counts().items() if v != before[k]]
        assert len(moved) <= 1, moved
        log.append((kind, key(*args, **kwargs), moved[0] if moved else
                    "plain"))
        return out
    mp.setattr(owner, attr, spied)


def _pixels(x):
    p = 1
    for d in x.shape[2:-1]:
        p *= d
    return p


_TCONV_SIG = inspect.signature(tc.temporal_conv3)


def _tconv_key(*args, **kwargs):
    """(T, P, Cin, Cout, residual, out_scale, sums): the JAX selector's
    arguments, then the call's epilogue."""
    a = _TCONV_SIG.bind(*args, **kwargs).arguments
    x, weight = a["x"], a["weight"]
    return (x.shape[1], _pixels(x), x.shape[-1], weight.shape[0],
            a.get("residual") is not None, a.get("out_scale") is not None,
            bool(a.get("return_stats", False)))


def _spies(mp, log):
    _spy(mp, unet_mod, "gn_silu_conv3x3", "conv",
         lambda x, affine, conv, *a, **k: tuple(x.shape[1:]) + (
             conv.weight.shape[0],), log)
    _spy(mp, tc, "temporal_conv3", "tconv", _tconv_key, log)
    _spy(mp, unet_mod, "fused_geglu_ff", "ff",
         lambda x, w1, b1, w2, *a, **k: (x.numel() // x.shape[-1],
                                         x.shape[-1], w1.shape[0] // 2,
                                         w2.shape[0]), log)
    _spy(mp, ta, "_fused_tpair_call", "pair",
         lambda x, s1, s2, heads, *a, **k: (x.shape[1], x.shape[2],
                                            x.shape[3], heads), log)
    _spy(mp, fa, "flash_attention_packed", "packed",
         lambda qkv, heads, *a, **k: (qkv.shape[1], qkv.shape[2] // 3, heads),
         log)
    for mod in (unet_mod, vae_mod, dualref_mod):
        _spy(mp, mod, "attention", "attention",
             lambda q, k, v, *, heads, mask=None, scale=None, m=mod: (
                 q.shape[1], k.shape[1], q.shape[2], heads,
                 m is unet_mod and q.shape[1] == k.shape[1],
                 mask is not None), log)


@pytest.fixture(scope="module")
def sites():
    cfg = model_config_from_yaml(YAML_1024)
    assert (cfg.latent_h, cfg.latent_w) == (72, 128)
    with torch.device("meta"):
        model = ToonCrafter(cfg)
    model.eval()
    t, h, w = cfg.video_length, cfg.latent_h, cfg.latent_w
    unet_log, vae_log = [], []
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        _stub_launches(mp)
        kc.reset_launch_counts()
        log = []
        _spies(mp, log)
        meta = dict(device="meta")
        model.unet(torch.empty(2, t, h, w, cfg.unet_in_channels, **meta),
                   torch.empty(2, **meta),
                   torch.empty(2, 77 + t * cfg.resampler_queries,
                               cfg.context_dim, **meta),
                   torch.empty(2, **meta))
        unet_counts = kc.launch_counts()
        unet_log, log[:] = list(log), []
        vae = model.first_stage_model
        _, taps = vae.encode(torch.empty(1, 8 * h, 8 * w, 3, **meta))
        refs = [tap.unsqueeze(0).expand((1, 2) + tap.shape[1:])
                for tap in taps]
        vae.decoder(torch.empty(1, t, h, w, cfg.z_channels, **meta), refs)
        vae_log = list(log)
    kc.reset_launch_counts()
    return {"unet": unet_log, "vae": vae_log, "unet_counts": unet_counts}


@pytest.fixture
def on_tpu(monkeypatch):
    """The JAX selectors as they decide on a TPU."""
    monkeypatch.setattr(_dispatch, "on_tpu", lambda: True)


def jax_choice(kind, key):
    """The kernel (by the port's counter name) or the XLA form ('plain')
    the JAX package takes at this site."""
    if kind == "packed":
        s, c, heads = key
        assert jfa.use_packed_kernel(s, c, heads)
        return ("_flash_mh_packed" if jfa._packed_direct_blk(s, c, heads)
                else "_flash_mh")
    if kind == "attention":
        sq, sk, inner, heads, unet_self, masked = key
        if unet_self:  # the UNet's attn1 asks for the packed kernels first
            assert not jfa.use_packed_kernel(sq, inner, heads)
        d = inner // heads
        if masked or not jfa._use_kernel(sq, sk, d):
            return "plain"
        return ("_flash_bh_single" if jfa._single_pass_blk(sq, sk, d)
                else "_flash_bh_with_lse")
    if kind == "conv":
        if jwg.table_entry24(*key):
            return "winograd24_gn_silu_conv3x3"
        if jwg.table_entry(*key):
            return "winograd_gn_silu_conv3x3"
        return "_pallas_fused_conv" if jsc._use_kernel(*key) else "plain"
    if kind == "tconv":
        return "_pallas_tconv" if jtc._use_kernel(*key[:4]) else "plain"
    if kind == "ff":
        if not jff.use_kernel(*key):
            return "plain"
        return {"resident": "_pallas_ff",
                "streamed": "_pallas_ff_streamed"}[jff._mode(*key)]
    if kind == "pair":
        t, p, c, heads = key
        d = c // heads
        fast = (jta.use_kernel(t, p, d, inner=c)
                or jta.use_fused_kernel(t, p, d, c, c))
        if fast and jta.use_pair_kernel(t, p, d, c, c):
            return "_fused_tpair_call"
        return "_fused_tattn_call" if fast else "plain"
    raise AssertionError(kind)


def _by_kind(log, kind):
    return [(key, port) for k, key, port in log if k == kind]


def test_unet_launches_per_call(sites):
    counts = {k: v for k, v in sites["unet_counts"].items() if v}
    assert counts == UNET_LAUNCHES_1024


def test_every_site_was_seen(sites):
    kinds = collections.Counter(k for k, _, _ in sites["unet"])
    # attn1 x15 (10 packed, 5 at ds4 and 1 mid through attention()), attn2
    # x16 (text and image each), the pairs, FFs (spatial and temporal), 44
    # ResBlock convs, 22 x 4 temporal convs
    assert kinds == {"packed": 10, "attention": 6 + 2 * 16, "pair": 17,
                     "ff": 33, "conv": 44, "tconv": 88}
    vae = collections.Counter(k for k, _, _ in sites["vae"])
    # encoder and decoder mid attention, fusion at levels 2 and 3; the
    # TimeStacks of the decoder's 14 VideoResBlocks (2 in the mid block, 3
    # per level), two temporal convs each
    assert vae == {"attention": 4, "tconv": 28}


@pytest.mark.parametrize("kind", ["packed", "attention", "ff"])
def test_same_choice_as_jax(sites, on_tpu, kind):
    rows = _by_kind(sites["unet"] + sites["vae"], kind)
    assert rows
    for key, port in rows:
        assert port == jax_choice(kind, key), (kind, key)


def test_attention_routes_at_1024(sites, on_tpu):
    """S = 9216 and 2304 take the token-major kernel (never the packed
    one); S = 576 and the VAE mid attention (S = 9216, d = 512) the
    two-pass wrapper; S = 144 and the cross-attention the plain form."""
    got = {}
    for kind, key, port in sites["unet"] + sites["vae"]:
        if kind in ("packed", "attention"):
            got.setdefault((kind,) + key[:2], set()).add(port)
    # the packed projection's (S, C)
    assert got[("packed", 9216, 320)] == got[("packed", 2304, 640)] == {
        "_flash_mh"}
    # (Sq, Sk) through attention()
    att = {k[1:]: v for k, v in got.items() if k[0] == "attention"}
    assert att[(576, 576)] == {"_flash_bh_with_lse"}
    assert att[(144, 144)] == {"plain"}
    assert att[(9216, 9216)] == {"_flash_bh_with_lse"}  # VAE mid, d = 512
    assert att[(589824, 73728)] == att[(147456, 18432)] == {
        "_flash_bh_with_lse"}
    assert att[(9216, 77)] == att[(9216, 16)] == {"plain"}
    assert "_flash_mh_packed" not in set().union(*got.values())


def test_pair_differs_only_at_p144(sites, on_tpu):
    rows = _by_kind(sites["unet"], "pair")
    differ = {key for key, port in rows
              if port != jax_choice("pair", key)}
    assert {p for _, p, _, _ in differ} == {144}
    assert all(port == "_fused_tpair_call" for _, port in rows)
    assert all(jax_choice("pair", key) == "plain" for key in differ)
    ps = {key[1] for key, _ in rows}
    assert ps == {9216, 2304, 576, 144}


def test_phase2_checks_the_pair_at_every_launched_shape(sites):
    """``kernel_check.TPAIR_1024`` holds every (P, C) the 576x1024 UNet
    launches the pair at, the 9216-pixel 512-wide init attention too."""
    launched = {(p, c) for (t, p, c, _), _ in _by_kind(sites["unet"], "pair")}
    assert launched == {(p, c) for _, p, c in kc.TPAIR_1024}


def test_conv_names_f24_exactly_where_jax_takes_it(sites, on_tpu):
    rows = _by_kind(sites["unet"], "conv")
    f24 = [key for key, port in rows if port == "winograd24_gn_silu_conv3x3"]
    assert f24 and all(key == (36, 64, 640, 640) for key in f24)
    for key, port in rows:
        jax = jax_choice("conv", key)
        assert (port == "winograd24_gn_silu_conv3x3") == (
            jax == "winograd24_gn_silu_conv3x3"), key
        if jax != "winograd24_gn_silu_conv3x3":
            assert port == "winograd_gn_silu_conv3x3", key


# #12's epilogues: (residual, out_scale, sums); the block residual and the
# alpha merge carry the sums of the block's output (the stats chain)
SUMS, RESIDUAL, MERGE = (False, False, True), (True, False, True), (
    True, True, True)


def tconv_table(unet, vae):
    """Launches by (P, C, residual, out_scale, sums) in one UNet call and
    one decode: the UNet's TemporalConvBlocks (conv1-3 with sums, conv4
    with the block residual) from {(P, C): blocks}, the decoder's
    TimeStacks (in_layers with sums, out_layers with the alpha merge) from
    {(P, C): stacks}."""
    return {"unet": {k + e: n * blocks for k, blocks in unet.items()
                     for e, n in ((SUMS, 3), (RESIDUAL, 1))},
            "vae": {k + e: stacks for k, stacks in vae.items()
                    for e in (SUMS, MERGE)}}


# in the 576x1024 model (a request runs 50 UNet calls and 2 decodes; one
# UNet call holds both CFG branches): ResBlocks 5, 5, 5 and 7 a level; the
# decoder's 14 TimeStacks: 2 in the mid block, 3 a level
TCONV_BY_SHAPE_1024 = tconv_table(
    {(9216, 320): 5, (2304, 640): 5, (576, 1280): 5, (144, 1280): 7},
    {(9216, 512): 5, (36864, 512): 3, (147456, 256): 3, (589824, 128): 3})


def tconv_by_shape(log):
    return dict(collections.Counter(
        key[1:3] + key[4:] for kind, key, moved in log
        if kind == "tconv" and moved in ("_pallas_tconv",
                                         ["_pallas_tconv"])))


def test_tconv_launches_by_shape(sites):
    for part, want in TCONV_BY_SHAPE_1024.items():
        assert tconv_by_shape(sites[part]) == want, part


def test_tconv_differs_only_at_the_1280_wide_levels(sites, on_tpu):
    rows = _by_kind(sites["unet"] + sites["vae"], "tconv")
    assert all(port == "_pallas_tconv" for _, port in rows)
    plain = {key for key, _ in rows if jax_choice("tconv", key) == "plain"}
    assert {key[1:3] for key in plain} == {(576, 1280), (144, 1280)}
    assert {key[1] for key, _ in _by_kind(sites["vae"], "tconv")} == {
        9216, 36864, 147456, 589824}
