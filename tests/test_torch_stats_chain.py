"""The cross-block stats chain, CFG stem sharing and relative-position
temporal attention of the port (tooncrafter_tpu_torch) against
tooncrafter_tpu at the tiny config in fp32 on the CPU.

* The chain: in one UNet forward and in one dual-ref decode, the norms that
  take their statistics from their input (the JAX side: calls of
  ``norms.gn_affine``, which every GroupNorm without producer sums reaches,
  counted while ``jax.make_jaxpr`` traces the call; the port:
  ``norms.gn_affine``, ``norms.group_norm`` and the one-pass path's
  ``group_norm``) are as many on both sides; every sum a port norm is
  handed equals the sums of the tensor it normalizes (over the axes the
  norm spans, to 1e-5 of the sum of |x| for s1 and of s2 itself). The
  chained outputs are held to the JAX package at the 2e-4 bar by
  tests/test_torch_unet.py and tests/test_torch_vae.py.
* ``cfg_groups=2`` against ``cfg_groups=1`` and the JAX ``cfg_groups=2``
  (atol 1e-5); the input conv sees B/2 rows; the DDIM denoise passes the
  branch count and matches the JAX denoise.
* ``use_relative_position``: the tables load under their upstream names,
  and a temporal transformer and the UNet match the JAX package.

Weights: the JAX init with every all-zero leaf replaced by seeded noise,
carried over by ``utils.weights.from_jax_params`` (the fixtures of
tests/test_torch_unet.py and tests/test_torch_vae.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet import (PREFIX, _close, _inputs,  # noqa: F401
                             unets)
from test_torch_vae import vaes  # noqa: F401 (fixture)
from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.models.unet import TemporalTransformer as JaxTT
from tooncrafter_tpu.ops import norms as jnorms
from tooncrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.ops import fused_norms as fn
from tooncrafter_tpu_torch.ops import norms
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

STATS_REL = 1e-5


def _counting(mp, owner, attr, box):
    real = getattr(owner, attr)

    def counted(*a, **k):
        box[0] += 1
        return real(*a, **k)
    mp.setattr(owner, attr, counted)


def _jax_reads(fn_, *args):
    """Norms reading their input for statistics in one JAX call (traced
    once, not run)."""
    box = [0]
    with pytest.MonkeyPatch.context() as mp:
        _counting(mp, jnorms, "gn_affine", box)
        jax.make_jaxpr(fn_)(*args)
    return box[0]


def _port_reads(fn_):
    box = [0]
    with pytest.MonkeyPatch.context() as mp:
        _counting(mp, norms, "gn_affine", box)
        _counting(mp, norms, "group_norm", box)
        _counting(mp, fn, "group_norm", box)
        with torch.no_grad():
            out = fn_()
    return box[0], out


@pytest.fixture
def checked_sums(monkeypatch):
    """Every sum a port GroupNorm is handed, against its input's sums."""
    seen = []

    def check(x, stats):
        axes = tuple(range(1, x.ndim - 1))
        xf = x.detach().double()
        s1, s2 = xf.sum(axes), xf.square().sum(axes)
        assert stats[0].shape == s1.shape, (stats[0].shape, x.shape)
        err1 = (stats[0].double() - s1).abs()
        err2 = (stats[1].double() - s2).abs()
        assert (err1 <= STATS_REL * xf.abs().sum(axes) + 1e-30).all()
        assert (err2 <= STATS_REL * s2 + 1e-30).all()
        seen.append(tuple(x.shape))

    folded, forward = norms.GroupNorm.folded, norms.GroupNorm.forward

    def folded_checked(self, x, shift=None, stats=None):
        if stats is not None:
            check(x, stats)
        return folded(self, x, shift, stats)

    def forward_checked(self, x, shift=None, stats=None):
        if stats is not None:
            check(x, stats)
        return forward(self, x, shift, stats)
    monkeypatch.setattr(norms.GroupNorm, "folded", folded_checked)
    monkeypatch.setattr(norms.GroupNorm, "forward", forward_checked)
    return seen


def test_unet_norms_read_their_input_as_often_as_jax(unets, checked_sums):
    jm, params, unet = unets
    c = jm.config
    x, ts, ctx, fs = _inputs(c, 2, 77 + c.video_length * c.resampler_queries,
                             1)
    n_jax = _jax_reads(lambda *a: jm.unet.apply({"params": params}, *a),
                       *(jnp.asarray(a) for a in (x, ts, ctx, fs)))
    n_port, out = _port_reads(lambda: unet(
        *(torch.from_numpy(a) for a in (x, ts, ctx, fs))))
    # the init attention, the ResBlock after the downsample, the two output
    # ResBlocks fed a downsampled skip or the upsample's output
    assert n_port == n_jax == 4
    # the norms that folded chained sums: the ResBlocks' and temporal conv
    # blocks', the transformers', the output norm
    assert len(checked_sums) > 20
    assert {len(s) for s in checked_sums} == {4, 5}
    assert torch.isfinite(out).all()


def test_dualref_decode_norms_read_their_input_as_often_as_jax(
        vaes, checked_sums):
    jm, params, pm, taps = vaes
    c = jm.config
    rng = np.random.default_rng(4)
    z = rng.normal(size=(1, c.video_length, c.latent_h, c.latent_w,
                         c.z_channels)).astype(np.float32)
    refs = [rng.normal(size=(1, 2, th, tw, tc)).astype(np.float32)
            for (th, tw, tc) in taps]
    n_jax = _jax_reads(lambda z_, *r: jm.dualref_decoder.apply(
        {"params": params["dualref_decoder"]}, z_, list(r)),
        jnp.asarray(z), *(jnp.asarray(r) for r in refs))
    n_port, out = _port_reads(lambda: pm.first_stage_model.decoder(
        torch.from_numpy(z), [torch.from_numpy(r) for r in refs]))
    # the mid block's two ResnetBlocks and its attention, the fusion
    # attention of levels 2 and 3
    assert n_port == n_jax == 5
    assert len(checked_sums) > 20
    assert torch.isfinite(out).all()


def _cfg_inputs(c, seed):
    """Two CFG branches over one clip: x, t and fs repeated, the context
    differing."""
    x, ts, ctx, fs = _inputs(c, 1, 77 + c.video_length * c.resampler_queries,
                             seed)
    ctx2 = np.concatenate([ctx, np.random.default_rng(seed + 1).normal(
        size=ctx.shape).astype(np.float32)])
    return (np.concatenate([x, x]), np.concatenate([ts, ts]), ctx2,
            np.concatenate([fs, fs]))


def test_cfg_groups_shares_the_stem(unets):
    jm, params, unet = unets
    x, ts, ctx, fs = _cfg_inputs(jm.config, 7)
    rows = []
    hook = unet.input_blocks[0][0].register_forward_pre_hook(
        lambda mod, args: rows.append(args[0].shape[0]))
    try:
        with torch.no_grad():
            t = [torch.from_numpy(a) for a in (x, ts, ctx, fs)]
            shared = unet(*t, cfg_groups=2).numpy()
            whole = unet(*t).numpy()
    finally:
        hook.remove()
    f = jm.config.video_length
    assert rows == [1 * f, 2 * f]  # B/n rows, then B
    ref = np.asarray(jax.jit(functools.partial(
        jm.unet.apply, cfg_groups=2))(
        {"params": params}, *(jnp.asarray(a) for a in (x, ts, ctx, fs))))
    assert np.abs(shared - whole).max() <= 1e-5
    assert np.abs(shared - ref).max() <= 1e-5
    with pytest.raises(ValueError, match="cfg_groups"):
        unet(*(torch.from_numpy(a[:1]) for a in (x, ts, ctx, fs)),
             cfg_groups=2)


def test_ddim_denoise_shares_the_stem_and_matches_jax(unets):
    jm, params, unet = unets
    c = jm.config
    pm = ToonCrafter(ModelConfig().tiny()).eval()
    pm.model.diffusion_model = unet
    rng = np.random.default_rng(11)
    t = c.video_length
    x_T = rng.normal(size=(1, t, c.latent_h, c.latent_w,
                           c.z_channels)).astype(np.float32)
    concat = rng.normal(size=x_T.shape).astype(np.float32)
    ctxs = rng.normal(size=(2, 1, 77 + t * c.resampler_queries,
                            c.context_dim)).astype(np.float32)
    fs = np.array([10.0], np.float32)
    kw = []
    hook = unet.register_forward_pre_hook(
        lambda mod, args, kwargs: kw.append(kwargs.get("cfg_groups")),
        with_kwargs=True)
    try:
        with torch.no_grad():
            out = pm.denoise(*(torch.from_numpy(a) for a in (
                x_T, ctxs, concat, fs)), GuidanceConfig(cfg_scale=7.5),
                ddim_steps=2, eta=0.0)
    finally:
        hook.remove()
    assert kw == [2, 2]
    ref = jm.denoise({"unet": params}, *(jnp.asarray(a) for a in (
        x_T, ctxs, concat, fs)), jax.random.PRNGKey(0),
        JaxGuidance(cfg_scale=7.5), ddim_steps=2, eta=0.0)
    _close(out.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def relpos_unets(unets):
    """The tiny UNet's weights with a (2T + 1, d) table pair added to both
    attentions of every temporal transformer (the tree a rel-pos JAX init
    makes, without its compile)."""
    jc = JaxConfig().tiny(use_relative_position=True)
    jm = JaxToonCrafter(jc)
    t = jc.video_length
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(np.asarray, unets[1])
    params = {k: dict(v) for k, v in params.items()}
    for name, tree in params.items():
        if "temporal" in name or name == "init_attn":
            for blk, sub in tree.items():
                if blk.startswith("block_"):
                    tree[blk] = dict(sub)
                    for attn in ("attn1", "attn2"):
                        tree[blk][attn] = dict(sub[attn], **{
                            f"relative_position_{kv}": rng.normal(
                                0.0, 0.3, (2 * t + 1, jc.num_head_channels)
                            ).astype(np.float32) for kv in "kv"})
    pm = ToonCrafter(ModelConfig().tiny(use_relative_position=True))
    sd = from_jax_params({"unet": params}, pm.config)
    tables = [k for k in sd if k.endswith((
        "relative_position_k.embeddings_table",
        "relative_position_v.embeddings_table"))]
    # attn1 and attn2 of the init attention and of every temporal block
    assert len(tables) == 4 * (1 + 2 + 1 + 4)
    assert sd[tables[0]].shape == (2 * t + 1, jc.num_head_channels)
    pm.unet.load_state_dict(
        {k[len(PREFIX):]: v for k, v in sd.items() if k.startswith(PREFIX)},
        strict=True)
    return jm, params, pm.unet.eval()


def test_relative_position_temporal_transformer_matches_jax(relpos_unets):
    jm, params, unet = relpos_unets
    c = jm.config
    port = unet.input_blocks[1][2]
    assert port.route(c.video_length, c.latent_h * c.latent_w) == "plain"
    x = np.random.default_rng(12).normal(size=(
        2, c.video_length, c.latent_h, c.latent_w,
        c.model_channels)).astype(np.float32)
    heads = c.model_channels // c.num_head_channels
    ref = JaxTT(heads, c.num_head_channels, relative_position=True).apply(
        {"params": params["in_0_0_temporal"]}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    _close(out.numpy(), np.asarray(ref))


def test_relative_position_unet_matches_jax(relpos_unets):
    c = relpos_unets[0].config
    x, ts, ctx, fs = _inputs(c, 2, 77 + c.video_length * c.resampler_queries,
                             13)
    jm, params, unet = relpos_unets
    ref = np.asarray(jax.jit(jm.unet.apply)(
        {"params": params}, *(jnp.asarray(a) for a in (x, ts, ctx, fs))))
    with torch.no_grad():
        out = unet(*(torch.from_numpy(a) for a in (x, ts, ctx, fs))).numpy()
    assert np.abs(ref).max() > 1e-2
    _close(out, ref)
