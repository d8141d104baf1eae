"""Tensor parallelism over the mesh's ``model`` axis
(tooncrafter_tpu_torch.parallel.tensor) on the CPU, at the tiny config in
fp32; ranks spawned over gloo with a ``file://`` store in the test's tmp
dir.

  * Layout: heads split in contiguous groups by ``batch_slice`` (uneven
    splits allowed), the GEGLU projection's value rows kept beside their
    own gate rows, every sharded tensor's pieces joined back to the whole
    under its name; the UNet's transformer-block 2-D kernels that the JAX
    rule (``param_partition_spec``) shards at n_model = 2 are exactly the
    ones the port shards (the placement differs: row-parallel out
    projections, heads split whole).
  * Partial plain versions: the fused feed-forward (#7/#8) and the single
    temporal stage (#10) on a rank's share of D or of the heads give fp32
    accumulators whose sum, finished with the bias and the residual, is
    the whole call's plain version and the JAX kernel in interpret mode.
  * Two ranks at (1, 2): the UNet forward against the JAX UNet with the
    same weights (tests/test_torch_unet.py's bar, 2e-4 of the output's
    magnitude) and bit for bit across the ranks; the gathered state dict
    is the whole one. One AdamW training step with the clip on against the
    JAX loss's gradients jitted over a (1, 2) virtual mesh with
    ``shard_params`` and optax's update of them, on the same draws,
    dropout held out of both sides (tests/test_torch_training.py's
    gradient bars; the updated trainables within 1e-6 relative).
    A checkpoint written at (1, 2) restores in one process, and one written
    by one process restores at (1, 2). ``BatchedPipeline(shard_params=True)``
    against one process within 5e-5 (fp32 sums in another order).
  * Four ranks at (2, 2), a model whose first level's 3 heads split 2 + 1:
    one step against the port's single process on the global batch, equal
    across the data ranks, its checkpoint restored in one process.
"""

import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.ops import fused_ff as jff
from tooncrafter_tpu.ops import temporal_attention as jta
from tooncrafter_tpu.parallel import mesh as JM
from tooncrafter_tpu.training import trainer as JT
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import Pipeline, ToonCrafter
from tooncrafter_tpu_torch.models.unet import BasicTransformerBlock
from tooncrafter_tpu_torch.ops import fused_ff as ff
from tooncrafter_tpu_torch.ops import temporal_attention as ta
from tooncrafter_tpu_torch.parallel import rank_runs
from tooncrafter_tpu_torch.parallel import tensor as TP
from tooncrafter_tpu_torch.parallel.spawn import run_ranks
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from tooncrafter_tpu_torch.training import checkpoints as CKPT
from tooncrafter_tpu_torch.training import trainer as T
from tooncrafter_tpu_torch.utils import checkpoint as ckpt
from tooncrafter_tpu_torch.utils.weights import from_jax_params, init_random_
from test_torch_parallel import tiny  # noqa: F401
from test_torch_pipeline import _inputs
from test_torch_training import (_assert_grads_match, _batch, _jax_draws,
                                 _jax_tree)
from test_torch_unet import _close

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

TRAIN_CONFIG = dict(learning_rate=1e-4, uncond_prob=0.3, grad_clip=0.05)
PARAM_MAX_REL = 1e-6
# the clips of two DDIM steps at CFG 7.5 against one process: the sharded
# sub-blocks sum their heads in another order (the UNet ~2e-6 of its
# output apart), which the guided steps and the decoder carry to ~1.2e-5
SERVE_MAX_ABS = 5e-5


def _shard(heads, dim_head, d_ff, size, rank=0):
    return TP.Shard(None, rank, size, heads, dim_head, d_ff)


@pytest.mark.parametrize("heads,size,want", [
    (5, 2, [3, 2]), (5, 4, [2, 1, 1, 1]), (10, 2, [5, 5]), (20, 4, [5] * 4),
    (2, 2, [1, 1])])
def test_heads_split_in_contiguous_groups(heads, size, want):
    sh = _shard(heads, 64, 4 * heads * 64, size)
    got = [sh.heads_of(r) for r in range(size)]
    assert [s.stop - s.start for s in got] == want
    assert [s.start for s in got] == list(np.cumsum([0] + want[:-1]))
    assert [_shard(heads, 64, 1, size, r).local_heads
            for r in range(size)] == want
    # the FF's width in 64-column units the same way: 1280 -> 640 + 640
    d = 4 * heads * 64
    assert sum(sh.ff_of(r).stop - sh.ff_of(r).start
               for r in range(size)) == d
    assert all((sh.ff_of(r).stop - sh.ff_of(r).start) % 64 == 0
               for r in range(size))


def test_geglu_keeps_each_value_with_its_gate():
    """Rank r's projection holds value rows s_r and gate rows D + s_r, so
    its chunk(2) pairs value column j with gate column j; a contiguous
    split of 2D would not."""
    d, c, size = 256, 8, 2
    sh = _shard(2, 32, d, size)
    blk = BasicTransformerBlock(64, 2, 32, None, cross=False)
    lay = TP.block_layouts(sh, blk)["ff.net.0.proj.weight"]
    rows = torch.arange(2 * d, dtype=torch.float32)[:, None].expand(2 * d, c)
    for r in range(size):
        local = TP.local_of(rows, lay, r)
        h, g = local.chunk(2)
        assert torch.equal(g - h, torch.full_like(h, float(d)))
        s = sh.ff_of(r)
        assert torch.equal(h[:, 0], torch.arange(s.start, s.stop).float())


def test_pieces_join_to_the_whole_under_their_names(tiny):
    """Every sharded tensor of the tiny UNet: each rank's piece, joined in
    rank order, is the whole tensor; the names are the model's own."""
    sd = tiny.state_dict()
    names = set()
    for prefix, blk in TP._unet_blocks(tiny):
        sh = _shard(blk.attn1.heads, blk.attn1.dim_head,
                    blk.ff.net[2].weight.shape[1], 2)
        for n, lay in TP.block_layouts(sh, blk).items():
            key = f"{prefix}.{n}"
            assert key in sd
            pieces = [TP.local_of(sd[key], lay, r) for r in range(2)]
            assert sum(p.shape[lay[0]] for p in pieces) == sd[key].shape[
                lay[0]]
            assert torch.equal(TP.whole_of(pieces, lay), sd[key])
            names.add(key)
    assert len(names) >= 20


def test_the_jax_rules_sharded_kernels_are_the_ports(tiny):
    """Each UNet transformer-block 2-D kernel that the JAX rule shards over
    'model' at n_model = 2 is sharded by the port, and no other tensor."""
    mesh = JM.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    sd = tiny.state_dict()
    port = set()
    for prefix, blk in TP._unet_blocks(tiny):
        sh = _shard(blk.attn1.heads, blk.attn1.dim_head,
                    blk.ff.net[2].weight.shape[1], 2)
        port |= {f"{prefix}.{n}" for n in TP.block_layouts(sh, blk)}
    jax_sharded = set()
    for jpath, tkey, fn in ckpt.full_mapping(tiny.config)["unet"]:
        if tkey not in sd or ".transformer_blocks." not in tkey:
            continue
        leaf = np.zeros(fn(sd[tkey].numpy()).shape, np.float32)
        spec = JM.param_partition_spec(tuple(jpath), leaf, mesh)
        if spec == JM.P(None, "model"):
            jax_sharded.add(tkey)
    assert jax_sharded and jax_sharded == {k for k in port if
                                           k.endswith(".weight")}
    # the GEGLU bias follows its weight's rows; nothing else shards
    assert port - jax_sharded == {k for k in port if k.endswith(
        "ff.net.0.proj.bias")}


# ---------------------------------------------------------------------------
# the partial plain versions
# ---------------------------------------------------------------------------

def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s, sc=1.0, off=0.0: torch.from_numpy(
        (rng.normal(size=s) * sc + off).astype(np.float32))


def test_partial_ff_sums_to_the_whole_call(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)
    n, c, d = 256, 64, 256
    f = _rng(0)
    x, w1, b1 = f(n, c), f(2 * d, c, sc=c ** -0.5), f(2 * d, sc=0.1)
    w2, b2 = f(c, d, sc=d ** -0.5), f(c, sc=0.1)
    lw, lb = f(c, sc=0.1, off=1.0), f(c, sc=0.1)
    whole = ff.fused_geglu_ff(x, w1, b1, w2, b2, lw, lb, 1e-5, True)
    want = np.asarray(jff.fused_geglu_ff(
        *(jnp.asarray(t.numpy()) for t in (x, w1.T, b1, w2.T, b2, lw, lb)),
        1e-5, True))
    for size in (2, 4):
        sh = _shard(1, 64, d, size)
        blk = BasicTransformerBlock(c, 1, 64, None, cross=False)
        lays = TP.block_layouts(sh, blk)
        acc = sum(ff.fused_geglu_ff(
            x, TP.local_of(w1, lays["ff.net.0.proj.weight"], r),
            TP.local_of(b1, lays["ff.net.0.proj.bias"], r),
            TP.local_of(w2, lays["ff.net.2.weight"], r), None, lw, lb, 1e-5,
            partial=True, name_d=d) for r in range(size))
        assert acc.dtype == torch.float32
        got = ff.finish(acc, b2, x)
        torch.testing.assert_close(got, whole, rtol=0,
                                   atol=2e-6 * float(whole.abs().max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("heads,size", [(2, 2), (5, 2), (5, 4)])
def test_partial_temporal_stage_sums_to_the_whole_call(monkeypatch, heads,
                                                       size):
    monkeypatch.setattr(jta, "_INTERPRET", True)
    b, t, p, c = 2, 4, 32, heads * 64
    f = _rng(heads + size)
    x = f(b, t, p, c, sc=2.0, off=0.5)
    lnw, lnb = f(c, sc=0.1, off=1.0), f(c, sc=0.1)
    wq, wk, wv, wo = (f(c, c, sc=c ** -0.5) for _ in range(4))
    bo = f(c, sc=0.1)
    scale = 0.125
    whole = ta._fused_tattn_call(x, (lnw, lnb, wq, wk, wv, wo, bo), heads,
                                 scale)
    want = np.asarray(jta._fused_tattn_call(
        jnp.asarray(x.transpose(1, 2).numpy()), jnp.asarray(lnw.numpy()),
        jnp.asarray(lnb.numpy()),
        jnp.concatenate([jnp.asarray(w.T.numpy()) for w in (wq, wk, wv)], 1),
        jnp.asarray(wo.T.numpy()), jnp.asarray(bo.numpy()), heads, scale,
        1e-5)).transpose(0, 2, 1, 3)
    acc = 0
    for r in range(size):
        sh = _shard(heads, 64, 4 * c, size, r)
        rows = slice(sh.heads_of(r).start * 64, sh.heads_of(r).stop * 64)
        stage = (lnw, lnb, wq[rows], wk[rows], wv[rows],
                 wo[:, rows].contiguous(), None)
        assert ta.covers(t, 64, c, rows.stop - rows.start)
        acc = acc + ta._fused_tattn_call(x, stage, sh.local_heads, scale,
                                         partial=True)
    got = ff.finish(acc, bo, x)
    torch.testing.assert_close(got, whole, rtol=0,
                               atol=2e-6 * float(whole.abs().max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# two ranks at (1, 2)
# ---------------------------------------------------------------------------

def _unet_inputs(c, b, seed):
    rng = np.random.default_rng(seed)
    t = c.video_length
    x = rng.normal(size=(b, t, c.latent_h, c.latent_w,
                         c.unet_in_channels)).astype(np.float32)
    ctx = rng.normal(size=(b, 77 + t * c.resampler_queries,
                           c.context_dim)).astype(np.float32)
    return (x, np.array([999.0, 321.0][:b], np.float32), ctx,
            np.array([10.0, 24.0][:b], np.float32))


def test_unet_forward_at_1x2_matches_jax(tiny, tmp_path):
    pm = tiny
    x, ts, ctx, fs = _unet_inputs(pm.config, 2, 0)
    jm = JaxToonCrafter(JaxConfig().tiny(noise_strength=0.1))
    params = _jax_tree(pm)["unet"]
    want = np.asarray(jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params, *(jnp.asarray(a) for a in (x, ts, ctx, fs))))
    spec = {"config": pm.config, "state_dict": pm.state_dict(), "n_model": 2,
            "inputs": tuple(torch.from_numpy(a) for a in (x, ts, ctx, fs)),
            "report_shapes": (
                "model.diffusion_model.input_blocks.1.1.transformer_blocks."
                "0.attn1.to_q.weight",
                "model.diffusion_model.input_blocks.1.1.transformer_blocks."
                "0.ff.net.0.proj.weight")}
    res = run_ranks(rank_runs.unet_forward, 2, "cpu", args=(spec,),
                    timeout=120, threads=1, store_dir=str(tmp_path))
    assert res[0]["mesh"] == {"data": 1, "model": 2}
    assert all(r["gather_equal"] for r in res)
    assert res[0]["digest"] == res[1]["digest"]
    c = pm.config.model_channels  # 2 heads of 32 at the first level
    assert list(res[0]["shapes"].values()) == [(32, c), (4 * c, c)]
    _close(res[0]["out"].numpy(), want)


def test_bf16_sharded_unet_is_as_close_to_fp32_as_one_process(tmp_path):
    """In bf16 the sharded path's fp32 partial sums round elsewhere than
    one process's products, so the two outputs differ at the bf16 floor
    (about as much as one process at batch 2 and at batch 1 differ); held
    here: the sharded output is no further from the fp32 output of the
    same (bf16-valued) weights than one process's is."""
    import dataclasses

    cfg = dataclasses.replace(ModelConfig().tiny(model_channels=192,
                                                 num_head_channels=64),
                              compute_dtype=torch.bfloat16)
    pm = ToonCrafter(cfg)
    init_random_(pm, torch.Generator().manual_seed(5))
    pm.to_compute_dtype().eval()
    x, ts, ctx, fs = (torch.from_numpy(a) for a in _unet_inputs(cfg, 2, 0))
    x, ctx = x.bfloat16(), ctx.bfloat16()
    with torch.no_grad():
        one = pm.unet(x, ts, ctx, fs).float()
        ref = ToonCrafter(dataclasses.replace(
            cfg, compute_dtype=torch.float32))
        ref.load_state_dict({k: v.float() for k, v in
                             pm.state_dict().items()})
        exact = ref.eval().unet(x.float(), ts, ctx.float(), fs).float()
    spec = {"config": cfg, "state_dict": pm.state_dict(), "n_model": 2,
            "inputs": (x, ts, ctx, fs)}
    res = run_ranks(rank_runs.unet_forward, 2, "cpu", args=(spec,),
                    timeout=120, threads=1, store_dir=str(tmp_path))
    assert res[0]["digest"] == res[1]["digest"]

    def db(a, b):
        return float(10 * torch.log10(b.abs().max() ** 2
                                      / (a - b).square().mean()))
    tp, base = db(res[0]["out"], exact), db(one, exact)
    print(f"bf16 against fp32: sharded {tp:.2f} dB, one process "
          f"{base:.2f} dB; sharded against one process "
          f"{db(res[0]['out'], one):.2f} dB")
    assert tp >= base - 1.0, (tp, base)


def _jax_sharded_step(pm, batch, key):
    """The JAX loss's gradients jitted over a (1, 2) virtual mesh with the
    trainables placed by ``shard_params``, dropout held out; then optax's
    update of them. Returns (loss, grads, updated trainables by port name,
    the port's draws)."""
    jm = JaxToonCrafter(JaxConfig().tiny(noise_strength=0.1))
    train, frozen = JT.split_trainable(_jax_tree(pm))
    mesh = JM.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    train = jax.device_put(train, JM.shard_params(train, mesh))
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                        JM.batch_sharding(mesh))

    def f(tp):
        return JT.diffusion_loss(jm, tp, frozen, jb, key,
                                 uncond_prob=TRAIN_CONFIG["uncond_prob"],
                                 train=True)
    orig = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(train)
    finally:
        fnn.Dropout.__call__ = orig
    opt = JT.make_optimizer(JT.TrainConfig(**TRAIN_CONFIG))
    upd, _ = opt.update(grads, opt.init(train), train)
    new = from_jax_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(train, upd)), pm.config)
    draws = _jax_draws(key, jm.config, 2, jm.schedule.num_timesteps)
    return float(loss), grads, new, {k: torch.from_numpy(np.array(v))
                                     for k, v in draws.items()}


def _one_process_step(pm, tb, draws, ckpt_dir):
    model = ToonCrafter(pm.config)
    model.load_state_dict(pm.state_dict())
    rank_runs.pass_dropout_(model)
    tcfg = T.TrainConfig(optimizer="adamw", **TRAIN_CONFIG)
    state, opt = T.make_train_state(model, tcfg, use_ema=True)
    T.make_train_step(model, opt, tcfg)(state, tb, None, draws)
    CKPT.save_train_state(ckpt_dir, state.step, state)
    return state


def _assert_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n].cpu(), b[n].cpu()), n


def test_train_step_at_1x2_matches_the_jax_sharded_step(tiny, tmp_path):
    batch = _batch(tiny.config, 2, seed=4)
    ref_loss, ref_grads, ref_new, draws = _jax_sharded_step(
        tiny, batch, jax.random.PRNGKey(7))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = _one_process_step(tiny, tb, draws, str(tmp_path / "ck1"))
    spec = {"config": tiny.config, "state_dict": tiny.state_dict(),
            "batch": tb, "first_draws": draws, "profile_draws": draws,
            "train_config": TRAIN_CONFIG, "pass_dropout": True,
            "profiles": (("adamw", 1),), "return_params": True, "n_model": 2,
            "save_dir": str(tmp_path / "ck2"),
            "restore_dir": str(tmp_path / "ck1")}
    t0 = time.perf_counter()
    r0, r1 = run_ranks(rank_runs.train, 2, "cpu", args=(spec,), timeout=240,
                       threads=1, store_dir=str(tmp_path))
    print(f"(1, 2) training ranks: {time.perf_counter() - t0:.1f} s")
    assert r0["mesh"] == {"data": 1, "model": 2}
    assert r0["first_loss"] == pytest.approx(ref_loss, rel=1e-5)
    _assert_grads_match({k: v.numpy() for k, v in r0["grads"].items()},
                        ref_grads, tiny)
    got = r0["profiles"]["adamw"]["params"]
    rel = rank_runs.relative_l2(got, ref_new)
    moved = rank_runs.relative_l2(got, {k: tiny.state_dict()[k]
                                        for k in ref_new})
    print(f"(1, 2) step against the JAX sharded step: relative L2 "
          f"{rel:.3e}, moved {moved:.3e}")
    assert rel <= PARAM_MAX_REL and moved > 1e3 * PARAM_MAX_REL

    # (1, 2) -> one process: whole tensors under the lvdm names
    model = ToonCrafter(tiny.config)
    rank_runs.pass_dropout_(model)
    state, _ = T.make_train_state(model, T.TrainConfig(**TRAIN_CONFIG),
                                  use_ema=True)
    _, step = CKPT.restore_train_state(str(tmp_path / "ck2"), state)
    assert step == 1
    _assert_equal(state.train_params, got)
    _assert_equal(state.ema_params, r0["saved"]["ema"])
    want_opt = r0["saved"]["opt"]
    for n, st in rank_runs.owned_state(state).items():
        for k, v in st.items():
            if torch.is_tensor(v):
                assert torch.equal(v, want_opt[n][k]), (n, k)
    # one process -> (1, 2): each rank's pieces, gathered, are the file's
    for r in (r0, r1):
        assert r["restored"]["step"] == one.step
        _assert_equal(r["restored"]["params"], one.train_params)
        _assert_equal(r["restored"]["ema"], one.ema_params)
    whole = rank_runs.owned_state(one)
    for n, st in r0["restored"]["opt"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                assert torch.equal(v, whole[n][k]), (n, k)


def test_batched_pipeline_shard_params_at_1x2(tiny, tmp_path):
    pm = ToonCrafter(tiny.config)
    pm.load_state_dict(tiny.state_dict())
    pm.eval()
    parts = [_inputs(pm.config, seed) for seed in (0, 1)]
    video, tokens, null_tokens, x_T, fs = (np.concatenate(p)
                                           for p in zip(*parts))
    inputs = [torch.from_numpy(a) for a in (video, tokens, null_tokens, fs)]
    guidance = dict(cfg_scale=7.5, guidance_rescale=0.7)
    single = Pipeline(pm, ddim_steps=2, eta=0.0,
                      guidance=GuidanceConfig(**guidance))(
        *inputs, x_T=torch.from_numpy(x_T)).numpy()
    spec = {"config": pm.config, "state_dict": pm.state_dict(),
            "inputs": inputs, "x_T": torch.from_numpy(x_T), "n_model": 2,
            "pipeline": dict(ddim_steps=2, eta=0.0, guidance=guidance)}
    r0, r1 = run_ranks(rank_runs.serve, 2, "cpu", args=(spec,), timeout=120,
                       threads=1, store_dir=str(tmp_path))
    assert r0["mesh"] == {"data": 1, "model": 2}
    assert (r0["clips_here"], r1["clips_here"]) == (2, 2)
    assert r0["digest"] == r1["digest"]
    gap = float(np.abs(r0["clips"] - single).max())
    print(f"(1, 2) serving against one process: max abs {gap:.3e}")
    assert r0["clips"].shape == video.shape and gap <= SERVE_MAX_ABS, gap


# ---------------------------------------------------------------------------
# four ranks at (2, 2)
# ---------------------------------------------------------------------------

def test_four_ranks_at_2x2_step_as_one_process(tmp_path):
    """A tiny model of 3 heads at its first level (split 2 + 1: the model
    ranks' shards, and so their optimizers' owner splits, differ in size):
    one step at (2, 2) against one process on the global batch, equal
    across the data ranks; its checkpoint restores in one process to the
    gathered trainables."""
    cfg = ModelConfig().tiny(noise_strength=0.1, model_channels=96)
    pm = ToonCrafter(cfg)
    init_random_(pm, torch.Generator().manual_seed(6))
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, seed=4).items()}
    draws = T.sample_draws(pm, tb["video"], torch.Generator().manual_seed(3))
    one = _one_process_step(pm, tb, draws, str(tmp_path / "ck1"))
    spec = {"config": cfg, "state_dict": pm.state_dict(),
            "batch": tb, "profile_draws": draws,
            "train_config": TRAIN_CONFIG, "pass_dropout": True,
            "profiles": (("adamw", 1),), "return_params": True, "n_model": 2,
            "save_dir": str(tmp_path / "ck4")}
    res = run_ranks(rank_runs.train, 4, "cpu", args=(spec,), timeout=240,
                    threads=1, store_dir=str(tmp_path))
    assert res[0]["mesh"] == {"data": 2, "model": 2}
    d = [r["profiles"]["adamw"]["digests"] for r in res]
    assert d[0] == d[2] and d[1] == d[3] and d[0] != d[1]
    got = res[0]["profiles"]["adamw"]["params"]
    rel = rank_runs.relative_l2(got, {k: p.detach() for k, p in
                                      one.train_params.items()})
    print(f"(2, 2) step against one process: relative L2 {rel:.3e}")
    assert rel <= PARAM_MAX_REL, rel
    model = ToonCrafter(cfg)
    rank_runs.pass_dropout_(model)
    state, _ = T.make_train_state(model, T.TrainConfig(**TRAIN_CONFIG),
                                  use_ema=True)
    _, step = CKPT.restore_train_state(str(tmp_path / "ck4"), state)
    assert step == 1
    _assert_equal(state.train_params, got)
    _assert_equal(state.ema_params, res[0]["saved"]["ema"])


def test_adafactor_is_refused_under_a_model_axis():
    """Adafactor's factored moments are the whole tensor's: refused before
    any collective under a model axis of more than one rank."""
    class _Mesh:
        shape = (1, 2)
        mesh_dim_names = ("data", "model")

        def get_group(self, name):
            return object()
    with pytest.raises(NotImplementedError, match="adafactor"):
        T.make_train_state(ToonCrafter.__new__(ToonCrafter),
                           T.TrainConfig(optimizer="adafactor"),
                           group=_Mesh())
