"""The port's multi-device training (tooncrafter_tpu_torch.parallel.mesh, the
trainer and the checkpoints under a process group) on the CPU, in ranks
spawned over gloo with a ``file://`` store in the test's tmp dir.

  * ``batch_slice`` is the JAX CLI's ``host_shard``; ``make_mesh`` lays
    ranks out as ``arange(world).reshape(n_data, n_model)`` (a model group
    is consecutive ranks, as the JAX package's device mesh) and refuses a
    shape that does not factor the world; a process group of one trains
    bit for bit as one process without a group.
  * Two ranks, the tiny model, a global batch of two (one clip a rank),
    ``grad_clip`` on, the dropout modules passing their input through on
    every side (ranks seed their dropout apart). The first step's reduced
    gradients against ``jax.value_and_grad`` of the JAX ``diffusion_loss``
    jitted over a (2, 1) virtual mesh with the batch sharded over
    ``data``, on the same draws, at tests/test_torch_training.py's bar
    (cosine >= 0.99999, each tensor within 2e-3 of its largest value).
    Then two steps of each of 'adamw', 'adamw_lowmem' and 'adafactor', and
    four AdamW calls with ``grad_accum`` 2 (each rank accumulates, the
    second call reduces), from the same weights: the ranks' trainables
    equal each other bit for bit after every step and the port's single
    process on the global batch within 1e-6 relative (the concatenated L2
    error: the ranks' gradients are summed in another order). The sharded
    optimizer gives each trainable to one rank whole, the ranks' loads
    within the largest tensor of each other.
  * A checkpoint written by the two ranks restores in one process to the
    ranks' trainables, optimizer state and EMA, and one written by one
    process restores in the two ranks to its own.
  * ``graft_entry.dryrun_multidevice(2, "cpu")`` prints its line with
    finite values.
"""

import math
import re
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.cli.inference import host_shard
from tooncrafter_tpu.models.diffusion import ModelConfig as JaxConfig
from tooncrafter_tpu.models.diffusion import ToonCrafter as JaxToonCrafter
from tooncrafter_tpu.parallel import mesh as JM
from tooncrafter_tpu.training import trainer as JT
from tooncrafter_tpu_torch import graft_entry
from tooncrafter_tpu_torch.config import ModelConfig
from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
from tooncrafter_tpu_torch.parallel import mesh as M
from tooncrafter_tpu_torch.parallel import rank_runs
from tooncrafter_tpu_torch.parallel.spawn import run_ranks
from tooncrafter_tpu_torch.training import checkpoints as CKPT
from tooncrafter_tpu_torch.training import trainer as T
from tooncrafter_tpu_torch.utils.weights import init_random_
from test_torch_training import (_assert_grads_match, _batch, _jax_draws,
                                 _jax_tree)

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

# (label, steps[, TrainConfig overrides]); 'accum2' accumulates two calls'
# gradients on each rank and reduces them on the second
PROFILES = (("adamw", 2), ("adamw_lowmem", 2), ("adafactor", 2),
            ("accum2", 4, {"optimizer": "adamw", "grad_accum": 2}))
TRAIN_CONFIG = dict(learning_rate=1e-4, uncond_prob=0.3, grad_clip=0.05)
GEN_SEED = 11
PARAM_MAX_REL = 1e-6


@pytest.mark.parametrize("n_items", range(10))
def test_batch_slice_is_host_shard(n_items):
    for world in range(1, 5):
        got = [M.batch_slice(n_items, r, world) for r in range(world)]
        assert got == [host_shard(n_items, r, world) for r in range(world)]
        assert sum(s.stop - s.start for s in got) == n_items


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_make_mesh_builds_the_data_and_model_axes(n_data, n_model, tmp_path):
    world = n_data * n_model
    got = run_ranks(rank_runs.mesh_layout, world, "cpu",
                    args=(n_data, n_model), timeout=60, threads=1,
                    store_dir=str(tmp_path))
    grid = np.arange(world).reshape(n_data, n_model)
    for r, g in enumerate(got):
        assert g["shape"] == {"data": n_data, "model": n_model}
        assert g["data"] == list(grid[:, r % n_model])
        assert g["model"] == list(grid[r // n_model])


def test_make_mesh_refuses_a_shape_that_does_not_factor_the_world(
        tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        for n_data, n_model in ((1, 2), (2, 1), (None, 2), (1, 0)):
            with pytest.raises(ValueError, match="mesh of"):
                M.make_mesh(n_data=n_data, n_model=n_model)
        mesh = M.make_mesh(n_data=1, n_model=1)
        assert M.model_group(mesh) is None
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tiny():
    pm = ToonCrafter(ModelConfig().tiny(noise_strength=0.1))
    gen = torch.Generator().manual_seed(5)
    init_random_(pm, gen)
    with torch.no_grad():
        for p in pm.parameters():
            if not p.any():
                p.normal_(0.0, 0.05, generator=gen)
    return pm


def test_a_group_of_one_trains_as_one_process(tiny, tmp_path):
    """World 1 over gloo in this process: the all-reduce and the sharded
    optimizer change no bit of two AdamW steps with the clip on."""
    import torch.distributed as dist

    tb = {k: torch.from_numpy(v) for k, v in
          _batch(tiny.config, 1, seed=3).items()}
    tcfg = T.TrainConfig(optimizer="adamw", **TRAIN_CONFIG)
    got = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        for group in (None, dist.group.WORLD):
            model = ToonCrafter(tiny.config)
            model.load_state_dict(tiny.state_dict())
            rank_runs.pass_dropout_(model)
            state, opt = T.make_train_state(model, tcfg, use_ema=True,
                                            group=group)
            step = T.make_train_step(model, opt, tcfg)
            gen = torch.Generator().manual_seed(GEN_SEED)
            for _ in range(2):
                step(state, tb, gen)
            got[group is None] = (state.train_params, state.ema_params)
    finally:
        dist.destroy_process_group()
    for one, grouped in zip(got[True], got[False]):
        _assert_tensors_equal(grouped, one)


def test_dryrun_multidevice_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multidevice(2)


def _jax_sharded_grads(pm, batch, key):
    """The JAX loss's gradients, jitted over a (2, 1) virtual mesh with the
    batch sharded over 'data', dropout held out."""
    jm = JaxToonCrafter(JaxConfig().tiny(noise_strength=0.1))
    train, frozen = JT.split_trainable(_jax_tree(pm))
    mesh = JM.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
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
    draws = _jax_draws(key, jm.config, 2, jm.schedule.num_timesteps)
    return float(loss), grads, {k: torch.from_numpy(np.array(v))
                                for k, v in draws.items()}


def _single_process(pm, tb, ckpt_dir):
    """Each profile's two steps in one process on the global batch, from
    the fixture's weights; the first profile's checkpoint in ckpt_dir."""
    out, states = {}, {}
    for i, (name, steps, *over) in enumerate(PROFILES):
        model = ToonCrafter(pm.config)
        model.load_state_dict(pm.state_dict())
        rank_runs.pass_dropout_(model)
        tcfg = T.TrainConfig(**{"optimizer": name, **TRAIN_CONFIG,
                                **(over[0] if over else {})})
        state, opt = T.make_train_state(model, tcfg, use_ema=True)
        step = T.make_train_step(model, opt, tcfg)
        gen = torch.Generator().manual_seed(GEN_SEED)
        for _ in range(steps):
            _, metrics = step(state, tb, gen)
            assert float(metrics["grad_norm"]) > TRAIN_CONFIG["grad_clip"]
        out[name] = {k: p.detach().clone() for k, p in
                     state.train_params.items()}
        states[name] = state
        if i == 0:
            CKPT.save_train_state(ckpt_dir, state.step, state)
    return out, states


def _opt_by_name(state):
    return rank_runs.owned_state(state)


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert set(a[n]) == set(b[n]), n
        for k in a[n]:
            x, y = a[n][k], b[n][k]
            if torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), \
                    (n, k)
            else:
                assert x == y, (n, k)


def _assert_tensors_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n].cpu(), b[n].cpu()), n


def test_two_ranks_train_as_one_process(tiny, tmp_path):
    batch = _batch(tiny.config, 2, seed=4)
    key = jax.random.PRNGKey(7)
    ref_loss, ref_grads, draws = _jax_sharded_grads(tiny, batch, key)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    single, states = _single_process(tiny, tb, str(tmp_path / "ck1"))
    spec = {"config": tiny.config, "state_dict": tiny.state_dict(),
            "batch": tb, "first_draws": draws, "train_config": TRAIN_CONFIG,
            "pass_dropout": True, "profiles": PROFILES, "gen_seed": GEN_SEED,
            "return_params": True,
            "save_dir": str(tmp_path / "ck2"),
            "restore_dir": str(tmp_path / "ck1")}
    t0 = time.perf_counter()
    r0, r1 = run_ranks(rank_runs.train, 2, "cpu", args=(spec,),
                       timeout=240, threads=1, store_dir=str(tmp_path))
    print(f"two training ranks: {time.perf_counter() - t0:.1f} s, rank 0's "
          f"seconds by part { {k: round(v, 2) for k, v in r0['clock'].items()} }")
    assert r0["mesh"] == {"data": 2, "model": 1}

    # each trainable owned whole by one rank, the loads balanced
    sizes = {k: v.numel() for k, v in single[PROFILES[0][0]].items()}
    assert sorted(r0["owned"] + r1["owned"]) == sorted(sizes)
    loads = [sum(sizes[n] for n in r["owned"]) for r in (r0, r1)]
    assert abs(loads[0] - loads[1]) <= max(sizes.values()), loads

    # the first step's reduced gradients against the JAX sharded step
    assert r0["first_loss"] == pytest.approx(ref_loss, rel=1e-5)
    assert r0["grads_digest"] == r1["grads_digest"]
    _assert_grads_match({k: v.numpy() for k, v in r0["grads"].items()},
                        ref_grads, tiny)

    # every profile: equal ranks, and the single process within 1e-6
    sd = tiny.state_dict()
    for name, *_ in PROFILES:
        a, b = r0["profiles"][name], r1["profiles"][name]
        assert a["digests"] == b["digests"], name
        rel = rank_runs.relative_l2(a["params"], single[name])
        moved = rank_runs.relative_l2(a["params"],
                                      {k: sd[k] for k in single[name]})
        print(f"{name}: relative L2 to the single process {rel:.3e}, "
              f"moved {moved:.3e} from the start")
        assert rel <= PARAM_MAX_REL, (name, rel)
        assert moved > 1e3 * PARAM_MAX_REL, (name, moved)

    # two ranks -> one process
    name = PROFILES[0][0]
    model = ToonCrafter(tiny.config)
    rank_runs.pass_dropout_(model)
    state, _ = T.make_train_state(
        model, T.TrainConfig(optimizer=name, **TRAIN_CONFIG), use_ema=True)
    _, step = CKPT.restore_train_state(str(tmp_path / "ck2"), state)
    assert step == PROFILES[0][1] == state.step
    _assert_tensors_equal(state.train_params, r0["profiles"][name]["params"])
    _assert_tensors_equal(state.ema_params, r0["saved"]["ema"])
    _assert_tensors_equal(r0["saved"]["ema"], r1["saved"]["ema"])
    assert not set(r0["saved"]["opt"]) & set(r1["saved"]["opt"])
    _assert_states_equal(_opt_by_name(state),
                         {**r0["saved"]["opt"], **r1["saved"]["opt"]})

    # one process -> two ranks
    one = states[name]
    for r in (r0, r1):
        assert r["restored"]["step"] == one.step
        _assert_tensors_equal(r["restored"]["params"], one.train_params)
        _assert_tensors_equal(r["restored"]["ema"], one.ema_params)
    _assert_states_equal({**r0["restored"]["opt"], **r1["restored"]["opt"]},
                         _opt_by_name(one))


def test_dryrun_multidevice_on_two_ranks(capsys):
    vals = graft_entry.dryrun_multidevice(2, "cpu")
    line = capsys.readouterr().out
    assert re.search(r"dryrun_multidevice OK on 2 ranks \(mesh \{'data': 2, "
                     r"'model': 1\}", line), line
    for k in ("loss", "val", "val_ema", "decode_checksum"):
        assert f"{k}=" in line and math.isfinite(vals[k]), (k, line)
