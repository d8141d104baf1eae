"""The port's rank-sharded serving (tooncrafter_tpu_torch.parallel.serving.
BatchedPipeline) on the CPU: two ranks spawned over gloo with a
``file://`` store in the test's tmp dir serve a ragged batch of three clips
(rank 0 runs clips 0-1, rank 1 clip 2) at the tiny config in fp32, DDIM-3,
CFG 7.5 with rescale 0.7, the middle-frame splice, eta 0 and an explicit
x_T (jax.random streams cannot be reproduced in torch). Every rank returns
the three clips in order. Held against the JAX package's pipeline on the
same weights and inputs at tests/test_torch_pipeline.py's bar (each frame's
PSNR >= 40 dB), and against the port's Pipeline in one process on the
same micro-batches (clips 0-1 together, clip 2 alone) within 1e-5 (the
whole batch of three in one call sums in other orders: 1.7e-5 apart).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tooncrafter_tpu.utils.metrics import psnr
from tooncrafter_tpu_torch.models.diffusion import Pipeline
from tooncrafter_tpu_torch.parallel import rank_runs
from tooncrafter_tpu_torch.parallel.serving import BatchedPipeline
from tooncrafter_tpu_torch.parallel.spawn import run_ranks
from tooncrafter_tpu_torch.sampling.ddim import GuidanceConfig
from test_torch_pipeline import _inputs, _jax_pipeline, both  # noqa: F401

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

STEPS = 3
GUIDANCE = dict(cfg_scale=7.5, guidance_rescale=0.7)


def _batch_of_three(c):
    parts = [_inputs(c, seed) for seed in (0, 1, 2)]
    video, tokens, null_tokens, x_T, fs = (np.concatenate(p) for p in
                                           zip(*parts))
    return video, tokens, null_tokens, x_T, fs


def test_two_ranks_serve_a_ragged_batch(both, tmp_path):
    jm, params, pm = both
    video, tokens, null_tokens, x_T, fs = _batch_of_three(pm.config)
    ref = _jax_pipeline(jm, params, video, tokens, null_tokens, x_T, fs,
                        STEPS)
    inputs = [torch.from_numpy(a) for a in (video, tokens, null_tokens, fs)]
    pipe_kw = dict(ddim_steps=STEPS, eta=0.0, guidance=GUIDANCE)
    pipe = Pipeline(pm, ddim_steps=STEPS, eta=0.0,
                    guidance=GuidanceConfig(**GUIDANCE))
    single = np.concatenate([
        pipe(*(a[s] for a in inputs), x_T=torch.from_numpy(x_T[s])).numpy()
        for s in (slice(0, 2), slice(2, 3))])
    spec = {"config": pm.config, "state_dict": pm.state_dict(),
            "inputs": inputs, "x_T": torch.from_numpy(x_T),
            "pipeline": pipe_kw}
    t0 = time.perf_counter()
    r0, r1 = run_ranks(rank_runs.serve, 2, "cpu", args=(spec,), timeout=240,
                       threads=1, store_dir=str(tmp_path))
    print(f"two serving ranks: {time.perf_counter() - t0:.1f} s")
    assert (r0["clips_here"], r1["clips_here"]) == (2, 1)
    assert r0["digest"] == r1["digest"]
    out = r0["clips"]
    assert out.shape == video.shape == ref.shape and np.isfinite(out).all()
    gap = float(np.abs(out - single).max())
    db = np.asarray(psnr(jnp.asarray(ref), jnp.asarray(out)))
    print(f"ragged batch of 3 on 2 ranks: min PSNR against JAX "
          f"{db.min():.1f} dB, max abs against one process on the same "
          f"micro-batches {gap:.3e}")
    assert db.min() >= 40.0, db
    assert gap <= 1e-5, gap


def test_one_process_without_a_group(both):
    """Without a group the wrapper is the pipeline on the whole batch, clip
    i's noise from the generator of (seed, indices[i]); a wrong count of
    indices, and x_T with eta > 0, are refused."""
    _, _, pm = both
    video, tokens, null_tokens, _, fs = _batch_of_three(pm.config)
    inputs = [torch.from_numpy(a) for a in (video, tokens, null_tokens, fs)]
    pipe = Pipeline(pm, ddim_steps=2, guidance=GuidanceConfig(**GUIDANCE))
    from tooncrafter_tpu_torch.utils import rngs as R
    got = BatchedPipeline(pipe)(*inputs, seed=5, indices=[4, 1, 7])
    want = pipe(*inputs, generator=R.per_item_generators(5, [4, 1, 7]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="indices"):
        BatchedPipeline(pipe)(*inputs, seed=5, indices=[0])
    with pytest.raises(ValueError, match="eta 0"):
        BatchedPipeline(pipe)(*inputs, x_T=torch.zeros(3))
