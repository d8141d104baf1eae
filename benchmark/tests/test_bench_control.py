"""The comparison that decides ``correct`` fails what it must: the control
(the reference with fp8 products and a bfloat16 sampler state, put in the
program's place) and the timed path broken underneath a whole run, at the
tiny size on the CPU. The same control at the cells' own sizes is
``benchmark/calibrate.py`` on the card."""

import math

import pytest
import torch

from benchmark.tests import _tiny
from benchmark.traffic import i2v


def _failed(checks):
    return [k for k, (v, lim) in checks.items()
            if v is None or not math.isfinite(v) or v > lim]


@pytest.mark.parametrize("cell", ["i2v512-b1", "i2v512-b2"])
def test_the_control_is_not_correct(cell):
    torch.set_num_threads(1)
    ctx = _tiny.context(cell)
    cfg, mix = ctx.config, ctx.mix
    ref = i2v.build_reference(cfg, ctx.seed, "cpu")
    req = i2v.request(ctx.seed, 0, mix["batch"], cfg, mix, "cpu")
    i2v.RM.set_ops(ref, i2v.RM.Ops(fp8=True))
    rec = i2v.control_record(ref, req, cfg, mix, "cpu")
    i2v.RM.set_ops(ref, i2v.RM.Ops())
    steps = i2v.unet_steps(ctx.seed, mix["ddim_steps"])
    got = i2v.compare(ref, rec, req, cfg, mix, steps, "cpu")
    checks = {k: (got[k], lim) for k, lim in mix["limits"].items()}
    assert _failed(checks), checks


def _state_unchanged(monkeypatch):
    """The sampler's last step returns the state it was given."""
    from tooncrafter_tpu_torch.models import diffusion as D

    orig = D.ddim_sample

    def sample(denoiser, *args, **kw):
        seen = []

        def spy(xin, *a, **k):
            seen.append(xin)
            return denoiser(xin, *a, **k)

        orig(spy, *args, **kw)
        b = args[2].shape[0]
        return seen[-1][:b, ..., :args[2].shape[-1]].clone()

    monkeypatch.setattr(D, "ddim_sample", sample)


def _clip_altered(monkeypatch):
    """One frame of the clip changed where the decoder produces it."""
    from tooncrafter_tpu_torch.models import diffusion as D

    orig = D.middle_frame_splice

    def splice(*a, **k):
        out = orig(*a, **k)
        out[:, 3] = -out[:, 3]
        return out

    monkeypatch.setattr(D, "middle_frame_splice", splice)


def _half_batch(monkeypatch):
    """Half of the batch served, its clips given to the other half."""
    from tooncrafter_tpu_torch.models import diffusion as D

    orig = D.Pipeline.__call__

    def call(self, video, tokens, null_tokens, fs, generator=None, x_T=None):
        h = video.shape[0] // 2
        out = orig(self, video[:h], tokens[:h], null_tokens[:h], fs[:h],
                   generator=generator[:h])
        return torch.cat([out, out])

    monkeypatch.setattr(D.Pipeline, "__call__", call)


@pytest.mark.parametrize("cell,fault", [
    ("i2v512-b1", _state_unchanged), ("i2v512-b1", _clip_altered),
    ("i2v512-b2", _half_batch)])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    run, _ = _tiny.run(cell)
    assert run.units > 0
    assert not run.correct and _failed(run.checks), run.checks


def test_the_unbroken_path_is_correct():
    run, _ = _tiny.run("i2v512-b1")
    assert run.correct, run.checks


def test_training_control_and_faults_are_not_correct():
    """The training cell's numbers: its control (fp8 products in the
    reference put in the program's place) and half of each batch left out
    of the program's steps fail; a state left unchanged reads 1 in
    ``update_err`` by the measure itself."""
    from benchmark.traffic import train as TT

    torch.set_num_threads(1)
    ctx = _tiny.context("train512-b2")
    cfg, mix, seed = ctx.config, ctx.mix, ctx.seed
    n = mix["check_steps"]
    ref = TT.reference_steps(TT.build_reference(cfg, seed, "cpu"), seed,
                             cfg, mix, "cpu", n)
    limits = mix["limits"]

    def judged(got):
        return {k: (got[k], lim) for k, lim in limits.items()}

    ctl = TT.reference_steps(TT.build_reference(cfg, seed, "cpu", fp8=True),
                             seed, cfg, mix, "cpu", n)
    assert _failed(judged(TT.numbers(ctl, ref)))
    model, state, step_fn = TT.build_program(cfg, mix, seed, "cpu")
    half = TT.first_steps(model, state, TT.half_batch(step_fn), seed, cfg,
                          mix, "cpu", n)
    assert _failed(judged(TT.numbers(half, ref)))
    still = {**ref, "update": {k: 0.0 for k in ref["update"]}}
    assert TT.numbers(still, ref)["update_err"] == 1.0
