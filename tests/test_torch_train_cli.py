"""The port's training data and CLI (tooncrafter_tpu_torch.data,
tooncrafter_tpu_torch.cli.train) on the CPU.

The dataset reads tiny mp4s written with OpenCV: its samples against the
JAX package's ``WebVidDataset`` on the same table and seed, both sides on
their default path, the native C++ resizer (the port's own build of the
same source): the same stride, start frame, fps, caption and pixels
(exact). Then stride shrink-to-fit,
skip-and-retry, and the loader's per-epoch reshuffle and disjoint host
shards. The CLI's dry run, then ``--train --max_steps 2 --device cpu`` on
configs/tiny_smoke.yaml with that data (validation with the EMA every
step), then a resumed run to step 3; ``--n_model_shards 2`` on two gloo
ranks (tensor parallelism: the checkpoint holds whole tensors), and on one
process refused; the sampled-video callback at DDIM-2 with the EMA weights
swapped in and back.
"""

import json
import os

import numpy as np
import pytest
import yaml
import torch  # noqa: E402

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

cv2 = pytest.importorskip("cv2")

from tooncrafter_tpu.data.webvid import (  # noqa: E402
    WebVidDataset as JaxDataset)
from tooncrafter_tpu_torch.cli import train as cli  # noqa: E402
from tooncrafter_tpu_torch.data.webvid import (PrefetchLoader,  # noqa: E402
                                               WebVidDataset)
from tooncrafter_tpu_torch.utils import video_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("webvid")
    data_dir = root / "videos"
    (data_dir / "p0").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for vid, n in enumerate((24, 24, 6, 24)):
        frames = rng.uniform(0, 255, (n, 40, 56, 3)).astype(np.uint8)
        written = video_io.write_video(str(data_dir / "p0" / f"{vid}.mp4"),
                                       frames, fps=12)
        if not written.endswith(".mp4"):
            pytest.skip("no mp4 codec available in the cv2 build")
        rows.append(f"{vid},p0,a cartoon clip number {vid}")
    meta = root / "meta.csv"
    meta.write_text("videoid,page_dir,name\n" + "\n".join(rows) + "\n")
    return str(meta), str(data_dir)


def test_samples_match_the_jax_dataset(video_dir):
    from tooncrafter_tpu import native

    assert native.available()  # the JAX dataset's default, native path
    meta, data_dir = video_dir
    kw = dict(video_length=4, frame_stride=3, resolution=(32, 32), seed=1,
              fps_max=5.0)
    ours, theirs = WebVidDataset(meta, data_dir, **kw), JaxDataset(
        meta, data_dir, **kw)
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert a["video"].shape == (4, 32, 32, 3) == b["video"].shape
        assert a["video"].dtype == np.float32
        assert a["caption"] == b["caption"] and a["path"] == b["path"]
        assert int(a["frame_stride"]) == int(b["frame_stride"])
        assert float(a["fps"]) == pytest.approx(float(b["fps"]))
        assert float(a["fps"]) <= 5.0
        np.testing.assert_array_equal(a["video"], b["video"])


def test_stride_shrinks_to_fit_and_bad_rows_are_skipped(video_dir, tmp_path):
    meta, data_dir = video_dir
    # video 2 has 6 frames: 4 frames at stride 3 need 10, so the stride
    # shrinks to 1
    ds = WebVidDataset(meta, data_dir, video_length=4, frame_stride=3,
                       resolution=(32, 32), random_fs=False)
    assert int(ds[2]["frame_stride"]) == 1
    lines = open(meta).read().strip().split("\n")
    bad = tmp_path / "meta.csv"
    bad.write_text(lines[0] + "\n999,p0,missing video\n"
                   + "\n".join(lines[1:]) + "\n")
    ds = WebVidDataset(str(bad), data_dir, video_length=4, frame_stride=2,
                       resolution=(32, 32))
    assert ds[0]["path"].endswith("0.mp4")  # row 0 is missing: retried


def test_loader_reshuffles_and_shards(video_dir):
    meta, data_dir = video_dir
    ds = WebVidDataset(meta, data_dir, video_length=4, frame_stride=2,
                       resolution=(32, 32))

    def epoch(loader):
        return [c for batch in loader for c in batch["captions"]]
    loader = PrefetchLoader(ds, 1, num_workers=1, seed=3)
    first, second = epoch(loader), epoch(loader)
    assert sorted(first) == sorted(second) and len(first) == 4
    assert first != second  # the (seed, epoch) stream reshuffles
    shards = [epoch(PrefetchLoader(ds, 1, num_workers=2, seed=3,
                                   shard=(i, 2))) for i in range(2)]
    assert len(shards[0]) == len(shards[1]) == 2
    assert not set(shards[0]) & set(shards[1])
    with pytest.raises(ValueError):
        PrefetchLoader(ds, 1, shard=(2, 2))


def _config(tmp_path, meta, data_dir):
    raw = yaml.safe_load(open(os.path.join(REPO, "configs",
                                           "tiny_smoke.yaml")))
    split = {"params": {"meta_path": meta, "data_dir": data_dir,
                        "frame_stride": 2}}
    raw["data"] = {"params": {"batch_size": 2, "num_workers": 2,
                              "train": split, "validation": split}}
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_dry_run_train_and_resume(video_dir, tmp_path, capsys):
    cfg = _config(tmp_path, *video_dir)
    base = ["--config", cfg, "--logdir", str(tmp_path / "runs"), "--name",
            "r", "--device", "cpu", "--seed", "1"]
    cli.main(base)
    assert "dry run complete" in capsys.readouterr().out
    cli.main(base + ["--train", "--max_steps", "2", "--val_every", "1"])
    assert "done at step 2" in capsys.readouterr().out
    work = tmp_path / "runs" / "r"
    rows = [json.loads(line) for line in open(work / "metrics.jsonl")]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps)
    val = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in val] == [1, 2]
    assert all(np.isfinite(r["val/loss_ema"]) for r in val)
    assert os.listdir(work / "checkpoints") == ["step_00000002.pt"]
    cli.main(base + ["--train", "--max_steps", "3", "--auto_resume"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "done at step 3" in out
    with pytest.raises(SystemExit, match="n_model_shards"):
        cli.main(base + ["--n_model_shards", "2"])


def test_cli_trains_with_two_model_shards(video_dir, tmp_path):
    from tooncrafter_tpu_torch.config import model_config_from_yaml
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.parallel import rank_runs
    from tooncrafter_tpu_torch.parallel.spawn import run_ranks

    cfg = _config(tmp_path, *video_dir)
    argv = ["--config", cfg, "--logdir", str(tmp_path / "runs"), "--name",
            "tp", "--device", "cpu", "--seed", "1", "--n_model_shards", "2",
            "--train", "--max_steps", "2"]
    run_ranks(rank_runs.cli_train, 2, "cpu", args=(argv,), timeout=240,
              threads=1, store_dir=str(tmp_path))
    work = tmp_path / "runs" / "tp"
    rows = [json.loads(line) for line in open(work / "metrics.jsonl")]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps)
    assert os.listdir(work / "checkpoints") == ["step_00000002.pt"]
    saved = torch.load(work / "checkpoints" / "step_00000002.pt",
                       weights_only=True)["train_params"]
    with torch.device("meta"):
        whole = ToonCrafter(model_config_from_yaml(cfg)).state_dict()
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(whole[k].shape) for k in saved}


def test_video_sample_logger_uses_the_ema(tmp_path):
    import torch

    from tooncrafter_tpu_torch.config import ModelConfig
    from tooncrafter_tpu_torch.models.diffusion import ToonCrafter
    from tooncrafter_tpu_torch.training import callbacks as CB
    from tooncrafter_tpu_torch.training import trainer as T
    from tooncrafter_tpu_torch.utils.profiling import random_batch
    from tooncrafter_tpu_torch.utils.weights import init_random_

    cfg = ModelConfig().tiny()
    model = ToonCrafter(cfg)
    init_random_(model, torch.Generator().manual_seed(0))
    state, _ = T.make_train_state(model, T.TrainConfig(), use_ema=True)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.add_(0.01)
    raw = {k: p.detach().clone() for k, p in state.train_params.items()}
    logger = CB.VideoSampleLogger(model, str(tmp_path), every_steps=2,
                                  ddim_steps=2)
    batch = random_batch(cfg, 1, 0, "cpu")
    assert logger.maybe_log(1, state, batch) is None
    seen = {}
    unet_call = model.unet.forward

    def spy(*a, **k):  # the weights the sampler runs with
        seen.setdefault("w", next(model.unet.parameters()).detach().clone())
        return unet_call(*a, **k)
    model.unet.forward = spy
    out = logger.maybe_log(2, state, batch, torch.Generator().manual_seed(0))
    assert out is not None and os.path.exists(out)
    first = next(iter(state.ema_params))
    torch.testing.assert_close(seen["w"], state.ema_params[first])
    for k, p in state.train_params.items():  # swapped back
        torch.testing.assert_close(p.detach(), raw[k])
