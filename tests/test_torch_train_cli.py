"""The port's training CLIs with ``--device cpu`` on seeded synthetic JPEGs,
at 32x32, batch 2, with a depth-(1, 1, 1, 1) ResNet estimator: the est CLI
over a pandas frame (with ``--stats_pkl``, ``--sampler`` and the cached test
batches) and in ``--image_only`` mode (``--augmentation``, the decode cache); the cls CLI
supervised on the Flickr frame, semi-supervised with cross-entropy on the
i2w split, and on a bare directory.  Each run ends with its terminal
checkpoint at epochs x steps per epoch.  The flags whose modules are not
ported exit non-zero naming their roadmap item, and without a GPU the CLIs
refuse to start unless given ``--device cpu``."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_torch_data import write_jpegs
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu_torch.cli import train_transfer_cls as cls_cli
from weather_unet_tpu_torch.cli import train_transfer_est as est_cli
from weather_unet_tpu_torch.data.datasets import (
    SIGNAL_COLUMNS, WEATHER_CLASSES_FLICKR, WEATHER_CLASSES_I2W)
from weather_unet_tpu_torch.models import ResNet
from weather_unet_tpu_torch.train.checkpoint import latest_checkpoint


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    flickr = str(root / "flickr")
    write_jpegs(flickr, [f"{i}.jpg" for i in range(14)], size=(40, 36),
                seed=7)
    rng = np.random.default_rng(8)
    df = pd.DataFrame({
        "photo": [str(i) for i in range(14)],
        "mode": ["train"] * 8 + ["test"] * 6,
        **{c: rng.standard_normal(14) * 3 + 10 for c in SIGNAL_COLUMNS},
        "condition2": [WEATHER_CLASSES_FLICKR[i % 5] for i in range(14)],
        "w_condition": [WEATHER_CLASSES_FLICKR[i % 3] for i in range(14)]})
    df.to_pickle(root / "frame.pkl")
    df.iloc[:10].to_pickle(root / "stats.pkl")
    i2w = write_jpegs(str(root / "i2w"),
                      [f"{WEATHER_CLASSES_I2W[i % 5]}/{i}.jpg"
                       for i in range(12)], size=(40, 36), seed=9)
    pd.to_pickle({"train": i2w[:8], "test": i2w[8:]}, root / "i2w.pkl")
    est = str(root / "est.pt")
    torch.save(ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                      .manual_seed(3)).state_dict(), est)
    return {"root": root, "flickr": flickr, "est": est}


def common(data, tmp_path, epochs=2):
    return ["--estimator_path", data["est"], "--device", "cpu",
            "--input_size", "32", "--batch_size", "2", "--num_epoch",
            str(epochs), "--num_workers", "2", "--save_dir",
            str(tmp_path / "cp"), "--log_dir", str(tmp_path / "runs"),
            "--name", "run"]


def final_step(tmp_path):
    path = latest_checkpoint(str(tmp_path / "cp"), "run")
    return torch.load(path, weights_only=True)["global_step"]


@pytest.mark.parametrize("mode", ["frame", "image_only"])
def test_est_cli(data, tmp_path, mode, capsys):
    if mode == "frame":
        args = ["--image_root", data["flickr"], "--pkl_path",
                str(data["root"] / "frame.pkl"), "--stats_pkl",
                str(data["root"] / "stats.pkl"), "--sampler",
                "--GD_train_ratio", "2"]
        steps = 2 * 4                       # 8 train rows
    else:
        args = ["--image_root", data["flickr"], "--image_only",
                "--augmentation", "--export_torch", "--dtype", "bf16",
                "--decode_cache", str(tmp_path / "cache")]
        steps = 2 * 4                       # 70% of 14 images = 9 -> 4
    est_cli.main(args + common(data, tmp_path))
    out = capsys.readouterr().out
    assert "Done: training" in out
    assert ("train augment: decode cache + native" in out
            if mode == "image_only" else "train augment: native" in out)
    assert final_step(tmp_path) == steps
    if mode == "image_only":
        assert os.path.exists(tmp_path / "cp" / "run" / f"run_e0002_s{steps}.pt")


@pytest.mark.parametrize("mode", ["flicker_supervised", "i2w_ce",
                                  "image_only"])
def test_cls_cli(data, tmp_path, mode, capsys):
    if mode == "flicker_supervised":
        args = ["--image_root", data["flickr"], "--pkl_path",
                str(data["root"] / "frame.pkl"), "--supervised",
                "--sampler"]
        steps = 1 * 4
    elif mode == "i2w_ce":
        args = ["--image_root", str(data["root"]), "--pkl_path",
                str(data["root"] / "i2w.pkl"), "--dataset", "i2w",
                "--cross_ent"]
        steps = 1 * 4
    else:
        args = ["--image_root", data["flickr"], "--image_only",
                "--cross_ent"]
        steps = 1 * 4
    cls_cli.main(args + common(data, tmp_path, epochs=1))
    assert "Done: training" in capsys.readouterr().out
    assert final_step(tmp_path) == steps


def test_unported_flags_and_missing_gpu(data, tmp_path, monkeypatch):
    base = ["--image_root", data["flickr"], "--image_only"]
    for cli in (est_cli, cls_cli):
        for flag, item in ((["--aot_cache", str(tmp_path)],
                            "Mesh, AOT and multi-process"),
                           (["--tensor_parallel", "2"], "Mesh, AOT")):
            with pytest.raises(SystemExit, match=item) as e:
                cli.main(base + flag + common(data, tmp_path))
            assert e.value.code not in (0, None)
    for cli in (est_cli, cls_cli):
        with pytest.raises(SystemExit, match="--pkl_path is required"):
            cli.main(["--image_root", data["flickr"], "--estimator_path",
                      data["est"], "--device", "cpu"])
    with pytest.raises(SystemExit, match="--supervised requires them"):
        cls_cli.main(base + ["--supervised"] + common(data, tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (est_cli, cls_cli):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base + ["--estimator_path", data["est"]])
