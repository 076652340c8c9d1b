"""The port's five inference CLIs with ``--device cpu`` against the JAX
package's on one synthetic world (16 photos and a Flickr frame, an i2w
split) and the same weights: a seeded cUNet in the msgpack GAN layout of
the JAX trainer's checkpoints and a depth-(1, 1, 1, 1) ResNet estimator in
msgpack (the JAX side's ResNet-101 builder patched to that depth, as
``tests/test_cli_integration.py`` does; the port reads the depth from the
keys).  32x32, batch 4.  Bars: the same files, each picture handed to
Pillow's ``save`` (a JPEG, every frame of a GIF) within 1 uint8 step of
JAX's; pickled labels equal; ``OneYearWeatherSignals`` items equal;
``save_image`` and ``denorm_tanh`` equal; the demo refuses 244."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
from PIL import Image

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.data import datasets as jax_datasets
from weather_unet_tpu.models import ResNet as JaxResNet
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu.train.gan import GanConfig, build_gan_state
from weather_unet_tpu_torch.data import datasets

SIZE = 32
SIGNALS = datasets.SIGNAL_COLUMNS


@pytest.fixture(scope="module")
def small_jax_resnet():
    """The JAX CLIs' ResNet-101 builder at depth (1, 1, 1, 1)."""
    import weather_unet_tpu.cli.common as common

    orig = common.ResNet101
    common.ResNet101 = lambda num_classes=5, dtype=jnp.float32: JaxResNet(
        block_counts=(1, 1, 1, 1), num_classes=num_classes, dtype=dtype)
    yield
    common.ResNet101 = orig


def build_world(root, rng):
    """Photos, a Flickr frame, an i2w split, a GAN msgpack and an estimator
    msgpack under ``root``."""
    from weather_unet_tpu.testing import build_i2w_world

    img_dir = root / "photos"
    img_dir.mkdir()
    rows = []
    for i in range(16):
        pid = f"p{i:03d}"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(img_dir / f"{pid}.jpg")
        rows.append({
            "photo": pid, "mode": "train" if i < 10 else "test",
            "condition2": datasets.WEATHER_CLASSES_FLICKR[i % 5],
            "w_condition": datasets.WEATHER_CLASSES_FLICKR[i % 5],
            "name": "st" if i % 4 else "other",
            # one duplicated hour, one missing signal
            "s_unixtime": 1_600_000_000 + 3600 * min(i, 14),
            **{c: float(rng.standard_normal()) for c in SIGNALS}})
    rows[5]["humidity"] = np.nan
    pd.DataFrame(rows).to_pickle(root / "data.pkl")
    split_pkl = build_i2w_world(root, rng=rng)["split_pkl"]

    _, _, state = build_gan_state(GanConfig(input_size=SIZE),
                                  jax.random.key(0))
    # the trainer's GAN layout; the Adam moments (whose reading
    # tests/test_torch_flax_msgpack.py covers) left out to keep it small
    cp = jax_ckpt.save_checkpoint(
        str(root), "gan", 7, {"gen": {"params": state.gen.params,
                                      "step": state.gen.step},
                              "disc": {"params": state.disc.params,
                                       "step": state.disc.step},
                              "spectral": state.spectral, "epoch": 0,
                              "global_step": 7})
    est = JaxResNet(block_counts=(1, 1, 1, 1), num_classes=5)
    ev = est.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, 3)),
                  train=False)
    est_path = jax_ckpt.save_checkpoint(
        str(root), "est", 0, {"params": ev["params"],
                              "batch_stats": ev["batch_stats"]})
    return {"root": root, "img_dir": str(img_dir),
            "pkl": str(root / "data.pkl"), "split_pkl": str(split_pkl),
            "cp": cp, "est": est_path}


@pytest.fixture(scope="module")
def world(tmp_path_factory, small_jax_resnet):
    return build_world(tmp_path_factory.mktemp("world"),
                       np.random.default_rng(0))


@pytest.fixture
def saved(monkeypatch):
    """The uint8 pictures each CLI hands to Pillow to save, by file name
    (JPEG's and GIF's encoders are not continuous: a 1-step difference
    can move a decoded pixel further, or pick another GIF palette)."""
    handed = {}
    save = Image.Image.save

    def record(self, fp, *args, **kw):
        frames = [self] + list(kw.get("append_images", []))
        handed[str(fp)] = [np.asarray(im, np.int16) for im in frames]
        return save(self, fp, *args, **kw)

    monkeypatch.setattr(Image.Image, "save", record)
    return handed


def run_both(name, argv, tmp_path, out_flag="--output_dir"):
    """The JAX CLI and the port's (``--device cpu``) on the same argv, each
    writing under its own directory; returns (jax dir, port dir)."""
    import importlib

    dirs = []
    for pkg, extra in (("weather_unet_tpu", []),
                       ("weather_unet_tpu_torch", ["--device", "cpu"])):
        out = str(tmp_path / pkg)
        importlib.import_module(f"{pkg}.cli.{name}").main(
            argv + [out_flag, out] + extra)
        dirs.append(out)
    return dirs


def assert_saved_close(saved, jax_dir, port_dir, n):
    """The same files, and each picture saved within 1 uint8 step of
    JAX's."""
    names = sorted(os.listdir(jax_dir))
    assert len(names) == n and sorted(os.listdir(port_dir)) == names
    for f in names:
        want = saved[os.path.join(jax_dir, f)]
        got = saved[os.path.join(port_dir, f)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1, f


def test_inf_transfer_c(world, tmp_path, saved):
    jax_dir, port_dir = run_both(
        "inf_transfer_c", ["--image_root", world["img_dir"], "--cp_path",
                           world["cp"], "--input_size", str(SIZE),
                           "--batch_size", "4", "--image_only"], tmp_path)
    assert_saved_close(saved, jax_dir, port_dir, 16 * 5)
    assert os.path.exists(os.path.join(port_dir, "img_p003_snow.jpg"))


def test_inf_transfer_c_i2w_split(world, tmp_path, saved):
    jax_dir, port_dir = run_both(
        "inf_transfer_c", ["--image_root", "unused", "--pkl_path",
                           world["split_pkl"], "--cp_path", world["cp"],
                           "--input_size", str(SIZE), "--batch_size", "4"],
        tmp_path)
    assert_saved_close(saved, jax_dir, port_dir, 5 * 5)
    assert os.path.exists(os.path.join(port_dir, "rain_2_sunny.jpg"))


def test_demo_gif(world, tmp_path, saved):
    argv = ["--input_dir", world["img_dir"], "--cp_path", world["cp"],
            "--estimator_path", world["est"], "--input_size", str(SIZE),
            "--batch_size", "4", "--num_classes", "5", "--num_frames", "3"]
    jax_dir, port_dir = run_both("demo", argv, tmp_path)
    assert_saved_close(saved, jax_dir, port_dir, 4)       # 16 photos / 4
    for f in os.listdir(port_dir):
        with Image.open(os.path.join(port_dir, f)) as gif:
            assert gif.n_frames == 4                      # 3 forward, 1 back
            assert gif.size == (6 * (SIZE + 4), 4 * (SIZE + 2) + 2)
    from weather_unet_tpu_torch.cli import demo

    with pytest.raises(SystemExit, match="not divisible by 8"):
        demo.main(argv[:6] + ["--output_dir", str(tmp_path / "g"),
                              "--input_size", "244", "--device", "cpu"])


def test_inf_transfer_e(world, tmp_path, saved):
    jax_dir, port_dir = run_both(
        "inf_transfer_e", ["--image_root", world["img_dir"], "--pkl_path",
                           world["pkl"], "--cp_path", world["cp"],
                           "--estimator_path", world["est"], "--input_size",
                           str(SIZE), "--batch_size", "4", "--mode", "test"],
        tmp_path)
    assert_saved_close(saved, jax_dir, port_dir, 4 * 4)   # one batch, 4 x 4
    assert os.path.exists(os.path.join(port_dir, "p010_cond-p013.jpg"))


def test_inf_1year_signals(world, tmp_path, saved):
    argv = ["--image_root", world["img_dir"], "--pkl_path", world["pkl"],
            "--photo_id", "p003", "--cp_path", world["cp"], "--input_size",
            str(SIZE), "--batch_size", "4"]
    jax_dir, port_dir = run_both("inf_1year_signals", argv, tmp_path)
    # station "st": 12 rows, one hour twice -> 11 frames in 3 batches
    assert_saved_close(saved, jax_dir, port_dir, 11)


@pytest.mark.parametrize("name", [None, "other"])
def test_one_year_signals_items_match_jax(world, name):
    df, _, _ = jax_datasets.zscore_columns(pd.read_pickle(world["pkl"]),
                                           SIGNALS)
    want = jax_datasets.OneYearWeatherSignals(world["img_dir"], df, SIGNALS,
                                              "p005", out_size=SIZE,
                                              name=name)
    got = datasets.OneYearWeatherSignals(world["img_dir"], df, SIGNALS,
                                         "p005", out_size=SIZE, name=name)
    assert got.name == want.name and len(got) == len(want)
    np.testing.assert_array_equal(got.s_times, want.s_times)
    for i in range(len(want)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    assert got.num_classes == 5 and np.all(np.diff(got.s_times) < 0)


@pytest.mark.parametrize("mode", ["flicker", "i2w", "unreadable"])
def test_inf_classifier_i2w(world, tmp_path, mode):
    pkl = world["pkl"]
    if mode == "unreadable":
        df = pd.read_pickle(pkl)
        broken = df.iloc[[0]].copy()
        broken["photo"] = "broken_missing"
        pkl = str(tmp_path / "with_broken.pkl")
        pd.concat([df, broken], ignore_index=True).to_pickle(pkl)
    argv = ["--image_root", world["img_dir"], "--pkl_path",
            world["split_pkl"] if mode == "i2w" else pkl,
            "--classifier_path", world["est"], "--input_size", str(SIZE),
            "--batch_size", "4"]
    if mode == "i2w":
        argv += ["--dataset", "i2w"]
    jax_pkl, port_pkl = run_both("inf_classifier_i2w", argv, tmp_path,
                                 out_flag="--output_pkl")
    want, got = pd.read_pickle(jax_pkl), pd.read_pickle(port_pkl)
    pd.testing.assert_frame_equal(got, want)
    if mode == "unreadable":
        row = got[got["photo"] == "broken_missing"]
        assert len(row) == 1 and row["w_condition"].isna().all()
    if mode == "i2w":
        assert len(got) == 5 and set(got["w_condition"]) <= set(
            datasets.WEATHER_CLASSES_I2W)


@pytest.mark.parametrize("normalize", [True, False])
def test_save_image_and_denorm_tanh_match_jax(normalize, rng, tmp_path):
    import torch

    from weather_unet_tpu.cli import common as jax_common
    from weather_unet_tpu_torch.cli import common

    x = rng.uniform(-1.2, 1.1, (3, 8, 6, 3)).astype(np.float32)
    if not normalize:
        x = (x + 1.2) / 2.3                      # [0, 1]: saved as is
    jax_common.save_image(str(tmp_path / "jax.png"), x, nrow=2,
                          normalize=normalize)
    common.save_image(str(tmp_path / "port.png"), torch.from_numpy(x),
                      nrow=2, normalize=normalize)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert want.shape == (2 * 10 + 2, 2 * 8 + 2, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  want)
    np.testing.assert_array_equal(common.denorm_tanh(torch.from_numpy(x)),
                                  jax_common.denorm_tanh(x))
