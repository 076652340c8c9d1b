"""The port's dataset-preparation code and its four small CLIs against the
JAX package's, on the CPU: ``data/preprocess.py`` (the cases of
``tests/test_preprocess.py``, each result equal to JAX's: the lists in
order, the ``mode`` column, the kept rows), ``cli/preprocess.py`` and
``cli/pkl_viewer.py`` (the same pickles and printout),
``cli/write_image_summary.py`` over the port's own TensorBoard image events
(the same names and decoded pixels), ``cli/plot_signals.py`` (the same PNG
pixels), and each parser's required arguments."""

import argparse
import os
import pickle
import shutil

import numpy as np
import pytest

from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu.cli import pkl_viewer as jax_pkl_viewer
from weather_unet_tpu.cli import plot_signals as jax_plot_signals
from weather_unet_tpu.cli import preprocess as jax_preprocess_cli
from weather_unet_tpu.cli import write_image_summary as jax_write_summary
from weather_unet_tpu.data import preprocess as jax_pp
from weather_unet_tpu_torch.cli import (
    pkl_viewer, plot_signals, preprocess, write_image_summary)
from weather_unet_tpu_torch.data import preprocess as pp

pd = pytest.importorskip("pandas")
Image = pytest.importorskip("PIL.Image")

CLIS = {"preprocess": (preprocess, jax_preprocess_cli),
        "pkl_viewer": (pkl_viewer, jax_pkl_viewer),
        "write_image_summary": (write_image_summary, jax_write_summary),
        "plot_signals": (plot_signals, jax_plot_signals)}


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    """Delete what a test wrote once it ends (pytest keeps every test's
    directory until the run ends)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jpegs(d, n, rng, gray=False):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        a = rng.integers(0, 255, (8, 8, 1 if gray else 3), dtype=np.uint8)
        Image.fromarray(np.repeat(a, 3, axis=2) if gray else a).save(
            d / f"{i}.jpg")


def _i2w_tree(root, classes, n, strays=False):
    rng = np.random.default_rng(0)
    for cls in classes:
        _jpegs(root / cls, n, rng)
        if strays:
            (root / cls / "Thumbs.db").write_bytes(b"not an image")
            (root / cls / "notes.txt").write_text("stray")
            (root / cls / "subdir").mkdir()


def _flickr_frame():
    return pd.DataFrame({
        "photo": [f"p{i}" for i in range(200)],
        "condition2": ["Clear"] * 100 + ["Rain"] * 100,
        "ent_label": np.linspace(0, 1, 200)})


def _gray_world(root):
    rng = np.random.default_rng(0)
    color = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    gray = np.repeat(rng.integers(0, 255, (16, 16, 1), dtype=np.uint8), 3,
                     axis=2)
    Image.fromarray(color).save(root / "c.jpg")
    Image.fromarray(gray).save(root / "g.jpg", quality=100, subsampling=0)
    (root / "bad.jpg").write_bytes(b"not a jpeg")
    return pd.DataFrame({"photo": ["c", "g", "missing", "bad"],
                         "w": [1, 2, 3, 4]})


# ------------------------------------------------------- data/preprocess

def test_split_i2w_equals_jax(tmp_path):
    _i2w_tree(tmp_path, ["sunny", "rain", "z-other"], 10)
    split = pp.split_i2w(str(tmp_path), test_per_class=4)
    assert split == jax_pp.split_i2w(str(tmp_path), test_per_class=4)
    assert [len(split[k]) for k in ("test", "train", "val")] == [8, 6, 6]
    assert not any("z-other" in p for v in split.values() for p in v)
    assert pp.split_i2w(str(tmp_path), 4, seed=1) == jax_pp.split_i2w(
        str(tmp_path), 4, seed=1) != split
    out = tmp_path / "split.pkl"
    pp.save_split_pickle(split, str(out))
    jout = tmp_path / "split_jax.pkl"
    jax_pp.save_split_pickle(split, str(jout))
    assert out.read_bytes() == jout.read_bytes()


def test_split_i2w_ignores_non_images_and_subsamples_first(tmp_path):
    _i2w_tree(tmp_path, ["sunny", "rain"], 20, strays=True)
    split = pp.split_i2w(str(tmp_path), test_per_class=4, small_rate=0.5)
    assert split == jax_pp.split_i2w(str(tmp_path), test_per_class=4,
                                     small_rate=0.5)
    assert all(p.endswith(".jpg") for v in split.values() for p in v)
    assert [len(split[k]) for k in ("test", "train", "val")] == [8, 6, 6]


def test_split_flickr_equals_jax():
    df = _flickr_frame()
    for kw in ({}, {"ent_th": 0.5}, {"per_class": (70, 10, 20), "seed": 3}):
        out = pp.split_flickr(df, **kw)
        pd.testing.assert_frame_equal(out, jax_pp.split_flickr(df, **kw))
        assert "mode" not in df
    counts = pp.split_flickr(df)["mode"].value_counts()
    assert (counts["train"], counts["val"], counts["test"]) == (80, 80, 40)
    assert len(pp.split_flickr(df, ent_th=0.5)) < len(df)


def test_remove_gray_equals_jax(tmp_path):
    df = _gray_world(tmp_path)
    out = pp.remove_gray(df, str(tmp_path))
    pd.testing.assert_frame_equal(out, jax_pp.remove_gray(df, str(tmp_path)))
    assert out["photo"].to_list() == ["c"]


# ------------------------------------------------------------------ CLIs

def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_preprocess_cli_equals_jax(tmp_path, capsys):
    """The three subcommands write the same pickles (read back equal) and
    print the same lines as the JAX CLI; pkl_viewer prints the same for
    each output."""
    _i2w_tree(tmp_path / "i2w", ["sunny", "rain"], 10)
    frame = tmp_path / "frame.pkl"
    _flickr_frame().to_pickle(frame)
    photos = tmp_path / "photos"
    photos.mkdir()
    gray_pkl = tmp_path / "gray.pkl"
    _gray_world(photos).to_pickle(gray_pkl)
    runs = {
        "split-i2w": ["--root", str(tmp_path / "i2w"), "--test_per_class",
                      "3", "--small_rate", "0.8"],
        "split-flickr": ["--pkl_path", str(frame), "--ent_th", "0.7",
                         "--ratio", "50", "30", "20"],
        "remove-gray": ["--pkl_path", str(gray_pkl), "--image_root",
                        str(photos)]}
    for cmd, argv in runs.items():
        outs, printed = {}, {}
        for side, main in (("port", preprocess.main),
                           ("jax", jax_preprocess_cli.main)):
            outs[side] = str(tmp_path / f"{cmd}_{side}.pkl")
            printed[side] = _run(main, [cmd] + argv + ["--output",
                                                      outs[side]], capsys)
        assert printed["port"] == printed["jax"], cmd
        a, b = (pd.read_pickle(outs[s]) for s in ("port", "jax"))
        if isinstance(a, dict):
            assert a == b
        else:
            pd.testing.assert_frame_equal(a, b)
        for extra in ([], ["--head", "2", "--column", "photo"]):
            if extra and isinstance(a, dict):
                continue
            views = [_run(m, [outs["port"]] + extra, capsys)
                     for m in (pkl_viewer.main, jax_pkl_viewer.main)]
            assert views[0] == views[1] and "type: " in views[0]


def test_pkl_viewer_other_objects_equal_jax(tmp_path, capsys):
    for i, obj in enumerate(([3, 1, 4, 1, 5, 9], {"n": 3, "xs": (1, 2)},
                             "plain string")):
        path = tmp_path / f"{i}.pkl"
        with open(path, "wb") as f:
            pickle.dump(obj, f)
        views = [_run(m, [str(path), "--head", "3"], capsys)
                 for m in (pkl_viewer.main, jax_pkl_viewer.main)]
        assert views[0] == views[1]


def test_write_image_summary_equals_jax(tmp_path, capsys):
    """Events from the port's SummaryWriter.add_image_grid (two tags, one
    step written twice): both CLIs write the same file names and the same
    decoded pixels, one JPEG per event; --tag keeps one tag."""
    from weather_unet_tpu_torch.train.metrics import SummaryWriter

    rng = np.random.default_rng(0)
    writer = SummaryWriter(str(tmp_path / "runs"))
    for step in (0, 5, 5):
        writer.add_image_grid("images/train", rng.random((2, 8, 8, 3)), step,
                              nrow=2)
        writer.add_image_grid("images/test", rng.random((1, 6, 10, 3)), step)
    writer.close()
    written = {}
    for side, main in (("port", write_image_summary.main),
                       ("jax", jax_write_summary.main)):
        out = tmp_path / side
        text = _run(main, ["--event_path", writer.log_dir, "--output_dir",
                           str(out)], capsys)
        assert text == f"wrote 6 images to {out}\n"
        written[side] = {n: np.asarray(Image.open(out / n))
                         for n in sorted(os.listdir(out))}
    assert list(written["port"]) == list(written["jax"])
    assert len(written["port"]) == 6
    assert "images_train_5_2.jpg" in written["port"]
    for name, px in written["port"].items():
        assert np.array_equal(px, written["jax"][name]), name
    only = tmp_path / "only"
    _run(write_image_summary.main, ["--event_path", writer.log_dir,
                                    "--output_dir", str(only), "--tag",
                                    "images/test"], capsys)
    assert sorted(os.listdir(only)) == [
        n for n in written["port"] if n.startswith("images_test")]


@pytest.mark.parametrize("kind", ["gt_and_pred", "errors_dict"])
def test_plot_signals_equals_jax(tmp_path, capsys, kind):
    rng = np.random.default_rng(1)
    gt = tmp_path / "gt.pkl"
    argv = ["--gt_pkl", str(gt), "--bins", "20"]
    if kind == "gt_and_pred":
        with open(gt, "wb") as f:
            pickle.dump(rng.standard_normal((64, 5)), f)
        pred = tmp_path / "pred.pkl"
        with open(pred, "wb") as f:
            pickle.dump(rng.standard_normal((64, 5)) * 0.5, f)
        argv += ["--pred_pkl", str(pred)]
    else:
        with open(gt, "wb") as f:
            pickle.dump({"signed_l1": rng.standard_normal((64, 5)),
                         "abs": rng.random((64, 5))}, f)
    pixels = {}
    for side, main in (("port", plot_signals.main),
                       ("jax", jax_plot_signals.main)):
        png = tmp_path / f"{side}.png"
        assert _run(main, argv + ["--output", str(png)], capsys) == (
            f"wrote {png}\n")
        pixels[side] = np.asarray(Image.open(png))
    assert pixels["port"].shape == pixels["jax"].shape
    assert np.array_equal(pixels["port"], pixels["jax"])


def test_plot_signals_without_matplotlib_says_so(tmp_path, monkeypatch):
    """The card's host has no matplotlib: the CLI exits naming it."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(SystemExit, match="matplotlib"):
        plot_signals.main(["--gt_pkl", str(tmp_path / "gt.pkl")])


def _required(parser):
    req = set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub in action.choices.values():
                req |= _required(sub)
        elif getattr(action, "required", False) and action.dest != "help":
            req.add(action.dest)
    return req


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_required_arguments_equal_jax(name):
    """Each parser requires what the JAX parser requires (the sets of
    tests/test_cli_integration.py::test_required_flags_match_reference_
    semantics) and parses the same defaults."""
    port, jax_cli = CLIS[name]
    assert _required(port.build_parser()) == _required(
        jax_cli.build_parser())
    expected = {"pkl_viewer": {"pkl"}, "plot_signals": {"gt_pkl"},
                "preprocess": {"root", "output", "pkl_path", "image_root"},
                "write_image_summary": {"event_path"}}
    assert _required(port.build_parser()) == expected[name]
    argv = {"pkl_viewer": ["x.pkl"], "plot_signals": ["--gt_pkl", "g"],
            "preprocess": ["split-flickr", "--pkl_path", "p", "--output",
                           "o"],
            "write_image_summary": ["--event_path", "e"]}[name]
    assert vars(port.build_parser().parse_args(argv)) == vars(
        jax_cli.build_parser().parse_args(argv))
