"""The port's four eval CLIs with ``--device cpu`` against the JAX
package's, on the world of ``tests/test_torch_inference_cli.py`` (the same
msgpack cUNet and depth-(1, 1, 1, 1) ResNet), 32x32, batch 4; and the
port's numpy classification report against scikit-learn's.  Bars: labels
and confusion matrices equal, report numbers within 1e-6 and its text
equal, the estimator errors within 1e-5, the same artifacts and copied
files; the numpy report equal to scikit-learn's (text, dict within 1e-12)."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
from sklearn.metrics import classification_report, confusion_matrix

from tests.test_torch_inference_cli import (  # noqa: F401
    build_world, small_jax_resnet)
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.cli import eval_class_transfer as jax_ect
from weather_unet_tpu.cli import eval_classifier_i2w as jax_eci
from weather_unet_tpu.cli import eval_estimator as jax_ee
from weather_unet_tpu.cli import eval_estimator_transfer as jax_eet
from weather_unet_tpu_torch.cli import (
    eval_class_transfer, eval_classifier_i2w, eval_estimator,
    eval_estimator_transfer)
from weather_unet_tpu_torch.evaluation.transfer import (
    classification_report_dict)

SIZE = 32
CLASSES = ["sunny", "cloudy", "rain", "snow", "foggy"]


@pytest.fixture(scope="module")
def world(tmp_path_factory, small_jax_resnet):  # noqa: F811
    return build_world(tmp_path_factory.mktemp("world"),
                       np.random.default_rng(1))


def assert_reports_equal(got, want):
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["text"] == want["text"]
    assert got["report"].keys() == want["report"].keys()
    for k, v in want["report"].items():
        if isinstance(v, dict):
            assert v.keys() == got["report"][k].keys()
            for m in v:
                assert abs(got["report"][k][m] - v[m]) <= 1e-6, (k, m)
        else:
            assert abs(got["report"][k] - v) <= 1e-6, k


def test_eval_class_transfer(world, tmp_path):
    argv = ["--pkl_path", world["split_pkl"], "--cp_path", world["cp"],
            "--classifier_path", world["est"], "--input_size", str(SIZE),
            "--batch_size", "4"]
    want = jax_ect.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = eval_class_transfer.main(argv + ["--output_dir",
                                           str(tmp_path / "port"),
                                           "--device", "cpu"])
    assert got["confusion_matrix"].sum() == 20      # 4 images x 5 classes
    assert_reports_equal(got, want)
    pd.testing.assert_frame_equal(pd.read_pickle(tmp_path / "port/cm.pkl"),
                                  pd.read_pickle(tmp_path / "jax/cm.pkl"))
    assert (os.path.exists(tmp_path / "port/pr_table.png")
            == os.path.exists(tmp_path / "jax/pr_table.png"))


def test_eval_estimator_transfer(world):
    argv = ["--image_root", world["img_dir"], "--pkl_path", world["pkl"],
            "--cp_path", world["cp"], "--estimator_path", world["est"],
            "--input_size", str(SIZE), "--batch_size", "4", "--mode", "test"]
    want = jax_eet.main(argv)
    got = eval_estimator_transfer.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys() and got["rows"].shape == (4, 5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_eval_classifier_i2w(world, tmp_path):
    argv = ["--pkl_path", world["split_pkl"], "--classifier_path",
            world["est"], "--input_size", str(SIZE), "--batch_size", "4",
            "--copy_misclassified"]
    want = jax_eci.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = eval_classifier_i2w.main(argv + ["--output_dir",
                                           str(tmp_path / "port"),
                                           "--device", "cpu"])
    assert len(got["y_true"]) == 5                  # one test image a class
    for k in ("y_true", "y_pred", "confusion_matrix"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))
    assert any(f.endswith("-pred.jpg") for f in os.listdir(tmp_path / "port"))
    cm = pd.read_pickle(tmp_path / "port" / "cm.pkl")
    assert list(cm.index) == CLASSES and cm.to_numpy().sum() == 5


def test_eval_estimator(world, tmp_path):
    argv = ["--image_root", world["img_dir"], "--pkl_path", world["pkl"],
            "--estimator_path", world["est"], "--input_size", str(SIZE),
            "--batch_size", "4", "--mode", "test", "--plot"]
    want = jax_ee.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = eval_estimator.main(argv + ["--output_dir", str(tmp_path / "port"),
                                      "--device", "cpu"])
    with open(tmp_path / "port" / "errors.pkl", "rb") as f:
        on_disk = pickle.load(f)
    assert got.keys() == want.keys() == on_disk.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(on_disk[k], got[k])
    assert got["signed_l1"].shape == (4, 5)         # one batch of the 6
    assert (tmp_path / "port" / "hist.png").exists()


@pytest.mark.parametrize("case", ["random", "missing_classes", "outside"])
def test_classification_report_matches_sklearn(case, rng):
    if case == "random":
        y_true, y_pred = rng.integers(0, 5, 40), rng.integers(0, 5, 40)
    elif case == "missing_classes":     # zero division: no true, no pred
        y_true = np.array([0, 0, 1, 1, 1, 3])
        y_pred = np.array([0, 1, 1, 1, 0, 0])
    else:                               # labels beyond the class list
        y_true = np.array([0, 1, 2, 5, 4, 4, 6])
        y_pred = np.array([0, 2, 2, 4, 4, 5, 1])
    kw = dict(labels=list(range(5)), target_names=CLASSES, zero_division=0)
    got = classification_report_dict(y_true, y_pred, CLASSES)
    assert got["text"] == classification_report(y_true, y_pred, **kw)
    want = classification_report(y_true, y_pred, output_dict=True, **kw)
    assert list(got["report"]) == list(want)
    for k, v in want.items():
        if isinstance(v, dict):
            for m in v:
                assert abs(got["report"][k][m] - v[m]) <= 1e-12, (k, m)
                assert type(got["report"][k][m]) is float
        else:
            assert abs(got["report"][k] - v) <= 1e-12, k
    np.testing.assert_array_equal(
        got["confusion_matrix"],
        confusion_matrix(y_true, y_pred, labels=list(range(5))))
    assert ("accuracy" in got["report"]) == (case != "outside")
