"""The port's supervised training CLIs (``cli/train_estimator.py``,
``cli/train_classifier.py``) end to end with ``--device cpu`` on seeded
synthetic JPEGs at 32x32, batch 2: the full ResNet-101, the native augment
behind the decode cache, the padded eval tail, the terminal checkpoint at
epochs x steps per epoch, ``--pre_trained`` leaving the backbone as it was
built; the unported flags exit non-zero naming their roadmap item, and
without a GPU the CLIs refuse to start unless given ``--device cpu``."""

import pytest
import torch

from tests.test_torch_train_cli import data  # noqa: F401  (the fixture)
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu_torch.cli import train_classifier as cls_cli
from weather_unet_tpu_torch.cli import train_estimator as est_cli
from weather_unet_tpu_torch.models import ResNet101
from weather_unet_tpu_torch.train.checkpoint import latest_checkpoint
from weather_unet_tpu_torch.train.supervised import FROZEN_PREFIXES


def common(tmp_path, epochs):
    return ["--device", "cpu", "--input_size", "32", "-bs", "2",
            "--num_epoch", str(epochs), "--num_workers", "2",
            "--save_path", str(tmp_path / "cp"), "--log_dir",
            str(tmp_path / "runs"), "--name", "run"]


def final(tmp_path):
    return torch.load(latest_checkpoint(str(tmp_path / "cp"), "run"),
                      weights_only=True)


def test_estimator_cli(data, tmp_path, capsys):  # noqa: F811
    """The frame's 8 train rows (z-scored by themselves), 4 steps an epoch,
    two epochs, bf16, augmentation through the decode cache; the 6 test
    rows evaluated at step 0."""
    est_cli.main(["--image_root", data["flickr"], "--pkl_path",
                  str(data["root"] / "frame.pkl"), "--augmentation",
                  "--dtype", "bf16", "--decode_cache",
                  str(tmp_path / "cache")] + common(tmp_path, 2))
    out = capsys.readouterr().out
    assert "train augment: decode cache + native" in out
    assert "Done: training" in out
    tree = final(tmp_path)
    assert (tree["global_step"], tree["epoch"], tree["epoch_step"]) == (
        8, 2, 0)
    sd = tree["model"]
    assert sd["fc.weight"].shape == (5, 2048)
    assert sd["conv1.weight"].dtype == torch.float32    # master weights
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())
    with pytest.raises(SystemExit, match="--mode must be T or E"):
        est_cli.main(["--image_root", data["flickr"], "--pkl_path",
                      str(data["root"] / "frame.pkl"), "--mode", "X"]
                     + common(tmp_path, 1))


def test_classifier_cli_pre_trained(data, tmp_path, capsys):  # noqa: F811
    """The i2w split (8 train paths, 4 steps), one epoch, ``--pre_trained``:
    conv1, bn1 and layer1-3 keep the seeded init bit for bit, layer4 and fc
    train."""
    cls_cli.main(["--pkl_path", str(data["root"] / "i2w.pkl"),
                  "--pre_trained"] + common(tmp_path, 1))
    assert "Done: training" in capsys.readouterr().out
    tree = final(tmp_path)
    assert tree["global_step"] == 4
    init = ResNet101(5, generator=torch.Generator().manual_seed(0))
    params = dict(init.named_parameters())
    for name, p in params.items():
        same = torch.equal(tree["model"][name], p.detach())
        assert same == name.startswith(FROZEN_PREFIXES), name


def test_unported_flags_and_missing_gpu(data, tmp_path,  # noqa: F811
                                        monkeypatch):
    est = ["--image_root", data["flickr"], "--pkl_path",
           str(data["root"] / "frame.pkl")]
    cls = ["--pkl_path", str(data["root"] / "i2w.pkl")]
    for cli, base, flags in ((est_cli, est, [["--aot_cache", "x"],
                                             ["--multi"]]),
                             (cls_cli, cls, [["--aot_cache", "x"]])):
        for flag in flags:
            with pytest.raises(SystemExit, match="Mesh, AOT and multi-"
                                                 "process") as e:
                cli.main(base + flag + common(tmp_path, 1))
            assert e.value.code not in (0, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli, base in ((est_cli, est), (cls_cli, cls)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base)
