"""The port's FID and Inception Score CLIs (``cli/fid_score.py``,
``cli/inception_score.py``) with ``--device cpu`` against the JAX
package's CLIs, on 8 seeded 64x64 JPEGs per directory and the same seeded
random weights (BatchNorm calibrated, written as a ``.pth`` that both read
with ``--weights``): FID and IS within 1e-4 relative (the features differ
by float32 order and the resize's taps, ``tests/test_torch_inception.py``);
the ``.npz`` statistics round trip (the saved statistics against JAX's at
rtol 1e-3 beside the FID bar, and an ``.npz`` against a directory giving
the direct run's FID to 1e-10); ``.npz`` against ``.npz`` without building
the network; the refusals without weights."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_inception import port_inception
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.cli import fid_score as jax_fid_cli
from weather_unet_tpu.cli import inception_score as jax_is_cli
from weather_unet_tpu_torch.cli import fid_score, inception_score
from weather_unet_tpu_torch.evaluation import fid

CPU = ["--device", "cpu"]


def write_jpegs(d, n, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        # smooth seeded pictures: a JPEG of pure noise is mostly artifacts
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        img = Image.fromarray(base).resize((64, 64), Image.BILINEAR)
        img.save(d / f"{i}.jpg", quality=90)
    return str(d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    weights = {}
    for name, kw in (("fid", dict(num_logits=1008)),
                     ("tv", dict(num_logits=1000, tf_variant=False))):
        model = port_inception(seed=len(weights), size=64, with_logits=True,
                               **kw)
        weights[name] = str(root / f"{name}.pth")
        torch.save(model.state_dict(), weights[name])
    return {"a": write_jpegs(root / "a", 8, 1),
            "b": write_jpegs(root / "b", 8, 2), "root": root, **weights}


def test_fid_cli_matches_jax_and_npz_round_trip(world, capsys):
    a, b, root = world["a"], world["b"], world["root"]
    args = [a, b, "--weights", world["fid"], "--batch-size", "4"]
    want = jax_fid_cli.main(args)
    got = fid_score.main(args + CPU)
    assert "converted" in capsys.readouterr().out
    assert got == pytest.approx(want, rel=1e-4) and got > 0

    ours, theirs = str(root / "a.npz"), str(root / "a_jax.npz")
    assert fid_score.main([a, b, "--weights", world["fid"],
                           "--save-stats", ours] + CPU) is None
    jax_fid_cli.main([a, b, "--weights", world["fid"], "--save-stats",
                      theirs])
    with np.load(ours) as f, np.load(theirs) as g:
        assert f["mu"].shape == (2048,) and f["sigma"].shape == (2048, 2048)
        np.testing.assert_allclose(f["mu"], g["mu"], rtol=1e-3, atol=1e-4)
    # the saved statistics give the direct run's distance
    assert fid_score.main([ours, b, "--weights", world["fid"]] + CPU) == \
        pytest.approx(got, rel=1e-10)


def test_npz_against_npz_never_builds_the_network(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        x = rng.standard_normal((20, 6))
        paths.append(str(tmp_path / f"{i}.npz"))
        np.savez(paths[-1], mu=x.mean(0), sigma=np.cov(x, rowvar=False))

    def refuse(*a, **kw):
        raise AssertionError("the network was built")

    monkeypatch.setattr(fid, "make_feature_fn", refuse)
    got = fid_score.main(paths)         # no --device: no card is needed
    assert got == pytest.approx(jax_fid_cli.main(paths), rel=1e-10)


@pytest.mark.parametrize("head", ["tv", "fid"])
def test_inception_score_cli_matches_jax(world, head, capsys):
    args = ["--image_dir", world["a"], "--weights", world[head],
            "--input_size", "48", "--batch_size", "4", "--splits", "2"]
    want = jax_is_cli.main(args)
    jax_out = capsys.readouterr().out
    got = inception_score.main(args + CPU)
    out = capsys.readouterr().out
    label = ("reference-comparable" if head == "tv"
             else "DIFFERENT metric")
    assert label in out and label in jax_out
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] > 1.0


def test_refusals_without_weights(world, tmp_path, capsys):
    with pytest.raises(RuntimeError, match="No FID inception weights"):
        fid_score.main([world["a"], world["b"]] + CPU)
    with pytest.raises(SystemExit, match="random weights"):
        inception_score.main(["--image_dir", world["a"]] + CPU)
    # a pool3-only file scores FID, not IS
    sd = torch.load(world["fid"], weights_only=True)
    headless = str(tmp_path / "pool3.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith("fc.")},
               headless)
    with pytest.raises(SystemExit, match="no fc head"):
        inception_score.main(["--image_dir", world["a"], "--weights",
                              headless] + CPU)
    # --allow-random-weights: structural smoke runs, labelled as such
    stats = str(tmp_path / "random.npz")
    fid_score.main([world["a"], world["b"], "--allow-random-weights",
                    "--save-stats", stats] + CPU)
    with np.load(stats) as f:
        assert np.isfinite(f["mu"]).all() and f["mu"].shape == (2048,)
    mean, _ = inception_score.main(["--image_dir", world["a"],
                                    "--allow-random-weights", "--input_size",
                                    "48", "--splits", "2"] + CPU)
    assert np.isfinite(mean)
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and "random Inception weights" in out
