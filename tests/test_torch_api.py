"""The port's serving surface on the CPU: WeatherTransfer (load, translate,
translate_u8, bucketing, translate_to_classes, sweep) and the request
Batcher; plus the rule that the port imports nothing of JAX."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.api import WeatherTransfer as JaxWeatherTransfer
from weather_unet_tpu.data.transforms import normalize_batch
from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.cli.serve import Batcher
from weather_unet_tpu_torch.models import ConditionalUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cp_path(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("port") / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                "global_step": 0}, path)
    return path


@pytest.fixture(scope="module")
def wt(cp_path):
    return WeatherTransfer.load(cp_path, device="cpu")


def test_load_translate_and_u8_wire(wt, rng):
    assert wt.device.type == "cpu" and not wt.model.training
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    c = np.eye(5, dtype=np.float32)[[1, 3]]
    out = wt.translate(wt.preprocess(u8), c)
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.float32
    assert float(out.abs().max()) <= 1.0
    fast = wt.translate_u8(u8, c)
    assert fast.dtype == torch.uint8 and fast.shape == (2, 32, 32, 3)
    # the device-side normalize/denormalize is bit-identical to the host's
    np.testing.assert_array_equal(fast.numpy(),
                                  wt.to_uint8(wt.translate(wt.preprocess(u8),
                                                           c)))


def test_preprocess_and_to_uint8_match_jax(rng):
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        WeatherTransfer.preprocess(u8).numpy(),
        np.asarray(normalize_batch(jnp.asarray(u8))))
    y = rng.uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    want = JaxWeatherTransfer.to_uint8(y)
    np.testing.assert_array_equal(WeatherTransfer.to_uint8(y), want)
    np.testing.assert_array_equal(
        WeatherTransfer.to_uint8(torch.from_numpy(y)), want)


def test_bucketing_pads_to_power_of_two(wt, rng):
    seen = []
    hook = wt.model.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].shape[0]))
    try:
        x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
        c = np.eye(5, dtype=np.float32)[[0, 1, 2]]
        bucketed = wt.translate(x, c)
        exact = wt.translate(x, c, bucket=False)
        wt.translate(x[:1], c[:1])
        u8 = wt.translate_u8(
            rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8),
            np.eye(5, dtype=np.float32))
    finally:
        hook.remove()
    assert seen == [4, 3, 1, 8]
    assert bucketed.shape == exact.shape == (3, 32, 32, 3)
    assert u8.shape == (5, 32, 32, 3)
    # zero padding rows cannot leak into real rows (per-sample AdaIN); the
    # conv may still pick another algorithm per batch size
    np.testing.assert_allclose(bucketed.numpy(), exact.numpy(), atol=1e-5)


def test_translate_to_classes_and_sweep(wt, rng):
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    alls = wt.translate_to_classes(x)
    assert alls.shape == (5, 2, 32, 32, 3)
    direct = wt.translate(x, np.tile(np.eye(5, dtype=np.float32)[3], (2, 1)))
    np.testing.assert_allclose(alls[3].numpy(), direct.numpy(), atol=1e-5)

    def estimate(imgs):
        return imgs.mean(dim=(1, 2)) @ torch.ones(3, 5)

    frames = wt.sweep(x, estimate, num_frames=3)
    assert frames.shape == (3, 5, 2, 32, 32, 3)
    # theta = 0 makes axis k's condition 0, the estimate elsewhere
    pred = estimate(torch.from_numpy(x))
    c = pred.clone()
    c[:, 2] = 0.0
    np.testing.assert_allclose(frames[1, 2].numpy(), wt.translate(x, c).numpy(),
                               atol=1e-5)
    # every call runs on the current weights
    bias = wt.model.conv_last.bias
    with torch.no_grad():
        bias += 0.25
    try:
        again = wt.sweep(x, estimate, num_frames=3)
        np.testing.assert_allclose(again[1, 2].numpy(),
                                   wt.translate(x, c).numpy(), atol=1e-5)
        assert not torch.allclose(again, frames)
    finally:
        with torch.no_grad():
            bias -= 0.25


def test_load_errors(cp_path, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="num_classes=5"):
        WeatherTransfer.load(cp_path, num_classes=6, device="cpu")
    # any path not ending in .pt/.pth is read as flax msgpack
    garbage = tmp_path / "ckpt"
    garbage.write_bytes(b"\xc1 not msgpack")
    with pytest.raises(ValueError, match="msgpack"):
        WeatherTransfer.load(str(garbage), device="cpu")
    # no GPU and no device given: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WeatherTransfer.load(cp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        WeatherTransfer(ConditionalUNet(5))


def test_batcher_answers_concurrent_requests(cp_path, rng):
    wt = WeatherTransfer.load(cp_path, fuse_upconv=True, device="cpu")
    batcher = Batcher(wt, max_batch=8, batch_wait_ms=50.0)
    n = 6
    imgs = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    results = [None] * n

    def client(i):
        results[i] = batcher.submit(imgs[i], conds[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    direct = wt.translate_u8(imgs, conds).numpy()
    for r, d in zip(results, direct):
        assert r.shape == (32, 32, 3) and r.dtype == np.uint8
        # another batch size may move a value across a uint8 boundary
        assert np.abs(r.astype(np.int16) - d.astype(np.int16)).max() <= 1
    stats = batcher.stats()
    assert stats["requests"] == n
    assert stats["batches"] < n                      # grouping happened
    assert stats["readback_ms_p50"] <= stats["batch_ms_p50"] + 1e-6


def test_batcher_reports_errors_per_request(rng):
    class Broken:
        def translate_u8(self, x, c):
            raise ValueError("bad batch")

    batcher = Batcher(Broken(), max_batch=4, batch_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="bad batch"):
            batcher.submit(np.zeros((4, 4, 3), np.uint8),
                           np.zeros(5, np.float32))
    finally:
        batcher.close()


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, flax, scikit-learn
    and the JAX package out of sys.modules, and builds no kernel."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import torch\n"
        "import weather_unet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'weather_unet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from weather_unet_tpu_torch.kernels import _build\n"
        "from weather_unet_tpu_torch import runtime\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'triton', 'weather_unet_tpu', "
        "'sklearn'))\n"
        "lazy = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('PIL', 'pandas', 'tensorboard'))\n"
        "print(json.dumps({'modules': names, 'bad': bad, 'lazy': lazy, "
        "'built': len(_build._libs), 'runtime_built': len(runtime._builds)"
        " + (runtime._jpeg_found is not None), 'ops': sorted("
        "n for n in ('adain', 'upsample2x', 'upsample2x_backward') "
        "if hasattr(torch.ops.wut, n))}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "weather_unet_tpu_torch.api" in out["modules"]
    assert "weather_unet_tpu_torch.cli.serve" in out["modules"]
    assert "weather_unet_tpu_torch.evaluation.transfer" in out["modules"]
    assert "weather_unet_tpu_torch.models.resnet" in out["modules"]
    assert "weather_unet_tpu_torch.kernels.bottleneck" in out["modules"]
    assert "weather_unet_tpu_torch.train.gan" in out["modules"]
    assert "weather_unet_tpu_torch.models.sndisc" in out["modules"]
    assert "weather_unet_tpu_torch.ops.spectral" in out["modules"]
    for name in ("data.datasets", "data.sampler", "data.transforms",
                 "data.pipeline", "train.metrics", "train.preemption",
                 "train.checkpoint", "train.loops", "cli.train_transfer_est",
                 "cli.train_transfer_cls", "runtime", "data.cache",
                 "train.supervised", "cli.train_classifier",
                 "cli.train_estimator", "cli.demo", "cli.inf_transfer_c",
                 "cli.inf_transfer_e", "cli.inf_1year_signals",
                 "cli.inf_classifier_i2w", "cli.eval_class_transfer",
                 "cli.eval_estimator_transfer", "cli.eval_classifier_i2w",
                 "cli.eval_estimator", "models.inception_fid",
                 "evaluation.fid", "evaluation.inception_score",
                 "evaluation.goldens", "cli.fid_score", "cli.inception_score",
                 "core.export", "cli.export_serving",
                 "cli.convert_checkpoint"):
        assert f"weather_unet_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == [] and out["built"] == 0
    # nor the native runtime (built at first use, not on import)
    assert out["runtime_built"] == 0
    # Pillow, pandas and TensorBoard load only where a function needs them
    assert out["lazy"] == []
    # K1 and K2 are registered ops once their modules are imported
    assert out["ops"] == ["adain", "upsample2x", "upsample2x_backward"]
