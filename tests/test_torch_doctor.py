"""The port's ``cli/doctor.py`` and ``testing.py`` on the CPU, against the
JAX package's (``weather_unet_tpu/cli/doctor.py``, ``testing.py``): the
report's fields without a GPU (and its non-zero exit, with the CPU never
reported as the device), the CUDA-init watchdog, ``--goldens`` equal to the
JAX report on the same registry, and the synthetic i2w world and random
classifier file equal to the JAX package's from the same seed."""

import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu import testing as jax_testing
from weather_unet_tpu.cli import doctor as jax_doctor
from weather_unet_tpu_torch import testing
from weather_unet_tpu_torch.cli import doctor
from weather_unet_tpu_torch.core.aot import AotCache


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    """Delete what a test wrote once it ends: its checkpoints and weight
    files are ~0.1-0.5 GB each, and pytest keeps every test's directory
    until the run ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def no_gpu(monkeypatch, tmp_path):
    """No GPU, a HOME of the test's own and one ``WUT_`` variable."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("WUT_DROPOUT", "bits16")
    return tmp_path


def test_collect_reports_the_host_without_a_gpu(no_gpu):
    root = no_gpu / "aot"
    x = torch.ones(2, 3)
    AotCache(str(root)).load_or_compile(lambda a: a * 2, x)
    info = doctor.collect()
    assert info["backend_ok"] is False
    assert "no CUDA device" in info["backend_error"]
    assert "platform" not in info and "devices" not in info   # not the CPU
    assert info["torch"] == torch.__version__
    assert info["python"].count(".") == 2
    assert set(info["nvcc"]) == {"found", "path"}
    kernels = info["kernels"]
    assert kernels["build_dir"].endswith(os.path.join(
        "weather_unet_tpu_torch", "_build"))
    assert set(kernels["built"]) == {
        "adain", "upsample", "upconv", "bottleneck", "bottleneck_tc32",
        "bottleneck_tc32c", "bottleneck_tc64", "bottleneck_tc64c",
        "bottleneck_f32tc16", "bottleneck_f32tc16c"}
    assert info["native_runtime"]["mode"] in ("jpeg", "augment-only",
                                              "not built")
    assert info["wut_env"] == {k: v for k, v in os.environ.items()
                               if k.startswith("WUT_")}
    assert info["wut_env"]["WUT_DROPOUT"] == "bits16"
    # the tier keeps nothing on disk: no AOT cache to report, none made
    assert "aot_cache" not in info and not root.exists()


def test_json_output_and_exit_code(no_gpu, capsys):
    assert doctor.main(["--json", "--probe"]) == 1
    out = capsys.readouterr()
    info = json.loads(out.out)
    assert info["backend_ok"] is False and "probe_roundtrip_ms" not in info
    assert "no usable GPU" in out.err
    assert doctor.main([]) == 1
    text = capsys.readouterr().out
    assert "backend_error" in text and "wut_env" in text


def test_init_watchdog_times_out(monkeypatch):
    """A CUDA init that hangs is reported as a timeout, not waited on."""
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: time.sleep(1.0) or False)
    t0 = time.perf_counter()
    info = doctor.collect(init_timeout=0.1)
    assert time.perf_counter() - t0 < 30
    assert info["backend_ok"] is False
    assert "timed out after" in info["backend_error"]
    time.sleep(1.0)            # the init thread ends before the module does


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_goldens_report_equals_jax(capsys, as_json):
    rc = jax_doctor.report_goldens(as_json=as_json)
    want = capsys.readouterr().out
    argv = ["--goldens"] + (["--json"] if as_json else [])
    assert doctor.main(argv) == rc
    assert capsys.readouterr().out == want


def test_testing_worlds_equal_jax(tmp_path):
    """The i2w world: the same tree, bytes and split pickle (relative to
    each root); the random classifier: the same keys and shapes as the JAX
    package's file."""
    port = testing.build_i2w_world(tmp_path / "port")
    ref = jax_testing.build_i2w_world(tmp_path / "jax")
    assert testing.I2W_CLASSES == jax_testing.I2W_CLASSES

    def rel(world, root):
        return {k: [os.path.relpath(p, root) for p in v]
                for k, v in world["paths"].items()}

    assert rel(port, tmp_path / "port") == rel(ref, tmp_path / "jax")
    for p, q in zip(port["paths"]["train"] + port["paths"]["test"],
                    ref["paths"]["train"] + ref["paths"]["test"]):
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()
    with open(port["split_pkl"], "rb") as f:
        split = pickle.load(f)
    assert {k: [os.path.relpath(p, tmp_path / "port") for p in v]
            for k, v in split.items()} == rel(ref, tmp_path / "jax")

    got = torch.load(testing.build_random_classifier_pt(
        tmp_path / "port.pt", seed=3), weights_only=True)
    # the JAX function writes numpy arrays, which only a full unpickle reads
    want = torch.load(jax_testing.build_random_classifier_pt(
        tmp_path / "jax.pt", seed=3), weights_only=False)
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = torch.as_tensor(np.asarray(v))
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
