"""The port's ``core/profiling.py`` on the CPU against the JAX package's
(``weather_unet_tpu/core/profiling.py``, mirroring
``tests/test_misc_coverage.py``): ``StepTimer``'s summary and the trace
context (and the GAN trainer's ``profile_dir``)."""

import json
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import Images, cfg_of, loaders, trainer
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu.core import profiling as jax_profiling
from weather_unet_tpu_torch.core import profiling


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    """Delete what a test wrote once it ends: its checkpoints and weight
    files are ~0.1-0.5 GB each, and pytest keeps every test's directory
    until the run ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("capacity,n", [(50, 57), (1000, 3), (1, 4)])
def test_step_timer_summary_equals_jax(capacity, n):
    """The same samples give the JAX timer's summary: a full window that
    dropped its oldest samples, a short one, and a window of one."""
    samples = list(np.random.default_rng(n).uniform(0.01, 0.3, n))
    port, ref = profiling.StepTimer(capacity=capacity), (
        jax_profiling.StepTimer(capacity=capacity))
    assert port.summary() == ref.summary() == {}
    for dt in samples:
        for t in (port, ref):
            with t:
                pass
            t.samples[-1] = dt          # the same samples on both sides
    got, want = port.summary(), ref.summary()
    assert got.keys() == want.keys()
    assert port.samples == ref.samples == samples[-capacity:]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k


def test_trace_writes_a_chrome_trace_and_none_writes_nothing(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof is not None
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    with profiling.trace(None) as prof:
        torch.ones(2).sum()
    assert prof is None and sorted(p.name for p in tmp_path.iterdir()) == [
        "t"]


def test_trace_is_written_when_the_block_raises(tmp_path):
    """As the JAX ``trace`` stops its trace in ``finally``: a run that
    fails still leaves the trace of what it did."""
    with pytest.raises(FloatingPointError):
        with profiling.trace(str(tmp_path / "t")):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
            raise FloatingPointError("diverged")
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_trainer_profile_dir_traces_fit(tmp_path):
    """``profile_dir`` is no longer refused: ``fit`` runs under the trace,
    which lands in the directory with the step's work in it."""
    tr = trainer(tmp_path, cfg_of(num_epoch=1), profile_dir=str(
        tmp_path / "prof"))
    tr.fit(*loaders(Images(5)))
    assert tr.state.global_step == 2
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(
        path.read_text())["traceEvents"]}
    assert any("convolution" in n for n in names)
