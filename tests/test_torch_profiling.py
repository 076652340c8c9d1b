"""The port's ``core/profiling.py`` on the CPU against the JAX package's
(``weather_unet_tpu/core/profiling.py``, mirroring
``tests/test_misc_coverage.py``): ``StepTimer``'s summary, the trace
context (and the GAN trainer's ``profile_dir``), the host fingerprint, and
the pruning of an AOT root."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import Images, cfg_of, loaders, trainer
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu.core import profiling as jax_profiling
from weather_unet_tpu_torch.core import aot, profiling


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    """Delete what a test wrote once it ends: its checkpoints and weight
    files are ~0.1-0.5 GB each, and pytest keeps every test's directory
    until the run ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_step_timer_summary_equals_jax():
    samples = list(np.random.default_rng(0).uniform(0.01, 0.3, 57))
    port, ref = profiling.StepTimer(capacity=50), jax_profiling.StepTimer(
        capacity=50)
    assert port.summary() == ref.summary() == {}
    for dt in samples:
        for t in (port, ref):
            with t:
                pass
            t.samples[-1] = dt          # the same samples on both sides
    got, want = port.summary(), ref.summary()
    assert got.keys() == want.keys() and len(port.samples) == 50
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


def test_host_fingerprint_is_stable_and_covers_cpu_identity():
    fp = profiling._host_fingerprint()
    assert len(fp) == 12 and fp == profiling._host_fingerprint()
    int(fp, 16)
    basis = profiling._host_basis()
    assert basis["torch"] == torch.__version__ and basis["format"] == "v2"
    assert ("model name" in basis or "CPU part" in basis
            or "vendor_id" in basis)
    # the CPU tier's entries are keyed by it
    assert fp in aot._backend_fingerprint(torch.device("cpu"))


def _stale_root(root):
    root.mkdir()
    (root / "deadbeef0001").mkdir()                    # no manifest
    (root / "deadbeef0001" / "entry.pt2").write_bytes(b"stale")
    (root / "flat_entry").write_bytes(b"flat layout")
    liar = root / "deadbeef0002"                       # manifest/name differ
    liar.mkdir()
    (liar / "HOST.json").write_text(json.dumps({"fingerprint": "other"}))
    (liar / "0123.pt2").write_bytes(b"entry")
    (liar / ".tmp-abc.pt2").write_bytes(b"partial")
    other = root / "deadbeef0003"                      # valid, other host
    other.mkdir()
    (other / "HOST.json").write_text(
        json.dumps({"fingerprint": "deadbeef0003"}))
    keep = root / "deadbeef0004"
    keep.mkdir()


@pytest.mark.parametrize("via", ["function", "aot_cache"])
def test_prune_stale_cache(tmp_path, via):
    """A fingerprint directory whose manifest names another fingerprint
    goes with its entries, finished and partial; the kept directory and
    valid directories of other fingerprints stay, as the JAX function
    leaves them.  The JAX function also clears its package's legacy
    layouts (flat files, manifest-less directories), which the port never
    wrote: here they stay.  ``AotCache`` prunes its root when it first
    makes its own directory."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    _stale_root(port)
    shutil.copytree(port, ref)
    jax_profiling._prune_stale_cache(str(ref), keep="deadbeef0004")
    assert sorted(p.name for p in ref.iterdir()) == ["deadbeef0003",
                                                     "deadbeef0004"]
    legacy = ["deadbeef0001", "flat_entry"]
    if via == "function":
        profiling._prune_stale_cache(str(port), keep="deadbeef0004")
        assert sorted(p.name for p in port.iterdir()) == sorted(
            legacy + ["deadbeef0003", "deadbeef0004"])
        return
    shutil.rmtree(port / "deadbeef0004")
    sub = aot.AotCache(str(port)).dir_for("cpu")
    name = aot.fingerprint_dir_name("cpu")
    assert sorted(p.name for p in port.iterdir()) == sorted(
        legacy + ["deadbeef0003", name])
    assert json.loads((port / name / "HOST.json").read_text())[
        "fingerprint"] == name and sub == str(port / name)


def test_prune_keeps_what_the_tier_did_not_write(tmp_path):
    """An AOT root that is also a run's directory (``--aot_cache runs``)
    loses nothing of the run: files and directories of other names stay,
    and in a fingerprint directory that goes, only the tier's own files go
    (the directory stays while it holds anything else)."""
    root = tmp_path / "runs"
    root.mkdir()
    (root / "train.log").write_text("log")
    (root / "cp").mkdir()
    (root / "cp" / "ckpt_s0000000002.pt").write_bytes(b"checkpoint")
    (root / "events").mkdir()
    (root / "events" / "HOST.json").write_text(
        json.dumps({"fingerprint": "other"}))
    mixed = root / "abcdef012345"
    mixed.mkdir()
    (mixed / "HOST.json").write_text(json.dumps({"fingerprint": "other"}))
    (mixed / "0123.pt2").write_bytes(b"entry")
    (mixed / "notes.txt").write_text("mine")
    sub = aot.AotCache(str(root)).dir_for("cpu")
    assert sorted(p.name for p in root.iterdir()) == sorted(
        ["train.log", "cp", "events", "abcdef012345",
         aot.fingerprint_dir_name("cpu")])
    assert (root / "cp" / "ckpt_s0000000002.pt").read_bytes() == (
        b"checkpoint")
    assert (root / "events" / "HOST.json").exists()
    assert [p.name for p in mixed.iterdir()] == ["notes.txt"]
    assert os.path.isfile(os.path.join(sub, "HOST.json"))
