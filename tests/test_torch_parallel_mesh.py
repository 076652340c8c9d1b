"""The port's plan and placement (``weather_unet_tpu_torch/parallel/
mesh.py``) on the CPU, held to the JAX package's ``make_mesh`` over
``jax.devices()[:n]`` of the suite's 8 virtual CPU devices (no
computation): the same axis choices, the clamp of the data axis to a
divisor of the batch, the same refusals with the same messages (the
multi-process one with two processes of four devices each against JAX's
eight); the JAX package's guards on tensor parallelism in the trainers
and the API, a model axis without it (replicas), the trainers' one rank a
process, and ``MeshPlan.spatial``'s guard with JAX's message (spatial
partitioning itself: ``tests/test_torch_spatial.py``); the placement
helpers
over two local CPU devices; the same exports as the JAX package."""

import shutil
import types

import numpy as np
import jax
import pytest
import torch

import weather_unet_tpu.parallel as jax_parallel
import weather_unet_tpu_torch.parallel as parallel
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from weather_unet_tpu_torch.parallel import launch
from weather_unet_tpu_torch.parallel.mesh import (
    MeshPlan, batch_sharding, make_mesh, put_host_local, replicate,
    replicated_sharding, shard_batch)

GUARD = "spatial partitioning degree"


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def both(n, **kw):
    """(JAX's mesh shape or error message, the port's) over n devices."""
    out = []
    for build in (lambda: dict(jax_make_mesh(jax.devices()[:n], **kw)
                                .mesh.shape),
                  lambda: make_mesh(["cpu"] * n, **kw).mesh_shape):
        try:
            out.append(build())
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_axis_choices_and_refusals_match_jax(n):
    """Every (data, model, batch_size) combination over n devices: the
    same shape or the same refusal message."""
    seen = 0
    for model in (0, 1, 2, 3, 4, 8, 9):
        for data in (None, 1, 2, 3, 4, 8):
            for batch_size in (None, 1, 2, 3, 4, 6, 8, 12):
                want, got = both(n, data=data, model=model,
                                 batch_size=batch_size)
                assert got == want, (n, data, model, batch_size)
                seen += isinstance(got, dict)
    assert seen > 0


def test_multi_process_refusal_matches_jax(monkeypatch):
    """Two processes of four devices against JAX's eight: a batch of 6
    would leave devices out of the grid, which both refuse alike; a batch
    of 8 spans them, rank 1 holding grid positions 4-7."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(launch, "process_count", lambda: 2)
    monkeypatch.setattr(launch, "process_index", lambda: 1)
    for kw in (dict(batch_size=6), dict(data=2), dict(model=3)):
        with pytest.raises(ValueError) as jerr:
            jax_make_mesh(jax.devices()[:8], **kw)
        with pytest.raises(ValueError) as perr:
            make_mesh(["cpu"] * 4, **kw)
        assert str(perr.value) == str(jerr.value)
        assert "multi-process mesh must span all 8 devices" in str(
            perr.value)
    plan = make_mesh(["cpu"] * 4, batch_size=8)
    assert (plan.shape, plan.process_count, plan.process_index) == (
        (8, 1), 2, 1)
    assert len(plan.devices) == 4


def test_model_axis_and_spatial_refuse_naming_item_4b(tmp_path):
    """Spatial partitioning (item 4c, ported) meets JAX's guard with JAX's
    message and places a 64² input; ``tensor_parallel`` (item 4b,
    tests/test_torch_tensor_parallel.py) without a model axis of 2 meets
    the JAX package's
    guard; a model axis without it keeps a replica on each device, as in
    JAX; a trainer given a plan of two devices in one process meets the
    one-rank-a-process refusal."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import (
        WeatherTransferTrainer, train_supervised)

    tp = make_mesh(["cpu", "cpu"], model=2)
    assert tp.mesh_shape == {"data": 1, "model": 2}
    assert tp.spatial(input_size=64).spec == ("data", "model")
    with pytest.raises(ValueError, match=GUARD) as perr:
        tp.spatial(input_size=16)
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(jax.devices()[:2], model=2).spatial(input_size=16)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="tensor_parallel requires a "
                                         "MeshPlan with a 'model' axis"):
        WeatherTransfer(ConditionalUNet(5), plan=make_mesh(["cpu"]),
                        tensor_parallel=True)
    assert len(WeatherTransfer(ConditionalUNet(5), plan=tp)._replicas) == 2
    with pytest.raises(ValueError, match="tensor_parallel requires a mesh "
                                         "with a 'model' axis"):
        WeatherTransferTrainer(GanConfig(input_size=16, batch_size=2),
                               lambda x: x.mean(dim=(2, 3)),
                               tensor_parallel=True,
                               save_dir=str(tmp_path), device="cpu")
    # one rank a process: a plan that puts two devices in this process is
    # the launcher's job in a trainer
    with pytest.raises(ValueError, match="parallel.launch -n K"):
        WeatherTransferTrainer(GanConfig(input_size=16, batch_size=2),
                               lambda x: x.mean(dim=(2, 3)), plan=tp,
                               tensor_parallel=True,
                               save_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="parallel.launch -n K"):
        train_supervised(None, None, None, None, state=None, num_epoch=1,
                         plan=tp)
    with pytest.raises(ValueError, match="parallel.launch -n K"):
        train_supervised(None, None, None, None, state=None, num_epoch=1,
                         plan=make_mesh(["cpu", "cpu"]))


def test_placement_over_two_local_devices():
    """One process, two CPU devices: the batch splits in order, a
    replicated value is copied to each, a host-local batch is this
    process's whole batch; one device gives plain tensors."""
    plan = make_mesh(["cpu", "cpu"])
    assert plan.shape == (2, 1) and plan.n_data == 2
    assert batch_sharding(plan).spec == ("data",)
    assert replicated_sharding(plan).spec == ()
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    a, b = shard_batch(plan, {"x": x})["x"]
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(), x)
    assert a.shape == (3, 2)
    r = replicate(plan, [torch.ones(2)])[0]
    assert len(r) == 2 and all(torch.equal(t, torch.ones(2)) for t in r)
    src = torch.zeros(3)
    one = make_mesh(["cpu"])
    out = replicate(one, src)
    assert torch.equal(out, src) and out is not src     # a copy
    got = put_host_local(one.batch(), (x, x[:2]))
    assert isinstance(got, tuple) and torch.equal(got[0],
                                                  torch.from_numpy(x))
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch(plan, x[:5])


def test_default_mesh_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_exports_match_the_jax_package():
    """The names the JAX package's ``parallel/__init__.py`` imports (its
    submodules, loaded or not by other tests, are not exports)."""
    names = {n for n in dir(jax_parallel) if not n.startswith("_")
             and not isinstance(getattr(jax_parallel, n), types.ModuleType)}
    assert names == {"MeshPlan", "batch_sharding", "make_mesh",
                     "replicated_sharding", "shard_batch"}
    for n in names:
        assert hasattr(parallel, n), n
    assert isinstance(make_mesh(["cpu"]), MeshPlan)
