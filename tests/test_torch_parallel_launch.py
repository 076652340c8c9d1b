"""The port's multi-process runtime (``weather_unet_tpu_torch/parallel/
launch.py``) on the CPU: the cases of ``tests/test_multiprocess.py`` that
have a counterpart (the env contract, ``process_slice``, the barrier's
timeout knob, the launcher's CLI, failure propagation and tearing down
peers), the lockstep wrapper as the identity, NCCL refused for two ranks on
one card before any rendezvous, and two gloo ranks in child processes:
the barrier, ``broadcast``, the bucketed ``all_reduce_mean``, the
placement helpers and a BatchNorm whose moments span the ranks, against
the one-process computation.

Every rank runs in a child process under ``launch_local(timeout=...)`` of
at most 120 s; no pytest worker joins a process group."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    launch_ranks, no_thread_left, one_torch_thread, rank_env, rank_log)
from weather_unet_tpu_torch.parallel import launch


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_process_slice_single_process():
    assert launch.process_slice(16) == slice(0, 16)
    assert (launch.process_count(), launch.process_index()) == (1, 0)


def test_is_multiprocess_env(monkeypatch):
    monkeypatch.delenv("WUT_NUM_PROCESSES", raising=False)
    assert not launch.is_multiprocess()
    assert launch.maybe_initialize() is False   # no contract: no group
    monkeypatch.setenv("WUT_NUM_PROCESSES", "2")
    assert launch.is_multiprocess()


def test_barrier_timeout_env(monkeypatch):
    """WUT_BARRIER_TIMEOUT_S sets the barrier's (and the process group's)
    timeout; an explicit argument wins; a peer that never arrives raises
    TimeoutError naming the barrier."""
    class Store:
        def __init__(self):
            self.n = 0

        def add(self, key, k):
            self.n += k
            return self.n

    store = Store()

    class Dist:
        distributed_c10d = type("C10d", (), {
            "_get_default_store": staticmethod(lambda: store)})

        @staticmethod
        def get_world_size():
            return 2

    monkeypatch.setattr(launch, "_dist", lambda: Dist)
    monkeypatch.setenv("WUT_BARRIER_TIMEOUT_S", "3600")
    assert launch.collective_timeout_s() == 3600.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="barrier 'x': 1 of 2"):
        launch.barrier("x", timeout_s=0.2)        # explicit arg wins
    assert time.monotonic() - t0 < 5
    monkeypatch.setattr(launch, "_dist", lambda: None)
    launch.barrier("y")                           # no group: a no-op


def test_launcher_cli_requires_command():
    with pytest.raises(SystemExit):
        launch.main(["-n", "2", "--"])


def test_lockstep_compile_is_the_identity():
    def f(x):
        return x + 1

    assert launch.lockstep_compile(f, "t") is f


def test_launch_local_propagates_failure_and_sets_the_contract(tmp_path):
    # rank 1 fails only once rank 0 has printed: the launcher terminates a
    # failed rank's peers at once, which under load could stop rank 0
    # before its line is written
    script = ("import os, sys, time\n"
              "keys = ('WUT_NUM_PROCESSES', 'WUT_PROCESS_ID', "
              "'WUT_COORDINATOR', 'WUT_DEVICE', 'WUT_DIST_BACKEND')\n"
              "print({k: os.environ.get(k) for k in keys}, flush=True)\n"
              "rank = int(os.environ['WUT_PROCESS_ID'])\n"
              "ready = os.path.join(sys.argv[1], 'rank0.printed')\n"
              "if rank == 0:\n"
              "    open(ready, 'w').close()\n"
              "deadline = time.monotonic() + 30\n"
              "while not os.path.exists(ready) and "
              "time.monotonic() < deadline:\n"
              "    time.sleep(0.01)\n"
              "sys.exit(rank)\n")
    rc = launch.launch_local(2, [sys.executable, "-c", script,
                                 str(tmp_path)], cpu=True,
                             backend="gloo", env=rank_env(), timeout=60,
                             rank_logs=str(tmp_path))
    assert rc == 1
    for r in (0, 1):
        with open(tmp_path / f"rank{r}.log") as f:
            seen = eval(f.read())
        assert seen["WUT_NUM_PROCESSES"] == "2"
        assert seen["WUT_PROCESS_ID"] == str(r)
        assert seen["WUT_COORDINATOR"].startswith("127.0.0.1:")
        assert (seen["WUT_DEVICE"], seen["WUT_DIST_BACKEND"]) == ("cpu",
                                                                  "gloo")


def test_launch_local_tears_down_peers_on_rank_failure():
    """One rank dying terminates its peers promptly; a run past its
    ``timeout`` is terminated and raises."""
    script = ("import os, sys, time\n"
              "rank = int(os.environ['WUT_PROCESS_ID'])\n"
              "sys.exit(3) if rank == 1 else time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launch.launch_local(2, [sys.executable, "-c", script],
                             env=rank_env(), timeout=90)
    assert rc == 3
    assert time.monotonic() - t0 < 30
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        launch.launch_local(1, [sys.executable, "-c",
                                "import time; time.sleep(120)"],
                            env=rank_env(), timeout=1)
    assert time.monotonic() - t0 < 30


def test_nccl_on_a_shared_card_is_refused_before_the_rendezvous(
        monkeypatch):
    """NCCL takes one rank per card: two ranks on one card raise at once,
    naming --backend gloo, and no process group is started."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("WUT_NUM_PROCESSES", "2"), ("WUT_PROCESS_ID", "1"),
                 ("WUT_COORDINATOR", "127.0.0.1:1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WUT_DEVICE", raising=False)
    monkeypatch.delenv("WUT_DIST_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="--backend gloo"):
        launch.maybe_initialize()
    monkeypatch.setenv("WUT_DEVICE", "cpu")
    monkeypatch.setenv("WUT_DIST_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="gloo"):
        launch.maybe_initialize()
    assert not torch.distributed.is_initialized()


RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
from weather_unet_tpu_torch.parallel import launch, mesh
from weather_unet_tpu_torch.models.common import BatchNorm2d, sync_batchnorm

assert launch.maybe_initialize() and launch.maybe_initialize()
rank, world = launch.process_index(), launch.process_count()
launch.barrier("start")
out = {"rank": rank, "world": world, "slice": [launch.process_slice(8).start,
       launch.process_slice(8).stop]}
# one bucket: a vector, a matrix and a bfloat16 scalar
a, b, c = mesh.all_reduce_mean([
    torch.full((3,), float(rank)), torch.arange(4.).reshape(2, 2) * (rank + 1),
    torch.tensor(rank + 1.0, dtype=torch.bfloat16)])
out["mean"] = [a.tolist(), b.tolist()]
out["bf16"] = [str(c.dtype), float(c)]
t = torch.full((2,), float(rank + 7))
mesh.broadcast_([t])
out["broadcast"] = t.tolist()
plan = mesh.make_mesh(batch_size=8)
out["plan"] = [list(plan.shape), [str(d) for d in plan.devices],
               plan.process_count, plan.process_index]
x = np.arange(16, dtype=np.float32).reshape(8, 2)
out["shard"] = mesh.shard_batch(plan, {"x": x})["x"].tolist()
out["local"] = mesh.put_host_local(plan.batch(), x[:2]).tolist()
out["replicate"] = mesh.replicate(plan, np.full(2, rank + 3.0)).tolist()
# a BatchNorm over the ranks' rows equals one over the global batch
g = torch.Generator().manual_seed(0)
xs = torch.randn(4, 3, 5, 5, generator=g) * 3 + 1
bn = sync_batchnorm(BatchNorm2d(3))
with torch.no_grad():
    bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
mine = xs[rank * 2:(rank + 1) * 2].clone().requires_grad_(True)
y = bn(mine)
w = torch.randn(4, 3, 5, 5, generator=g)[rank * 2:(rank + 1) * 2]
(y * w).sum().backward()
out["bn"] = {"y": y.detach().tolist(), "gx": mine.grad.tolist(),
             "gw": mesh.all_reduce_mean([bn.weight.grad])[0].tolist(),
             "rm": bn.running_mean.tolist(), "rv": bn.running_var.tolist()}
launch.barrier("end")
with open(os.path.join(sys.argv[1], f"r{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def test_two_gloo_ranks_collectives_placement_and_batchnorm(tmp_path):
    """Two ranks on the CPU: the barrier, a bucketed mean over ranks (dtypes
    and shapes kept), broadcast from rank 0, the default plan (data=2),
    this rank's rows and a replicated value; a synced BatchNorm's output,
    input and weight gradients and running statistics equal the one-process
    BatchNorm's over the whole batch (the weight gradient summed over the
    ranks, as the steps' all-reduce sums it after dividing)."""
    rc = launch_ranks(2, [sys.executable, "-c", RANK_SCRIPT, str(tmp_path)],
                      tmp_path / "logs", timeout=120)
    assert rc == 0
    outs = []
    for r in (0, 1):
        with open(tmp_path / f"r{r}.json") as f:
            outs.append(json.load(f))
    assert "joined the process group as rank 1/2 (gloo, cpu)" in rank_log(
        tmp_path / "logs", 1)
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"]) == (r, 2)
        assert o["slice"] == [4 * r, 4 * r + 4]
        assert o["mean"] == [[0.5] * 3, [[0.0, 1.5], [3.0, 4.5]]]
        assert o["bf16"] == ["torch.bfloat16", 1.5]
        assert o["broadcast"] == [7.0, 7.0]
        assert o["plan"] == [[2, 1], ["cpu"], 2, r]
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        assert o["shard"] == x[4 * r:4 * r + 4].tolist()
        assert o["local"] == x[:2].tolist()
        assert o["replicate"] == [3.0, 3.0]

    from weather_unet_tpu_torch.models.common import BatchNorm2d

    g = torch.Generator().manual_seed(0)
    xs = (torch.randn(4, 3, 5, 5, generator=g) * 3 + 1).requires_grad_(True)
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
    y = bn(xs)
    (y * torch.randn(4, 3, 5, 5, generator=g)).sum().backward()
    got_y = np.concatenate([o["bn"]["y"] for o in outs])
    got_gx = np.concatenate([o["bn"]["gx"] for o in outs])
    np.testing.assert_allclose(got_y, y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got_gx, xs.grad.numpy(), atol=1e-5)
    for o in outs:
        np.testing.assert_allclose(np.asarray(o["bn"]["gw"]) * 2,
                                   bn.weight.grad.numpy(), rtol=1e-5)
        np.testing.assert_allclose(o["bn"]["rm"], bn.running_mean.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(o["bn"]["rv"], bn.running_var.numpy(),
                                   rtol=1e-5)


def test_launcher_main_runs_a_command_on_cpu_ranks(tmp_path):
    """``python -m weather_unet_tpu_torch.parallel.launch -n 2 --cpu --``
    runs the command once a rank, each joining the group over gloo."""
    code = ("import os, sys\n"
            "from weather_unet_tpu_torch.parallel import launch\n"
            "assert launch.maybe_initialize()\n"
            "launch.barrier('main')\n"
            "open(os.path.join(sys.argv[1], "
            "f'ok{launch.process_index()}'), 'w').close()\n")
    res = subprocess.run(
        [sys.executable, "-m", "weather_unet_tpu_torch.parallel.launch",
         "-n", "2", "--cpu", "--timeout", "100", "--", sys.executable, "-c",
         code, str(tmp_path)], env=rank_env(), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert sorted(os.listdir(tmp_path)) == ["ok0", "ok1"]
