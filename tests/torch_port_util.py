"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
layout converters between the JAX package's NHWC/HWIO and the port's
NCHW/OIHW, a fixture that keeps PyTorch to one intra-op thread, one that
fails a module whose tests leave a thread running, and one that closes the
summary writers a test's trainers open.

A test module imports the fixtures to put them in force for itself:

    from tests.torch_port_util import (  # noqa: F401
        nchw, nhwc, no_thread_left, one_torch_thread)
"""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the importing module runs (the suite runs
    several workers on few cores); restored after, so no other module is
    affected."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def no_thread_left():
    """Fail the importing module if its tests leave a thread running: a
    server, ``Batcher``, loader, checkpointer or summary writer that a test
    starts is stopped before the module ends (threads left behind outlive
    the module in its pytest worker).  Threads that are ending get 10 s."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, ("threads left running by this module's tests: "
                      f"{sorted(_describe(t) for t in left)}")


@pytest.fixture(autouse=True)
def close_summary_writers(monkeypatch):
    """Close every summary writer the test opens (``train/metrics.py``):
    a GAN trainer, and so each GAN training CLI, keeps its writer and
    TensorBoard's writer thread for the life of the process, as the JAX
    package's does."""
    from weather_unet_tpu_torch.train import metrics

    opened = []
    init = metrics.SummaryWriter.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        opened.append(self)

    monkeypatch.setattr(metrics.SummaryWriter, "__init__", record)
    yield
    for writer in opened:
        writer.close()


def _describe(t: threading.Thread) -> str:
    target = getattr(t, "_target", None)
    where = getattr(target, "__qualname__", None) or type(t).__qualname__
    return f"{t.name} ({getattr(target, '__module__', '')}.{where})"


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy array -> contiguous NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy array."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def oihw(k: np.ndarray) -> torch.Tensor:
    """HWIO conv kernel -> contiguous OIHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def block_inputs(rng, b=2, h=8, w=12, c=16, o=8):
    """NHWC/HWIO numpy inputs of a fused decoder-block entry: x, kernel, cb,
    scale, shift."""
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (0.1 * rng.standard_normal((3, 3, c, o))).astype(np.float32),
            (0.1 * rng.standard_normal((b, 2 * h, 2 * w, o))).astype(np.float32),
            rng.uniform(0.5, 2.0, (b, c)).astype(np.float32),
            rng.standard_normal((b, c)).astype(np.float32))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_WORKER = os.path.join(REPO, "tools", "dp_train_torch.py")


def rank_env(**extra) -> dict:
    """The environment of a test's rank processes: the repository on the
    path, one thread each, a collective timeout of 60 s."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               WUT_BARRIER_TIMEOUT_S="60")
    for k in ("WUT_NUM_PROCESSES", "WUT_PROCESS_ID", "WUT_COORDINATOR",
              "WUT_DEVICE", "WUT_DIST_BACKEND", "WUT_LOCAL_RANK",
              "WUT_LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    env.update(extra)
    return env


def launch_ranks(n: int, cmd, logs, *, cpu: bool = True, timeout=120,
                 env=None) -> int:
    """``parallel/launch.py::launch_local`` for a test: ranks in child
    processes (a pytest worker never joins a process group itself), each
    rank's output in ``logs/rank<i>.log``, the whole run bounded by
    ``timeout`` seconds.  A rendezvous that lost its port to another
    process (EADDRINUSE) is retried once on a new port; nothing else is."""
    from weather_unet_tpu_torch.parallel.launch import launch_local

    for attempt in range(2):
        d = os.path.join(str(logs), f"try{attempt}")
        rc = launch_local(n, list(cmd), cpu=cpu, env=env or rank_env(),
                          timeout=timeout, rank_logs=d)
        text = "".join(_read(f) for f in sorted(
            glob.glob(os.path.join(d, "*.log"))))
        if rc == 0 or not ("EADDRINUSE" in text
                           or "Address already in use" in text):
            break
    if rc != 0:
        print(text)
    return rc


def _read(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()


def rank_log(logs, rank: int) -> str:
    """The text of ``rank``'s log from the last attempt of
    ``launch_ranks``."""
    d = sorted(glob.glob(os.path.join(str(logs), "try*")))[-1]
    return _read(os.path.join(d, f"rank{rank}.log"))
