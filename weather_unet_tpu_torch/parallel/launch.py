"""Multi-process launch: ``torch.distributed`` init and a single-node
spawner -- the port of ``weather_unet_tpu/parallel/launch.py``.

One process is one rank with one device.  Every training CLI calls
:func:`maybe_initialize` first; under the env contract below it joins the
process group through rank 0's TCP store and makes this rank's card the
current device.  Batches are split by rank (``data/pipeline.py``:
``BatchLoader(process_shard=True)`` loads ``process_slice`` of each global
batch), and the steps all-reduce their gradients in one flat bucket per
network (``parallel/mesh.py::all_reduce_mean``).

``python -m weather_unet_tpu_torch.parallel.launch -n K [--cpu] [--backend
B] -- <cmd ...>`` sets the env contract and runs K copies of ``<cmd>``; on
several hosts a resource manager sets the same variables instead.

Env contract (the JAX package's, so one launcher drives both):

``WUT_NUM_PROCESSES``
    the world size.  Unset: no process group, everything here no-ops.
``WUT_PROCESS_ID``
    this process's rank in [0, WUT_NUM_PROCESSES).
``WUT_COORDINATOR``
    ``host:port`` of rank 0's TCP store.
``WUT_BARRIER_TIMEOUT_S``
    seconds a barrier or a collective waits for its peers (default 1800).
``WUT_DEVICE``
    ``cpu`` puts every rank on the CPU (the launcher's ``--cpu``); otherwise
    rank r takes card ``WUT_LOCAL_RANK % device_count`` (``WUT_LOCAL_RANK``
    defaults to the rank: one host).
``WUT_DIST_BACKEND``
    the process group's backend: ``nccl`` on the card and ``gloo`` on the
    CPU unless this (or the launcher's ``--backend``) says otherwise.  NCCL
    takes one rank per card; two ranks sharing one card run over ``gloo``,
    which carries CUDA tensors for ``broadcast`` and ``all_reduce``.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 1800.0


def _dist():
    d = torch.distributed
    return d if d.is_available() and d.is_initialized() else None


def process_count() -> int:
    """The world size of the process group (1 without one)."""
    d = _dist()
    return d.get_world_size() if d else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    d = _dist()
    return d.get_rank() if d else 0


def is_multiprocess() -> bool:
    """True when the env contract requests a multi-process run."""
    return int(os.environ.get("WUT_NUM_PROCESSES", "1")) > 1


def collective_timeout_s() -> float:
    return float(os.environ.get("WUT_BARRIER_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def local_rank() -> int:
    return int(os.environ.get("WUT_LOCAL_RANK",
                              os.environ.get("WUT_PROCESS_ID", "0")))


def maybe_initialize() -> bool:
    """Join the process group if the env contract asks for it.

    Returns True when this process is a rank of an initialized process
    group (a world of one included: ``launch -n 1`` runs the collectives
    too), False when the contract is absent.  Safe to call more than once.
    NCCL with more ranks on this host than cards raises before any
    rendezvous, naming ``--backend gloo``: it would fail or hang later."""
    if _dist() is not None:
        return True
    if "WUT_NUM_PROCESSES" not in os.environ:
        return False
    n = int(os.environ["WUT_NUM_PROCESSES"])
    rank = int(os.environ["WUT_PROCESS_ID"])
    on_cpu = os.environ.get("WUT_DEVICE", "") == "cpu"
    backend = os.environ.get("WUT_DIST_BACKEND") or (
        "gloo" if on_cpu else "nccl")
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for this rank; launch with "
                "--cpu (WUT_DEVICE=cpu) to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("WUT_LOCAL_WORLD_SIZE", n))
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"NCCL takes one rank per card: {local_world} ranks on this "
                f"host share {cards} card(s); launch with --backend gloo "
                f"(WUT_DIST_BACKEND=gloo) to run them over gloo")
        torch.cuda.set_device(local_rank() % cards)
    elif backend == "nccl":
        raise RuntimeError("NCCL needs the ranks on cards; --cpu runs them "
                           "over gloo")
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{os.environ['WUT_COORDINATOR']}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=collective_timeout_s()))
    where = "cpu" if on_cpu else f"cuda:{torch.cuda.current_device()}"
    print(f"wut: joined the process group as rank {rank}/{n} ({backend}, "
          f"{where})", flush=True)
    return True


# (data, model) of the grid the ranks form: set by ``mesh.make_mesh`` under
# a process group; rank r sits at (r // model, r % model)
_GRID: Optional[tuple] = None


def set_grid(data: int, model: int) -> None:
    """Record the (data, model) grid of the ranks (``mesh.make_mesh``)."""
    global _GRID
    _GRID = (data, model)


def _grid() -> tuple:
    """The grid of the ranks: the recorded one while it spans the world,
    else every rank its own data row."""
    pc = process_count()
    if _GRID is not None and _GRID[0] * _GRID[1] == pc:
        return _GRID
    return pc, 1


def data_count() -> int:
    """Data rows of the grid: the ranks that load different rows."""
    return _grid()[0]


def model_count() -> int:
    """The grid's model axis: ranks of one data row (tensor parallelism's
    shards, or replicas of one row without it)."""
    return _grid()[1]


def data_index() -> int:
    """This rank's data row: what its loaders, dropout masks and augment
    draws key on, so that the model ranks of one row see the same rows."""
    return process_index() // model_count()


def model_index() -> int:
    """This rank's position along the model axis (its shard)."""
    return process_index() % model_count()


def process_slice(global_batch_size: int) -> slice:
    """This process's row range of a global batch: every rank runs the same
    seeded sampling sequence and loads only its data row's ``global /
    data_count()`` rows (the ranks of one data row load the same rows)."""
    n, i = data_count(), data_index()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"process count {n}" if n == process_count() else
            f"global batch {global_batch_size} not divisible by the "
            f"{n} data rows")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Block until every rank reaches this barrier (a no-op without a
    process group).  It runs on the process group's TCP store, so no device
    collective is issued and a CUDA ``gloo`` or ``nccl`` group needs no
    card-side barrier.  ``name`` keys the rendezvous and must be fresh for
    each one.  The timeout is ``WUT_BARRIER_TIMEOUT_S`` (1800 s) unless
    given; a peer that does not arrive in time raises ``TimeoutError``."""
    d = _dist()
    if d is None:
        return
    if timeout_s is None:
        timeout_s = collective_timeout_s()
    store = d.distributed_c10d._get_default_store()
    key = f"wut:barrier:{name}"
    store.add(key, 1)
    deadline = time.monotonic() + timeout_s
    world = d.get_world_size()
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {name!r}: {store.add(key, 0)} of "
                               f"{world} ranks arrived in {timeout_s:.0f}s")
        time.sleep(0.01)


def lockstep_compile(fn, name: str):
    """The identity.  The JAX package wraps each jitted step so that no rank
    enters the step's first collective while a peer still compiles it;
    eager PyTorch compiles nothing at a first call, so there is nothing to
    hold the ranks to, and call sites read as they do in JAX."""
    return fn


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local(n_processes: int, cmd: Sequence[str], *, cpu: bool = False,
                 backend: Optional[str] = None, env: Optional[dict] = None,
                 timeout: Optional[float] = None,
                 rank_logs: Optional[str] = None) -> int:
    """Spawn ``n_processes`` copies of ``cmd`` on this host under the env
    contract and wait; returns the first nonzero exit code (0 if all end
    with 0).  ``cpu`` puts the ranks on the CPU over gloo; ``backend``
    overrides the backend.

    Every rank is polled, so a rank that dies is seen at once and its peers
    are terminated (by pid) instead of waiting in a collective until its
    timeout.  ``timeout`` (seconds) bounds the whole run: on expiry the
    ranks are terminated and ``subprocess.TimeoutExpired`` is raised.  With
    ``rank_logs`` each rank's stdout and stderr go to
    ``<rank_logs>/rank<i>.log``."""
    port = _free_port()
    procs, logs = [], []
    if rank_logs is not None:
        os.makedirs(rank_logs, exist_ok=True)
    for pid in range(n_processes):
        e = dict(os.environ if env is None else env)
        e["WUT_NUM_PROCESSES"] = str(n_processes)
        e["WUT_PROCESS_ID"] = str(pid)
        e["WUT_LOCAL_RANK"] = str(pid)
        e["WUT_LOCAL_WORLD_SIZE"] = str(n_processes)
        e["WUT_COORDINATOR"] = f"127.0.0.1:{port}"
        if cpu:
            e["WUT_DEVICE"] = "cpu"
        if backend is not None:
            e["WUT_DIST_BACKEND"] = backend
        out = None
        if rank_logs is not None:
            out = open(os.path.join(rank_logs, f"rank{pid}.log"), "wb")
            logs.append(out)
        procs.append(subprocess.Popen(
            list(cmd), env=e, stdout=out,
            stderr=subprocess.STDOUT if out else None))
    rc = 0
    try:
        deadline = None if timeout is None else time.monotonic() + timeout
        live = list(procs)
        while live and rc == 0:
            for p in list(live):
                r = p.poll()
                if r is not None:
                    live.remove(p)
                    rc = rc or r
            if live and rc == 0:
                if deadline is not None and time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(list(cmd), timeout)
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for f in logs:
            f.close()
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m weather_unet_tpu_torch.parallel.launch",
        description="single-node multi-process launcher: one rank a "
                    "process, each on its card (or on the CPU with --cpu)")
    p.add_argument("-n", "--nprocs", type=int, required=True)
    p.add_argument("--cpu", action="store_true",
                   help="every rank on the CPU, over gloo")
    p.add_argument("--backend", type=str, default=None,
                   help="process-group backend (default: nccl on cards, "
                        "gloo with --cpu); gloo lets ranks share a card")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before every rank is terminated")
    p.add_argument("--rank-logs", type=str, default=None,
                   help="directory for per-rank rank<i>.log files "
                        "(default: inherit this terminal's streams)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to launch (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given")
    return launch_local(args.nprocs, cmd, cpu=args.cpu, backend=args.backend,
                        timeout=args.timeout, rank_logs=args.rank_logs)


if __name__ == "__main__":
    sys.exit(main())
