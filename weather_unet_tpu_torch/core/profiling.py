"""Tracing and per-step timing -- the port of
``weather_unet_tpu/core/profiling.py``.

``trace(dir)`` wraps ``torch.profiler`` (host and, where there is a GPU,
CUDA activity) and writes a Chrome trace under ``dir`` (viewable in
Perfetto or ``chrome://tracing``); ``StepTimer`` records wall-clock per
step and reports p50/p90/mean.

The JAX module's persistent-compile-cache and XLA:CPU AOT-loader helpers
(``enable_compilation_cache``, ``install_aot_loader_guard``,
``classify_aot_mismatch_line``, ``aot_guard_stats``) have no counterpart:
PyTorch runs eagerly, so there is no compile cache to enable, and no
XLA:CPU executable whose loader could warn.  Nor have the helpers of the
JAX AOT cache's disk layout (``_host_fingerprint``,
``_prune_stale_cache``): the port's tier (``core/aot.py``) keeps nothing on
disk.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the enclosed steps, written as one Chrome
    trace ``<host>_<pid>_<time>.pt.trace.json`` under ``log_dir`` when the
    block ends, also when it raises (a no-op when ``log_dir`` is None).
    CUDA activity is traced where the build and the host have a GPU.  The
    profiler holds every event of the block in host memory until it ends
    (``PERF.md`` gives the size of a full-width GAN step's), so trace a few
    steps, not a whole run.  Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        # a block that raises still leaves its trace: that is the run
        # someone profiles
        prof.stop()
        name = (f"{socket.gethostname()}_{os.getpid()}_"
                f"{time.strftime('%Y%m%d_%H%M%S')}.pt.trace.json")
        prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Wall-clock step timer with percentile summaries."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if len(self.samples) >= self.capacity:
            self.samples.pop(0)
        self.samples.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "step_time_ms/mean": float(arr.mean() * 1e3),
            "step_time_ms/p50": float(np.percentile(arr, 50) * 1e3),
            "step_time_ms/p90": float(np.percentile(arr, 90) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
