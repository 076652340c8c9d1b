"""Tracing and per-step timing -- the port of
``weather_unet_tpu/core/profiling.py``.

``trace(dir)`` wraps ``torch.profiler`` (host and, where there is a GPU,
CUDA activity) and writes a Chrome trace under ``dir`` (viewable in
Perfetto or ``chrome://tracing``); ``StepTimer`` records wall-clock per
step and reports p50/p90/mean.  ``_host_fingerprint`` keys what the AOT
tier (``core/aot.py``) stores per host on the CPU, and ``_prune_stale_cache``
clears that tier's root of fingerprint directories whose manifest
disagrees with their name.

The JAX module's persistent-compile-cache and XLA:CPU AOT-loader helpers
(``enable_compilation_cache``, ``install_aot_loader_guard``,
``classify_aot_mismatch_line``, ``aot_guard_stats``) have no counterpart:
PyTorch runs eagerly, so there is no compile cache to enable, and no
XLA:CPU executable whose loader could warn.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import re
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_FINGERPRINT_NAME = re.compile(r"[0-9a-f]{12}")


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


def _host_basis() -> Dict[str, str]:
    """What the host fingerprint hashes: the architecture, the first
    core's CPU identity (vendor, family, model, stepping, flags) and the
    torch version, recorded in ``HOST.json`` so a mismatch is
    diagnosable."""
    basis = {"arch": platform.machine(), "format": "v2",
             "torch": torch.__version__}
    wanted = ("vendor_id", "cpu family", "model", "model name", "stepping",
              "flags", "Features", "CPU implementer", "CPU part")
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in wanted and key not in basis:  # first core only
                    basis[key] = line.split(":", 1)[-1].strip()
                if line.strip() == "" and len(basis) > 3:
                    break   # one processor block is enough
    except OSError:
        pass
    return basis


def _host_fingerprint() -> str:
    """Short hash of :func:`_host_basis`."""
    blob = json.dumps(_host_basis(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _prune_stale_cache(root: str, keep: str):
    """Remove from an AOT root the fingerprint directories no fingerprint
    can claim: a directory named by 12 hex digits whose ``HOST.json``
    names another fingerprint than its own name (a collision, or a
    fingerprint function that changed).  Only what the tier writes goes
    (the manifest and ``.pt2`` entries, finished or partial); the directory
    itself only once that leaves it empty.

    The JAX function also clears the JAX package's legacy layouts (flat
    files, manifest-less directories).  The port never wrote those, so here
    anything else in the root -- ``keep``, valid directories of other
    fingerprints, and whatever the user keeps there -- stays.  Never
    fatal."""
    try:
        entries = os.listdir(root)
    except OSError:
        return
    for name in entries:
        full = os.path.join(root, name)
        if name == keep or not _FINGERPRINT_NAME.fullmatch(name):
            continue
        try:
            with open(os.path.join(full, "HOST.json")) as f:
                recorded = json.load(f)
            if recorded.get("fingerprint") == name:
                continue
            for entry in os.listdir(full):
                if entry == "HOST.json" or entry.endswith(".pt2"):
                    os.unlink(os.path.join(full, entry))
            if not os.listdir(full):
                os.rmdir(full)
        except (OSError, ValueError, AttributeError):
            pass
