"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` is compiled on its own by ``nvcc`` into a shared library
with a plain C interface (``csrc/wut_kernels.h``; ``csrc/wut_mma.cuh`` holds
the tensor-core and asynchronous-copy device code that K3 and K4 share), all
sources at once, at first use.  Libraries go to ``weather_unet_tpu_torch/_build/`` (listed in
``.gitignore``), named by a digest of the sources and flags, so a later
process with the same sources loads them without compiling.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

# kernel modules count their launches under it: the shards of an in-process
# tensor-parallel model launch from threads of their own
COUNT_LOCK = threading.Lock()

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# torch dtype -> csrc/wut_kernels.h WutDtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA toolkit is needed to build the kernels")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted([*CSRC.glob("*.h"), *CSRC.glob("*.cuh")]) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source not yet built (one ``nvcc`` per source, all
    started together), load all libraries, and return them by source stem."""
    with _lock:
        if not _libs:
            targets = {src.stem: (src, _target(src))
                       for src in sorted(CSRC.glob("*.cu"))}
            _compile([t for t in targets.values() if not t[1].exists()])
            for name, (_, so) in targets.items():
                _libs[name] = ctypes.CDLL(str(so))
        return _libs


def _compile(jobs) -> None:
    if not jobs:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, so in jobs:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, so)   # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]


def is_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: a CUDA tensor goes to the kernel,
    a CPU tensor to the plain version, anything else is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (expected cuda or cpu)")


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        lib.wut_error_string.restype = ctypes.c_char_p
        lib.wut_error_string.argtypes = [ctypes.c_int]
        msg = lib.wut_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
