"""Native data-loader runtime (C++) with a ctypes binding -- the port's copy
of ``weather_unet_tpu/runtime``.

``augment.cc`` is the host twin of the device augment
(``data/transforms.py::augment_batch``): one composed inverse-affine
resample and the color jitter of a decoded uint8 image, in one call that
releases the GIL.  ``jpeg_loader.cc`` decodes JPEGs with libjpeg (with a
DCT-domain downscale) and resizes them, one file, bytes or a batch on C++
threads.

The library is compiled at first use, not on import: ``c++ -O3 -fPIC
-std=c++17 -shared ... -lpthread`` into ``weather_unet_tpu_torch/_build/``,
named by a digest of the sources, flags and compiler, so a later process
loads it without compiling.  libjpeg is linked only where a probe program
including ``jpeglib.h`` compiles and links with ``-ljpeg``; elsewhere (a
host without libjpeg) the build is augment-only: ``augment.cc`` alone,
without the decode entries, and ``decode_available()`` is False.  A failed
build raises with the compiler's output from ``build``; ``load`` returns
None and keeps the reason (``build_error``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_JPEG_PROBE = """#include <cstdio>
#include <jpeglib.h>
int main() {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
"""

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class Runtime:
    """One loaded build of the runtime library.  ``mode`` is ``"libjpeg"``
    or ``"augment-only"``; ``build_seconds`` is the compile time this
    process paid (0 when it loaded an earlier build)."""

    def __init__(self, path: Path, with_jpeg: bool, build_seconds: float):
        self.path = path
        self.with_jpeg = with_jpeg
        self.mode = "libjpeg" if with_jpeg else "augment-only"
        self.build_seconds = build_seconds
        lib = ctypes.CDLL(str(path))
        lib.wut_make_affine.argtypes = [
            ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, _f32p]
        lib.wut_make_affine.restype = None
        lib.wut_augment_u8.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, ctypes.c_int,
            _u8p]
        lib.wut_augment_u8.restype = ctypes.c_int
        if with_jpeg:
            lib.wut_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            _u8p]
            lib.wut_decode_file.restype = ctypes.c_int
            lib.wut_decode_bytes.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _u8p]
            lib.wut_decode_bytes.restype = ctypes.c_int
            lib.wut_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                _u8p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.wut_decode_batch.restype = ctypes.c_int
            lib.wut_decode_augment_file.argtypes = [
                ctypes.c_char_p, _f32p, _f32p, ctypes.c_float, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, _u8p]
            lib.wut_decode_augment_file.restype = ctypes.c_int
        self.lib = lib

    def decode_available(self) -> bool:
        return self.with_jpeg

    def _need_decode(self, what: str) -> None:
        if not self.with_jpeg:
            raise RuntimeError(f"{what}: this runtime build has no JPEG "
                               f"decode (built without libjpeg)")

    def decode_file(self, path: str, out_size: int) -> Optional[np.ndarray]:
        """Decode one JPEG to (out_size, out_size, 3) uint8; None on a
        decode failure."""
        self._need_decode("decode_file")
        out = np.empty((out_size, out_size, 3), dtype=np.uint8)
        rc = self.lib.wut_decode_file(path.encode(), out_size,
                                      _ptr(out, _u8p))
        return out if rc == 0 else None

    def decode_bytes(self, data: bytes, out_size: int) -> Optional[np.ndarray]:
        """Decode an in-memory JPEG (an HTTP upload) to (out_size, out_size,
        3) uint8; None on a decode failure."""
        self._need_decode("decode_bytes")
        out = np.empty((out_size, out_size, 3), dtype=np.uint8)
        rc = self.lib.wut_decode_bytes(data, len(data), out_size,
                                       _ptr(out, _u8p))
        return out if rc == 0 else None

    def decode_batch(self, paths: Sequence[str], out_size: int,
                     n_threads: int = 0) -> Tuple[np.ndarray, List[bool]]:
        """Decode a batch on C++ threads: ``(batch_u8 (N, S, S, 3),
        ok_flags)``; failed slots are zero-filled with ``ok=False``."""
        self._need_decode("decode_batch")
        n = len(paths)
        out = np.empty((n, out_size, out_size, 3), dtype=np.uint8)
        ok = np.empty(n, dtype=np.int32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        self.lib.wut_decode_batch(
            arr, n, out_size, _ptr(out, _u8p),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
        return out, [bool(r == 0) for r in ok]

    def make_affine(self, h: int, w: int, uniforms: np.ndarray, *,
                    degrees: float, resized_crop: bool, crop_scale,
                    crop_ratio, hflip: bool, out_size: int) -> np.ndarray:
        """The (2, 3) float32 inverse affine from six uniforms (the float32
        twin of ``data.transforms.affine_from_uniforms``)."""
        u = np.ascontiguousarray(uniforms, dtype=np.float32)
        if u.shape != (6,):
            raise ValueError(f"expected 6 uniforms, got shape {u.shape}")
        mat = np.empty(6, dtype=np.float32)
        self.lib.wut_make_affine(
            h, w, _ptr(u, _f32p), float(degrees), int(resized_crop),
            float(crop_scale[0]), float(crop_scale[1]), float(crop_ratio[0]),
            float(crop_ratio[1]), int(hflip), out_size, _ptr(mat, _f32p))
        return mat.reshape(2, 3)

    def augment_u8(self, image_u8: np.ndarray, mat: np.ndarray,
                   jitter: np.ndarray, out_size: int) -> np.ndarray:
        """Affine resample + color jitter of a decoded uint8 HWC RGB image;
        a jitter factor below 0 disables that jitter."""
        src = np.ascontiguousarray(image_u8, dtype=np.uint8)
        if src.ndim != 3 or src.shape[2] != 3:
            raise ValueError(f"expected HWC RGB, got shape {src.shape}")
        h, w, _ = src.shape
        m = np.ascontiguousarray(mat, dtype=np.float32).reshape(6)
        j = np.ascontiguousarray(jitter, dtype=np.float32)
        if j.shape != (3,):
            raise ValueError(f"expected 3 jitter factors, got {j.shape}")
        out = np.empty((out_size, out_size, 3), dtype=np.uint8)
        rc = self.lib.wut_augment_u8(_ptr(src, _u8p), h, w, _ptr(m, _f32p),
                                     _ptr(j, _f32p), out_size,
                                     _ptr(out, _u8p))
        if rc != 0:
            raise RuntimeError(f"wut_augment_u8 failed rc={rc}")
        return out

    def decode_augment_file(self, path: str, uniforms: np.ndarray,
                            jitter: np.ndarray, *, degrees: float,
                            resized_crop: bool, crop_scale, crop_ratio,
                            hflip: bool,
                            out_size: int) -> Optional[np.ndarray]:
        """Fused JPEG decode -> affine augment -> jitter in one call; None
        on a decode failure (the caller's skip-on-corrupt policy)."""
        self._need_decode("decode_augment_file")
        u = np.ascontiguousarray(uniforms, dtype=np.float32)
        j = np.ascontiguousarray(jitter, dtype=np.float32)
        if u.shape != (6,) or j.shape != (3,):
            raise ValueError(f"expected 6 uniforms and 3 jitter factors, got "
                             f"{u.shape} and {j.shape}")
        out = np.empty((out_size, out_size, 3), dtype=np.uint8)
        rc = self.lib.wut_decode_augment_file(
            path.encode(), _ptr(u, _f32p), _ptr(j, _f32p), float(degrees),
            int(resized_crop), float(crop_scale[0]), float(crop_scale[1]),
            float(crop_ratio[0]), float(crop_ratio[1]), int(hflip),
            out_size, _ptr(out, _u8p))
        return out if rc == 0 else None


_lock = threading.Lock()
_builds: Dict[bool, Runtime] = {}
_jpeg_found: Optional[bool] = None
_compiler: Optional[str] = None
_default: Optional[Runtime] = None
_default_error: Optional[str] = None


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or $CXX) on PATH; the "
                           "native runtime cannot be built")
    return cxx


def _compiler_id() -> str:
    """The resolved compiler path and its ``--version`` output, part of the
    library's digest: a ``_build/`` copied from a host with another
    compiler is rebuilt here, not loaded (probed once a process)."""
    global _compiler
    if _compiler is None:
        cxx = os.path.realpath(_cxx())
        _compiler = cxx + "\n" + _run([cxx, "--version"]).stdout
    return _compiler


def _run(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def jpeg_found() -> bool:
    """Whether a program including ``jpeglib.h`` compiles and links with
    ``-ljpeg`` here (probed once a process)."""
    global _jpeg_found
    if _jpeg_found is None:
        BUILD_DIR.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            src = os.path.join(tmp, "probe.cc")
            with open(src, "w") as f:
                f.write(_JPEG_PROBE)
            res = _run([_cxx(), "-std=c++17", src, "-o",
                        os.path.join(tmp, "probe"), "-ljpeg"])
        _jpeg_found = res.returncode == 0
    return _jpeg_found


def _sources(with_jpeg: bool) -> List[Path]:
    names = ["jpeg_loader.cc", "augment.cc"] if with_jpeg else ["augment.cc"]
    return [SRC_DIR / n for n in names]


def _command(with_jpeg: bool, out: Path) -> List[str]:
    defs = ["-DWUT_HAVE_LIBJPEG"] if with_jpeg else []
    libs = ["-ljpeg", "-lpthread"] if with_jpeg else ["-lpthread"]
    return [_cxx(), *CXX_FLAGS, *defs, "-I", str(SRC_DIR),
            *map(str, _sources(with_jpeg)), "-o", str(out), *libs]


def _target(with_jpeg: bool) -> Path:
    h = hashlib.sha256(" ".join(
        (*CXX_FLAGS, str(with_jpeg), _compiler_id())).encode())
    for dep in [SRC_DIR / "runtime_internal.h", *_sources(with_jpeg)]:
        h.update(dep.read_bytes())
    mode = "jpeg" if with_jpeg else "nojpeg"
    return BUILD_DIR / f"libwut_runtime-{mode}-{h.hexdigest()[:16]}.so"


def build(with_jpeg: Optional[bool] = None) -> Runtime:
    """Compile (unless this digest is built already) and load the runtime.
    ``with_jpeg=None`` links libjpeg where ``jpeg_found()``; False forces
    the augment-only build; True requires libjpeg.  Raises RuntimeError with
    the compiler's output when the build fails."""
    if with_jpeg is None:
        with_jpeg = jpeg_found()
    with _lock:
        if with_jpeg in _builds:
            return _builds[with_jpeg]
        so = _target(with_jpeg)
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = _run(_command(with_jpeg, tmp))
            seconds = time.perf_counter() - t0
            if res.returncode:
                raise RuntimeError(
                    f"native runtime build failed ({' '.join(res.args)}):\n"
                    f"{res.stdout}")
            os.replace(tmp, so)   # atomic: no process loads a partial file
        rt = _builds[with_jpeg] = Runtime(so, with_jpeg, seconds)
        return rt


def load() -> Optional[Runtime]:
    """The default build (libjpeg where found), built at first use; None
    when this host cannot build it (the reason is ``build_error()``)."""
    global _default, _default_error
    if _default is None and _default_error is None:
        try:
            _default = build()
        except RuntimeError as e:
            _default_error = str(e)
    return _default


def build_error() -> Optional[str]:
    """Why ``load()`` returned None (the compiler's output), else None."""
    load()
    return _default_error


def augment_available() -> bool:
    """True when the runtime is built: every build exports the augment
    entries."""
    return load() is not None


#: the JAX package's name for the same fact
native_available = augment_available


def decode_available() -> bool:
    """True when the runtime is built with libjpeg (the decode entries)."""
    rt = load()
    return rt is not None and rt.with_jpeg


def _runtime(what: str) -> Runtime:
    rt = load()
    if rt is None:
        raise RuntimeError(f"{what}: the native runtime is not available:\n"
                           f"{_default_error}")
    return rt


def decode_file(path: str, out_size: int) -> Optional[np.ndarray]:
    """Decode one JPEG to (out_size, out_size, 3) uint8; None on failure or
    where the runtime has no decode."""
    if not decode_available():
        return None
    return _default.decode_file(path, out_size)


def decode_bytes(data: bytes, out_size: int) -> Optional[np.ndarray]:
    """Decode an in-memory JPEG to (out_size, out_size, 3) uint8; None on
    failure or where the runtime has no decode."""
    if not decode_available():
        return None
    return _default.decode_bytes(data, out_size)


def decode_batch(paths: Sequence[str], out_size: int,
                 n_threads: int = 0) -> Tuple[np.ndarray, List[bool]]:
    """Decode a batch in parallel C++ threads (see ``Runtime.decode_batch``);
    raises where the runtime has no decode."""
    return _runtime("decode_batch").decode_batch(paths, out_size, n_threads)


def make_affine(h: int, w: int, uniforms: np.ndarray, **cfg) -> np.ndarray:
    """See ``Runtime.make_affine``."""
    return _runtime("make_affine").make_affine(h, w, uniforms, **cfg)


def augment_u8(image_u8: np.ndarray, mat: np.ndarray, jitter: np.ndarray,
               out_size: int) -> np.ndarray:
    """See ``Runtime.augment_u8``."""
    return _runtime("augment_u8").augment_u8(image_u8, mat, jitter, out_size)


def decode_augment_file(path: str, uniforms: np.ndarray, jitter: np.ndarray,
                        **cfg) -> Optional[np.ndarray]:
    """See ``Runtime.decode_augment_file``; raises where the runtime has no
    decode."""
    return _runtime("decode_augment_file").decode_augment_file(
        path, uniforms, jitter, **cfg)
