"""Environment diagnostics -- the port of ``weather_unet_tpu/cli/doctor.py``:
one command answering "is this host set up to train and serve on the GPU,
and what will the kernels use?".

    python -m weather_unet_tpu_torch.cli.doctor [--probe] [--json]
    python -m weather_unet_tpu_torch.cli.doctor --goldens [--json]

Reports Python, torch and CUDA versions; the GPUs (name, compute
capability, memory); whether ``nvcc`` is found; the kernel build directory
(``kernels/_build.py``) and which kernel libraries are built; the native
runtime's build mode; the ``WUT_*`` environment; the process count and
index and the default mesh (``parallel/``), and with ``--tensor_parallel
T`` the mesh of a model axis of T and what T-way tensor parallelism splits
(``parallel/tp.py::describe``).  The JAX doctor's AOT
cache report has no counterpart: the port's AOT tier (``core/aot.py``)
keeps nothing on disk.  ``--probe`` also times a small tensor's first call
and round trip on the card.  Without a GPU it says so and exits non-zero:
the port's entry points run on the GPU, and the CPU is never reported as
the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _init_backend(timeout_s: float) -> dict:
    """Initialize CUDA under a watchdog: a CUDA init that hangs is the kind
    of failure this tool is run to explain.  Init runs on a daemon thread;
    on timeout the host-side report still prints and the tool exits
    non-zero instead of hanging."""
    import threading

    out: dict = {}

    def target():
        try:
            import torch

            if not torch.cuda.is_available():
                out["error"] = ("no CUDA device is available (torch "
                                f"{torch.__version__}, built for CUDA "
                                f"{torch.version.cuda})")
                return
            devices = []
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                devices.append({
                    "index": i, "name": props.name,
                    "capability": f"{props.major}.{props.minor}",
                    "memory_gib": round(props.total_memory / 2 ** 30, 2),
                    "sms": props.multi_processor_count})
            out["devices"] = devices
        except Exception as e:     # the report says what failed
            out["error"] = repr(e)

    t = threading.Thread(target=target, daemon=True, name="wut-doctor-init")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        out["timeout"] = timeout_s
    return out


def collect(probe: bool = False, init_timeout: float = 60.0,
            tensor_parallel: int = 1) -> dict:
    import torch

    info: dict = {"python": sys.version.split()[0], "torch": torch.__version__,
                  "cuda": torch.version.cuda}
    backend = _init_backend(init_timeout)
    _collect_host_side(info)
    if "devices" not in backend:
        info["backend_ok"] = False
        info["backend_error"] = (
            f"CUDA init timed out after {init_timeout:.0f}s"
            if backend.get("timeout") else backend.get("error"))
        return info
    info["backend_ok"] = True
    info["platform"] = "gpu"
    info["devices"] = backend["devices"]
    info["device_count"] = len(backend["devices"])
    from weather_unet_tpu_torch.parallel.launch import (
        process_count, process_index)
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    info["process_count"] = process_count()
    info["process_index"] = process_index()
    # the plan the trainers would train under
    info["default_mesh"] = make_mesh().mesh_shape
    if tensor_parallel > 1:
        from weather_unet_tpu_torch.parallel.tp import describe

        try:
            info["tensor_parallel_mesh"] = make_mesh(
                model=tensor_parallel).mesh_shape
        except ValueError as e:
            info["tensor_parallel_mesh"] = f"refused: {e}"
        # the split pairs and one shard's weights (parallel/tp.py)
        info["tensor_parallel"] = describe(tensor_parallel)
    if probe:
        x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda")
        t0 = time.perf_counter()
        float((x @ x).sum())           # first launch + host read-back
        info["probe_first_call_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        for _ in range(5):
            float((x @ x).sum())       # launch + host read-back
        info["probe_roundtrip_ms"] = round(
            (time.perf_counter() - t0) / 5 * 1e3, 3)
    return info


def _collect_host_side(info: dict) -> None:
    """Facts that need no GPU: the compiler, the kernel libraries, the
    native runtime, the environment -- still reported when there is no
    card."""
    from weather_unet_tpu_torch import runtime
    from weather_unet_tpu_torch.kernels import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    info["nvcc"] = {"found": nvcc is not None, "path": nvcc}
    info["kernels"] = {
        "build_dir": str(_build.BUILD_DIR),
        "built": {src.stem: _build._target(src).exists()
                  for src in sorted(_build.CSRC.glob("*.cu"))}}
    decode = runtime.decode_available()
    info["native_runtime"] = {
        "mode": ("jpeg" if decode else "augment-only"
                 if runtime.augment_available() else "not built"),
        "decode_available": decode,
        "build_error": runtime.build_error()}
    info["wut_env"] = {k: v for k, v in os.environ.items()
                       if k.startswith("WUT_")}


def report_goldens(as_json: bool = False) -> int:
    """The goldens that wait for real weights (``evaluation/goldens.py``):
    where to put each file, its expected sha256, which tests it activates.
    Exit 0 when every golden is present and certified, 1 otherwise."""
    from weather_unet_tpu_torch.evaluation.goldens import golden_status

    status = golden_status()
    if as_json:
        print(json.dumps(status, indent=2))
    else:
        for s in status:
            state = ("CERTIFIED" if s["certified"]
                     else "present, sha MISMATCH" if s["present"]
                     else "MISSING")
            print(f"[{state}] {s['name']}")
            print(f"    file:      {s['path']}  (override: ${s['env_var']})")
            print(f"    sha256:    expect prefix {s['expected_sha256_prefix']}"
                  + (f", got {s['sha256']}" if s["sha256"] else ""))
            print(f"    source:    {s['source_url']}")
            print(f"    activates: {s['activates']}")
            print(f"    {s['note']}")
    return 0 if all(s["certified"] for s in status) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="weather_unet_tpu_torch environment diagnostics")
    p.add_argument("--probe", action="store_true",
                   help="time a small tensor's first call and round trip "
                        "on the card")
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.add_argument("--goldens", action="store_true",
                   help="report the goldens that wait for real Inception "
                        "weights (status, expected sha256, where the files "
                        "go, which tests they activate); exits non-zero "
                        "until all are certified")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="also report the mesh of a model axis of T and, for "
                        "the cUNet and the SNDisc, the double convs T-way "
                        "tensor parallelism splits and one shard's weight "
                        "bytes")
    p.add_argument("--init_timeout", type=float, default=60.0,
                   help="seconds to wait for CUDA init before reporting "
                        "the device unreachable")
    args = p.parse_args(argv)
    if args.goldens:
        return report_goldens(as_json=args.json)
    info = collect(probe=args.probe, init_timeout=args.init_timeout,
                   tensor_parallel=args.tensor_parallel)
    if args.json:
        print(json.dumps(info, indent=2, default=str))
    else:
        for k, v in info.items():
            print(f"{k:24s} {v}")
    if not info["backend_ok"]:
        print(f"doctor: no usable GPU: {info['backend_error']}",
              file=sys.stderr)
    return 0 if info["backend_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
