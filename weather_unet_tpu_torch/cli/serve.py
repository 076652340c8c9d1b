"""HTTP inference server for weather transfer -- the port of
``weather_unet_tpu/cli/serve.py``.

Endpoints:
  GET  /healthz    liveness, the torch device and its name, request counters
  GET  /stats      batch-latency percentiles and batching behavior (JSON)
  POST /translate  body = JPEG/PNG bytes; condition from the query string:
                     ?class=sunny           one-hot over ``--classes``
                     ?class=2               one-hot by index
                     ?cond=0.1,-0.3,...     raw soft-signal vector
                   response: image/jpeg, the translated image.
  POST /profile    ?seconds=S: a torch.profiler trace of live traffic as a
                   Chrome trace under ``--profile_dir`` (403 without it).

Requests are micro-batched: a dispatcher thread drains the queue for up to
``--batch_wait_ms`` (or ``--max_batch`` requests) and issues ONE
``translate_u8`` for the group; the API's power-of-two bucketing keeps the
batch sizes reaching the device few.  Decode and resize run on the host
(the native runtime's libjpeg decode where it is built, Pillow otherwise);
the model runs on CUDA unless ``--device cpu``, with K1 + K2 in its decoder
(``load_transfer``'s ``use_pallas="auto"``).  ``--artifact DIR`` serves an
exported program instead (``core/export.py``, written by
``cli/export_serving.py``), through the same ``Batcher`` and handler.
``--data_parallel`` keeps a replica on each local card; ``--tensor_parallel
T`` splits every double conv over T cards (``parallel/tp.py``, the shards
of a replica in threads of one process).

    python -m weather_unet_tpu_torch.cli.serve --cp_path cp.pt --port 8000
    python -m weather_unet_tpu_torch.cli.serve --cp_path cp.pt \\
        --tensor_parallel 2 --port 8000
    python -m weather_unet_tpu_torch.cli.serve --artifact art/ --port 8000
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from weather_unet_tpu_torch.data.datasets import WEATHER_CLASSES_I2W


@dataclass
class _Request:
    image: np.ndarray                      # (H, W, 3) uint8
    cond: np.ndarray                       # (num_classes,) float32
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None    # (H, W, 3) uint8
    error: Optional[str] = None
    cancelled: bool = False                # client gave up (submit timeout)


class Batcher:
    """Queue + two-stage pipeline: groups concurrent requests into one device
    dispatch.

    Dispatch and completion are separate threads so the device computes
    group k+1 while the host reads back / distributes group k: kernel
    launches return before the device finishes, and the completer's
    ``.cpu()`` readback is the wait.  One group in flight beyond the one
    completing (``pipeline_depth=2``); the blocked dispatch thread doubles as
    backpressure that grows the next group under load.  ``close()`` stops
    both threads after the requests already queued are answered.
    """

    def __init__(self, transfer, max_batch: int = 16,
                 batch_wait_ms: float = 5.0, timeout_s: float = 300.0,
                 pipeline_depth: int = 2):
        self.transfer = transfer
        self.max_batch = max_batch
        self.batch_wait_s = batch_wait_ms / 1e3
        self.timeout_s = timeout_s
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        # (group, device_out, error, t0); put() blocking on a full queue is
        # the backpressure
        self._inflight: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(1, pipeline_depth - 1))
        self.lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.batch_sizes: list = []
        self.batch_ms: list = []
        self.readback_ms: list = []
        self._closed = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._dispatcher.start()
        self._completer.start()

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the dispatcher and the completer: a sentinel after the
        queued requests ends the dispatcher, which passes it to the
        completer after its last group; both threads are joined.  Later
        ``submit`` calls raise."""
        with self.lock:
            if self._closed:
                return
            self._closed = True
        self.queue.put(None)
        for t in (self._dispatcher, self._completer):
            t.join(timeout_s)
            if t.is_alive():
                raise RuntimeError(f"Batcher thread {t.name} did not stop "
                                   f"within {timeout_s} s")

    def submit(self, image: np.ndarray, cond: np.ndarray) -> np.ndarray:
        if self._closed:
            raise RuntimeError("Batcher is closed")
        req = _Request(image=image, cond=cond)
        self.queue.put(req)
        if not req.event.wait(self.timeout_s):
            # the dispatcher drops abandoned requests from its group
            req.cancelled = True
            raise TimeoutError("translation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def _dispatch_loop(self):
        stop = False
        while not stop:
            first = self.queue.get()
            if first is None:        # close(): nothing queued before it
                break
            group = [first]
            deadline = time.monotonic() + self.batch_wait_s
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    req = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if req is None:      # close(): dispatch this group, stop
                    stop = True
                    break
                group.append(req)
            group = [r for r in group if not r.cancelled]
            if not group:
                continue
            t0 = time.perf_counter()
            out = err = None
            try:
                x = np.stack([r.image for r in group])
                c = np.stack([r.cond for r in group])
                # returns a device tensor once the launches are queued
                out = self.transfer.translate_u8(x, c)
            except Exception as e:  # surface per-request, keep serving
                err = f"{type(e).__name__}: {e}"
            self._inflight.put((group, out, err, t0))
        self._inflight.put(None)

    def _complete_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            group, out, err, t0 = item
            t1 = time.perf_counter()
            if err is None:
                try:
                    host = out.cpu().numpy()     # waits: compute + D2H
                    for i, r in enumerate(group):
                        r.result = host[i]
                except Exception as e:  # surface per-request, keep serving
                    err = f"{type(e).__name__}: {e}"
            if err is not None:
                for r in group:
                    r.error = err
            now = time.perf_counter()
            # batch_ms = dispatch -> responses ready (includes queueing behind
            # the previous group); readback_ms = this group's own completion
            dt_ms = (now - t0) * 1e3
            rb_ms = (now - t1) * 1e3
            with self.lock:
                self.n_requests += len(group)
                self.n_batches += 1
                self.batch_sizes.append(len(group))
                self.batch_ms.append(dt_ms)
                self.readback_ms.append(rb_ms)
                if len(self.batch_ms) > 1000:
                    self.batch_ms.pop(0)
                    self.batch_sizes.pop(0)
                    self.readback_ms.pop(0)
            for r in group:
                r.event.set()

    def stats(self) -> dict:
        with self.lock:
            ms = np.asarray(self.batch_ms) if self.batch_ms else np.zeros(1)
            rb = (np.asarray(self.readback_ms) if self.readback_ms
                  else np.zeros(1))
            sizes = self.batch_sizes[:]
            return {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
                "batch_ms_p50": float(np.percentile(ms, 50)),
                "batch_ms_p90": float(np.percentile(ms, 90)),
                "readback_ms_p50": float(np.percentile(rb, 50)),
            }


def _parse_condition(qs: dict, classes, num_classes: int) -> np.ndarray:
    """?class=<name|index> -> one-hot; ?cond=f,f,... -> raw vector."""
    if "cond" in qs:
        vec = np.asarray([float(v) for v in qs["cond"][0].split(",")],
                         np.float32)
        if vec.shape != (num_classes,):
            raise ValueError(f"cond needs {num_classes} comma-separated "
                             f"floats, got {vec.shape[0]}")
        return vec
    if "class" in qs:
        raw = qs["class"][0]
        idx = int(raw) if raw.lstrip("-").isdigit() else classes.index(raw)
        if not 0 <= idx < num_classes:
            raise ValueError(
                f"class index {idx} out of range [0, {num_classes})")
        return np.eye(num_classes, dtype=np.float32)[idx]
    raise ValueError(
        "missing condition: pass ?class=<name|index> or ?cond=...")


def _decode_resize(body: bytes, size: int) -> np.ndarray:
    """JPEG/PNG bytes -> (size, size, 3) uint8; normalization runs on the
    device (``translate_u8``), so the wire stays uint8.  JPEGs go through
    the native runtime's libjpeg decode where it is built with one; PNGs,
    other inputs and hosts without libjpeg through Pillow (bilinear)."""
    from weather_unet_tpu_torch import runtime

    arr = runtime.decode_bytes(body, size)
    if arr is None:
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img)
    return arr


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def make_handler(batcher: Batcher, classes, num_classes: int, size: int,
                 quality: int = 95, profile_dir: Optional[str] = None):
    device = batcher.transfer.device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; /stats has the data
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "device": str(device),
                                 "device_name": _device_name(device),
                                 **batcher.stats()})
            elif path == "/stats":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": f"no route {path}"})

        def _profile(self, query: str):
            # an operator opt-in: it writes files and holds a handler
            # thread, and traces land only under the server's directory (a
            # client-given path is never read)
            if profile_dir is None:
                self._json(403, {"error": "profiling disabled; start the "
                                          "server with --profile_dir"})
                return
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                seconds = float(parse_qs(query).get("seconds", ["3"])[0])
                seconds = min(max(seconds, 0.1), 60.0)
                acts = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                with profile(activities=acts) as prof:
                    time.sleep(seconds)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                os.makedirs(profile_dir, exist_ok=True)
                trace = os.path.join(
                    profile_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                                 f"{uuid.uuid4().hex[:8]}.json")
                prof.export_chrome_trace(trace)
                self._json(200, {"trace": trace, "seconds": seconds})
            except Exception as e:  # keep serving; report the failure
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/profile":
                self._profile(url.query)
                return
            if url.path != "/translate":
                self._json(404, {"error": f"no route {url.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= 64 * 1024 * 1024:
                    raise ValueError("bad Content-Length")
                # the body is read before the query is judged: closing with
                # it unread resets the connection, and the client may lose
                # the 400 to the reset
                body = self.rfile.read(length)
                cond = _parse_condition(parse_qs(url.query), classes,
                                        num_classes)
                image = _decode_resize(body, size)
            except Exception as e:  # any malformed request is the client's
                self._json(400, {"error": str(e)})
                return
            try:
                out = batcher.submit(image, cond)
            except Exception as e:  # the batch failed: report, keep serving
                self._json(500, {"error": str(e)})
                return
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(out).save(buf, "JPEG", quality=quality)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen queue that holds a burst:
    with ``socketserver``'s default of 5 pending connections, the ones
    beyond it can be reset when several clients connect while the accept
    loop waits (8 concurrent clients were enough)."""

    request_queue_size = 128

    def server_close(self):
        """Close the socket and stop the ``Batcher`` (``build_server`` sets
        ``batcher``)."""
        super().server_close()
        batcher = getattr(self, "batcher", None)
        if batcher is not None:
            batcher.close()


def warmup_buckets(max_batch: int) -> list:
    """Every power-of-two batch a request group can reach: groups go up to
    ``max_batch`` and the API pads to the next power of two, so the top one
    is ``max_batch`` rounded up (32 for 24)."""
    top = 1 << max(max_batch - 1, 0).bit_length()
    return [1 << i for i in range(top.bit_length())]


def load_transfer_for(args):
    """The transfer ``--cp_path`` (a ``WeatherTransfer``) or ``--artifact``
    (an ``ExportedTransfer``: the serving host imports no model code)
    names.  An artifact's geometry overrides ``--num_classes`` and
    ``--input_size``; flags that the export fixed are refused."""
    import torch

    if bool(args.cp_path) == bool(args.artifact):
        raise SystemExit("pass exactly one of --cp_path or --artifact")
    if args.artifact:
        # dtype and device layout were chosen at export time and live in
        # the program: a flag that would contradict it is refused
        for flag, name in ((args.bf16, "--bf16"),
                           (args.data_parallel, "--data_parallel"),
                           (args.tensor_parallel > 1, "--tensor_parallel"),
                           (args.aot_cache, "--aot_cache")):
            if flag:
                raise SystemExit(f"{name} does not apply to --artifact "
                                 "serving (baked in at export time)")
        from weather_unet_tpu_torch.core.export import ExportedTransfer

        wt = ExportedTransfer(args.artifact, device=args.device)
        args.num_classes, args.input_size = wt.num_classes, wt.input_size
        return wt
    from weather_unet_tpu_torch.api import WeatherTransfer

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    plan = None
    tp = max(args.tensor_parallel, 1)
    if args.data_parallel or tp > 1:
        from weather_unet_tpu_torch.parallel.mesh import make_mesh

        # a replica of the model on each local card, or with
        # --tensor_parallel T one shard on each card of a data row of T;
        # each request group is split over the replicas (rows).  With
        # --device cpu the CPU stands for the T devices of one row.
        plan = make_mesh(devices=None if args.device == "cuda"
                         else [args.device] * tp, model=tp)
    return WeatherTransfer.load(args.cp_path, num_classes=args.num_classes,
                                dtype=dtype, device=args.device,
                                aot_cache=args.aot_cache, plan=plan,
                                tensor_parallel=tp > 1)


def build_server(args) -> Server:
    wt = load_transfer_for(args)
    batcher = Batcher(wt, max_batch=args.max_batch,
                      batch_wait_ms=args.batch_wait_ms)
    if args.warmup:
        # every bucket a group can land in runs once before traffic: the
        # first call at a batch size picks cuDNN's algorithms and grows the
        # allocator's pools, which would stall a whole request group; and
        # the native runtime that decodes uploads compiles at its first use
        from weather_unet_tpu_torch import runtime

        runtime.load()
        z = np.zeros((args.input_size, args.input_size, 3), np.uint8)
        e0 = np.eye(args.num_classes, dtype=np.float32)[0]
        for bs in warmup_buckets(args.max_batch):
            wt.translate_u8(np.tile(z, (bs, 1, 1, 1)),
                            np.tile(e0, (bs, 1))).cpu()
    aot = getattr(wt, "aot", None)
    if aot is not None:
        s = aot.stats
        print(f"aot tier: {s['programs']} bucket programs, "
              f"{s['captures']} CUDA graph captures ({s['capture_s']:.2f}s)",
              flush=True)
    handler = make_handler(batcher, args.classes, args.num_classes,
                           args.input_size, profile_dir=args.profile_dir)
    server = Server((args.host, args.port), handler)
    server.batcher = batcher     # exposed for tests and inspection
    server.transfer = wt
    return server


def build_parser():
    p = argparse.ArgumentParser(
        description="cUNet weather-transfer HTTP server")
    p.add_argument("--cp_path", type=str, default=None,
                   help="checkpoint to serve (msgpack or reference .pt)")
    p.add_argument("--artifact", type=str, default=None,
                   help="serve a frozen export artifact directory "
                        "(export_serving) instead of a checkpoint: no model "
                        "code or weights file on the serving host")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--classes", nargs="*", default=WEATHER_CLASSES_I2W)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--batch_wait_ms", type=float, default=5.0)
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16")
    p.add_argument("--data_parallel", action="store_true",
                   help="a replica of the model on each local GPU; each "
                        "request group is split evenly over them")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="split every double conv of the model over T "
                        "local cards (parallel/tp.py); with "
                        "--data_parallel, a data row of T cards for each "
                        "replica")
    p.add_argument("--no-warmup", dest="warmup", action="store_false")
    p.add_argument("--aot_cache", type=str, default=None,
                   help="AOT tier (core/aot.py): on CUDA each warmed "
                        "bucket runs as a CUDA graph (with "
                        "--tensor_parallel, as the eager split forward); "
                        "nothing is written to the directory")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="enable POST /profile and write torch.profiler "
                        "traces under this directory (client-supplied paths "
                        "are never honored); omit to disable the endpoint")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--gpu", type=str, default=None,
                   help="parity flag; ignored")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = build_server(args)
    print(f"serving on {args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms, "
          f"device={server.transfer.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
