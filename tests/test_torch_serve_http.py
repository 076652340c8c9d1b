"""The port's HTTP server (``cli/serve.py``) on the CPU against the JAX
package's: ``_parse_condition`` over names, indices, vectors and every
error; ``_decode_resize`` bit-equal on the same route (the native libjpeg
decode, Pillow); the end to end of ``tests/test_serve.py`` against
``--device cpu`` (answers within 1 uint8 step of the direct
``translate_u8`` through the same JPEG encode, 400/404/403, ``/profile``
writing a trace); a burst of connections before the accept loop; the
warmup's buckets; the refused flags."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu import runtime as jax_runtime
from weather_unet_tpu.cli import serve as jax_serve
from weather_unet_tpu_torch import runtime
from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.cli import serve
from weather_unet_tpu_torch.models import ConditionalUNet

SIZE = 32
CLASSES = ["sunny", "cloudy", "rain", "snow", "foggy"]


@pytest.fixture(scope="module")
def cp_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "g.pt")
    model = ConditionalUNet(5, generator=torch.Generator().manual_seed(0))
    torch.save({"inference": model.state_dict(), "epoch": 0,
                "global_step": 0}, path)
    return path


def jpeg_bytes(u8, quality=75) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("group", ["valid", "errors"])
def test_parse_condition_matches_jax(group):
    if group == "valid":
        queries = [{"class": ["sunny"]}, {"class": ["foggy"]},
                   {"class": ["0"]}, {"class": ["4"]},
                   {"cond": ["0.1,-0.2,0.3,0.0,1.0"]},
                   {"cond": ["1e-3,2,3,4,5"], "class": ["rain"]}]
        for qs in queries:
            got = serve._parse_condition(qs, CLASSES, 5)
            want = jax_serve._parse_condition(qs, CLASSES, 5)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        return
    queries = [{}, {"class": ["hail"]}, {"class": ["5"]}, {"class": ["-1"]},
               {"cond": ["1,2"]}, {"cond": ["1,2,3,4,5,6"]},
               {"cond": ["a,b,c,d,e"]}, {"cond": [""]}]
    for qs in queries:
        with pytest.raises(ValueError) as want:
            jax_serve._parse_condition(qs, CLASSES, 5)
        with pytest.raises(ValueError) as got:
            serve._parse_condition(qs, CLASSES, 5)
        assert str(got.value) == str(want.value), qs


@pytest.mark.parametrize("route", ["native", "pillow", "png"])
def test_decode_resize_matches_jax(route, rng, monkeypatch):
    u8 = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    if route == "png":
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, "PNG")
        body = buf.getvalue()
    else:
        body = jpeg_bytes(u8)
    if route == "native":
        assert runtime.decode_available() and jax_runtime.native_available()
    else:                   # both sides take Pillow, as without libjpeg
        monkeypatch.setattr(runtime, "decode_bytes", lambda *a: None)
        monkeypatch.setattr(jax_runtime, "decode_bytes", lambda *a: None)
    got = serve._decode_resize(body, SIZE)
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_serve._decode_resize(body, SIZE))


def serving(args):
    """A started server on a free port; yields (server, base url)."""
    server = serve.build_server(serve.build_parser().parse_args(args))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def post(url, body=b""):
    return urllib.request.urlopen(
        urllib.request.Request(url, data=body, method="POST"), timeout=120)


def test_http_server_end_to_end(cp_path, rng, tmp_path):
    profile_dir = str(tmp_path / "traces")
    server, thread, base = serving([
        "--cp_path", cp_path, "--host", "127.0.0.1", "--port", "0",
        "--input_size", str(SIZE), "--max_batch", "4", "--device", "cpu",
        "--profile_dir", profile_dir])
    try:
        assert server.transfer.model.use_pallas      # K1 + K2 by default
        assert isinstance(server, serve.Server)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert r.status == 200 and health["status"] == "ok"
        assert health["device"] == "cpu" and health["device_name"] == "cpu"

        u8 = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        body = jpeg_bytes(u8)
        x = serve._decode_resize(body, SIZE)[None]
        for query, cond in (("class=sunny", np.eye(5)[0]),
                            ("class=3", np.eye(5)[3]),
                            ("cond=0.1,-0.2,0.3,0.0,1.0",
                             [0.1, -0.2, 0.3, 0.0, 1.0])):
            with post(f"{base}/translate?{query}", body) as r:
                assert r.status == 200
                assert r.headers["Content-Type"] == "image/jpeg"
                got = np.asarray(Image.open(io.BytesIO(r.read())))
            assert got.shape == (SIZE, SIZE, 3)
            direct = server.transfer.translate_u8(
                x, np.asarray([cond], np.float32)).numpy()[0]
            want = np.asarray(Image.open(io.BytesIO(jpeg_bytes(direct, 95))))
            assert np.abs(got.astype(np.int16)
                          - want.astype(np.int16)).max() <= 1, query

        # bad condition -> 400, bad route -> 404 (GET and POST)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(f"{base}/translate?cond=1,2", body)
        assert e.value.code == 400
        # a body larger than the socket buffers: the 400 still arrives (a
        # server that answers before reading it resets about half of these)
        big = jpeg_bytes(rng.integers(0, 256, (1024, 1024, 3), np.uint8), 95)
        assert len(big) > 1 << 20
        for _ in range(10):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(f"{base}/translate?cond=1,2", big)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            post(f"{base}/translate?class=sunny", b"not an image")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            post(f"{base}/nope", body)
        assert e.value.code == 404

        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 3 and stats["batches"] >= 1

        # /profile writes a trace under --profile_dir, never a client path
        with post(f"{base}/profile?seconds=0.2&dir={tmp_path}/evil") as r:
            out = json.loads(r.read())
        assert r.status == 200
        assert os.path.dirname(out["trace"]) == profile_dir
        assert os.path.getsize(out["trace"]) > 0
        assert not os.path.exists(tmp_path / "evil")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    # without --profile_dir the endpoint refuses
    server, thread, base = serving([
        "--cp_path", cp_path, "--host", "127.0.0.1", "--port", "0",
        "--input_size", str(SIZE), "--max_batch", "2", "--device", "cpu",
        "--no-warmup"])
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(f"{base}/profile?seconds=0.2")
        assert e.value.code == 403
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_burst_before_the_accept_loop_is_answered(rng):
    """16 clients connect and send a photo-sized body before the server
    accepts anything: the listen queue holds them all.  With the default
    queue of 5 some were reset (the answer-at-once handler below closes
    while the clients still retransmit what the full queue dropped)."""

    class Answer(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    server = serve.Server(("127.0.0.1", 0), Answer)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    body = jpeg_bytes(rng.integers(0, 256, (160, 160, 3), np.uint8), 95)
    assert len(body) > 20000
    results = {}

    def client(i):
        try:
            with post(f"{base}/translate", body) as r:
                results[i] = (r.status, r.read())
        except Exception as e:
            results[i] = repr(e)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for c in clients:
        c.start()
    time.sleep(2.0)                  # every client is connected and waiting
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for c in clients:
            c.join(timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert results == {i: (200, b"ok") for i in range(16)}


def test_close_stops_the_batcher_threads(cp_path, rng):
    """``Batcher.close()`` answers what was queued, then joins both of its
    threads; ``Server.server_close()`` closes the server's Batcher."""
    wt = WeatherTransfer.load(cp_path, device="cpu")
    batcher = serve.Batcher(wt, max_batch=4, batch_wait_ms=300.0)
    img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    cond = np.eye(5, dtype=np.float32)[1]
    results = []
    client = threading.Thread(
        target=lambda: results.append(batcher.submit(img, cond)))
    client.start()
    time.sleep(0.05)       # the request waits in the dispatcher's window
    batcher.close()
    client.join(timeout=60)
    assert not client.is_alive() and len(results) == 1
    assert results[0].shape == (SIZE, SIZE, 3)
    assert not batcher._dispatcher.is_alive()
    assert not batcher._completer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(img, cond)
    batcher.close()                       # a second close does nothing

    server = serve.build_server(serve.build_parser().parse_args([
        "--cp_path", cp_path, "--host", "127.0.0.1", "--port", "0",
        "--input_size", str(SIZE), "--device", "cpu", "--no-warmup"]))
    threads = (server.batcher._dispatcher, server.batcher._completer)
    assert all(t.is_alive() for t in threads)
    server.server_close()
    assert not any(t.is_alive() for t in threads)


def test_warmup_covers_the_rounded_up_bucket(cp_path, monkeypatch):
    assert serve.warmup_buckets(1) == [1]
    assert serve.warmup_buckets(16) == [1, 2, 4, 8, 16]
    assert serve.warmup_buckets(24) == [1, 2, 4, 8, 16, 32]
    seen = []
    translate_u8 = WeatherTransfer.translate_u8

    def record(self, images, conditions, **kw):
        out = translate_u8(self, images, conditions, **kw)
        seen.append((len(images), out.shape[0]))
        return out

    monkeypatch.setattr(WeatherTransfer, "translate_u8", record)
    load = runtime.load
    monkeypatch.setattr(runtime, "load",
                        lambda: seen.append("runtime") or load())
    server = serve.build_server(serve.build_parser().parse_args([
        "--cp_path", cp_path, "--host", "127.0.0.1", "--port", "0",
        "--input_size", str(SIZE), "--max_batch", "3", "--device", "cpu"]))
    server.server_close()
    # the decode runtime is built before traffic too
    assert seen == ["runtime", (1, 1), (2, 2), (4, 4)]


REFUSED = {"artifact": (["--artifact", "art"],
                        "exactly one of --cp_path or --artifact"),
           "data_parallel": (["--data_parallel"], "Mesh, AOT"),
           "tensor_parallel": (["--tensor_parallel", "2"], "Mesh, AOT"),
           "aot_cache": (["--aot_cache", "aot"], "Mesh, AOT"),
           "no_cp_path": (None, "--cp_path"),
           "no_gpu": ([], "CUDA")}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_flags_name_their_roadmap_item(cp_path, case, monkeypatch):
    flags, match = REFUSED[case]
    args = [] if flags is None else ["--cp_path", cp_path] + flags
    if case == "no_gpu":          # neither a GPU nor --device cpu
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((SystemExit, RuntimeError), match=match):
        serve.build_server(serve.build_parser().parse_args(
            args + ["--no-warmup"]))
