"""The port's serving artifact (``core/export.py``), ``export_serving`` and
``serve --artifact`` on the CPU, against the JAX package's artifact
(``weather_unet_tpu/core/export.py``, run as ``tests/test_export.py`` runs
it) for the same weights: a cUNet of 3 classes at 32x32 with
``use_pallas=True``, so the exported programs hold K1 and K2 as the
registered ops ``wut::adain`` / ``wut::upsample2x`` and run their CPU
implementations.

Bars: ``translate`` within a pixel MAE of 1e-5 of the JAX artifact (the
f32 port-vs-JAX bar of ``tests/test_model_parity.py``), ``translate_u8``
within 1 uint8 step; the port's artifact against its own live model (the
same operations) bit for bit; answers over HTTP within 1 step of the direct
``translate_u8`` through the same JPEG encode."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.core import export as jax_export
from weather_unet_tpu.models import ConditionalUNet as JaxConditionalUNet
from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.cli import export_serving, serve
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.core import export
from weather_unet_tpu_torch.models import ConditionalUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, NCLS = 32, 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX variables, the port model with the same weights, its reference
    ``.pt`` bundle and a symbolic-batch artifact of it."""
    root = tmp_path_factory.mktemp("export")
    jm = JaxConditionalUNet(num_classes=NCLS, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    variables = jm.init(jax.random.key(0), jnp.asarray(rng.standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)), jnp.eye(NCLS)[:1])
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          torch_io.cunet_state_dict_from_jax(variables).items()}
    model = ConditionalUNet(NCLS, use_pallas=True)
    model.load_state_dict(sd, strict=True)
    model.eval()
    cp = str(root / "g.pt")
    torch.save({"inference": sd, "epoch": 0, "global_step": 0}, cp)
    art = str(root / "art")
    export.save_artifact(art, export.export_transfer(model, size=SIZE))
    return {"jm": jm, "variables": variables, "model": model, "cp": cp,
            "art": art, "root": root}


def batch(rng, b):
    return (rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32),
            np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, b)],
            rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8))


def test_artifact_matches_the_jax_artifact(world, rng, tmp_path):
    jart = str(tmp_path / "jax_art")
    jax_export.save_artifact(jart, jax_export.export_transfer(
        world["jm"], world["variables"], size=SIZE))
    theirs = jax_export.load_artifact(jart)
    ours = export.load_artifact(world["art"], device="cpu")
    for name, program in ours.items():     # K1 and K2 at the 3 decoder sites
        ops = [str(n.target) for n in program.graph.nodes
               if str(n.target).startswith("wut.")]
        assert sorted(ops) == ["wut.adain.default"] * 3 + [
            "wut.upsample2x.default"] * 3, name
    for b in (1, 3, 4):                    # one artifact, any batch size
        x, c, u8 = batch(rng, b)
        with torch.inference_mode():
            got = ours["translate"](torch.from_numpy(x), torch.from_numpy(c))
            got_u8 = ours["translate_u8"](torch.from_numpy(u8),
                                          torch.from_numpy(c))
        want = np.asarray(theirs["translate"](jnp.asarray(x), jnp.asarray(c)))
        assert got.shape == (b, SIZE, SIZE, 3)
        assert float(np.abs(got.numpy() - want).mean()) < 1e-5, b
        want_u8 = np.asarray(theirs["translate_u8"](jnp.asarray(u8),
                                                    jnp.asarray(c)))
        assert got_u8.dtype == torch.uint8
        assert np.abs(got_u8.numpy().astype(np.int16)
                      - want_u8.astype(np.int16)).max() <= 1, b


def test_manifest_and_refusals(world, tmp_path):
    man = export.load_manifest(world["art"])
    assert man["format"] == export.FORMAT and man["device"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["package_version"]
    assert set(man["modules"]) == {"translate", "translate_u8"}
    for name, dt in (("translate", "float32"), ("translate_u8", "uint8")):
        meta = man["modules"][name]
        assert (meta["batch"], meta["input_size"], meta["num_classes"],
                meta["dtype"]) == ("symbolic", SIZE, NCLS, dt)
        assert meta["in_shapes"] == [["symbolic", SIZE, SIZE, 3],
                                     ["symbolic", NCLS]]
        assert meta["out_dtypes"] == [dt]
        assert meta["bytes"] == os.path.getsize(
            os.path.join(world["art"], name + ".pt2"))

    pinned = str(tmp_path / "pinned")
    export.save_artifact(pinned, export.export_transfer(
        world["model"], size=SIZE, batch=4))
    assert export.load_manifest(pinned)["modules"]["translate"]["batch"] == 4
    with pytest.raises(ValueError, match="pinned batch"):
        export.ExportedTransfer(pinned, device="cpu")
    with pytest.raises(ValueError, match="reserved"):
        export.save_artifact(str(tmp_path / "x"), {},
                             extra={"modules": {}, "note": "boom"})

    def edited(name, change):
        d = tmp_path / name
        d.mkdir()
        m = json.loads(json.dumps(man))
        change(m)
        (d / "manifest.json").write_text(json.dumps(m))
        for f in ("translate.pt2", "translate_u8.pt2"):
            os.symlink(os.path.join(world["art"], f), d / f)
        return str(d)

    with pytest.raises(ValueError, match="not a weather_unet_tpu_torch"):
        export.load_artifact(edited("fmt", lambda m: m.update(
            format="weather_unet_tpu.export/1")), device="cpu")
    # the device check comes first: an artifact of the card refuses the CPU
    on_card = edited("card", lambda m: m.update(device="cuda"))
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        export.load_artifact(on_card, device="cpu")
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        export.ExportedTransfer(on_card, device="cpu")
    with pytest.raises(ValueError, match="no module 'nope'"):
        export.load_artifact(world["art"], names=["nope"], device="cpu")
    no_geometry = edited("geo", lambda m: m["modules"]["translate"].pop(
        "input_size"))
    with pytest.raises(ValueError, match="no input_size/num_classes"):
        export.ExportedTransfer(no_geometry, device="cpu")


def test_exported_transfer_serves_like_weather_transfer(world, rng):
    et = export.ExportedTransfer(world["art"], device="cpu")
    wt = WeatherTransfer(world["model"], device="cpu")
    assert (et.input_size, et.num_classes, et.dtype) == (SIZE, NCLS,
                                                         torch.float32)
    for b in (1, 3, 4):                     # buckets 1, 4, 4
        x, c, u8 = batch(rng, b)
        assert torch.equal(et.translate(x, c), wt.translate(x, c))
        assert torch.equal(et.translate_u8(u8, c), wt.translate_u8(u8, c))
        assert torch.equal(et.translate(x, c, bucket=False),
                           wt.translate(x, c, bucket=False))
    # a serving host loads and runs the artifact without the model code
    code = (
        "import sys, numpy as np\n"
        "from weather_unet_tpu_torch.core.export import ExportedTransfer\n"
        f"et = ExportedTransfer({world['art']!r}, device='cpu')\n"
        f"y = et.translate_u8(np.zeros((3, {SIZE}, {SIZE}, 3), np.uint8), "
        f"np.eye({NCLS}, dtype=np.float32))\n"
        "assert tuple(y.shape) == (3, 32, 32, 3)\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "('weather_unet_tpu_torch.models', 'jax', 'weather_unet_tpu.'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_export_serving_cli_check(world, tmp_path, capsys):
    for dtype, extra in (("f32", []), ("bf16", ["--batch", "3"])):
        out = str(tmp_path / dtype)
        export_serving.main(["--cp_path", world["cp"], "--out", out,
                             "--input_size", str(SIZE), "--num_classes",
                             str(NCLS), "--dtype", dtype, "--device", "cpu",
                             "--check"] + extra)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["checked"] and res["artifact"] == out
        assert res["modules"] == ["translate", "translate_u8"]
        man = export.load_manifest(out)
        assert man["checkpoint"] == world["cp"] and man["dtype"] == dtype
        meta = man["modules"]["translate"]
        assert meta["batch"] == (3 if extra else "symbolic")
        assert meta["dtype"] == ("bfloat16" if dtype == "bf16" else "float32")
    # the bf16 artifact's answers: within 1e-3 MAE of the f32 ones
    x, c, _ = batch(np.random.default_rng(5), 3)
    with torch.inference_mode():
        f32 = export.load_artifact(str(tmp_path / "f32"), device="cpu")[
            "translate"](torch.from_numpy(x), torch.from_numpy(c))
        bf16 = export.load_artifact(str(tmp_path / "bf16"), device="cpu")[
            "translate"](torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(c).bfloat16())
    assert float((bf16.float() - f32).abs().mean()) <= 1e-3


def jpeg_bytes(u8, quality=75) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_serve_artifact_over_http(world, rng):
    args = serve.build_parser().parse_args([
        "--artifact", world["art"], "--host", "127.0.0.1", "--port", "0",
        "--input_size", "64", "--num_classes", "5", "--max_batch", "4",
        "--device", "cpu"])
    server = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # the manifest's geometry wins over the flags' defaults
        assert (args.input_size, args.num_classes) == (SIZE, NCLS)
        assert isinstance(server.transfer, export.ExportedTransfer)
        body = jpeg_bytes(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
        x = serve._decode_resize(body, SIZE)[None]
        for query, k in (("class=1", 1), ("class=2", 2)):
            req = urllib.request.Request(f"{base}/translate?{query}",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                got = np.asarray(Image.open(io.BytesIO(r.read())), np.int16)
            direct = server.transfer.translate_u8(
                x, np.eye(NCLS, dtype=np.float32)[[k]]).numpy()[0]
            want = np.asarray(Image.open(io.BytesIO(jpeg_bytes(direct, 95))),
                              np.int16)
            assert got.shape == (SIZE, SIZE, 3)
            assert np.abs(got - want).max() <= 1, query
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/translate?cond=1,2", data=body, method="POST"),
                timeout=60)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    for flags, match in ((["--bf16"], "--bf16 does not apply"),
                         (["--aot_cache", "a"], "--aot_cache does not"),
                         (["--tensor_parallel", "2"], "--tensor_parallel"),
                         (["--cp_path", world["cp"]], "exactly one")):
        with pytest.raises(SystemExit, match=match):
            serve.build_server(serve.build_parser().parse_args(
                ["--artifact", world["art"], "--device", "cpu",
                 "--no-warmup"] + flags))
