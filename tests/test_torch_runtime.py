"""The port's native runtime (``weather_unet_tpu_torch/runtime``) against the
JAX package's (``weather_unet_tpu/runtime``), on the CPU.

The port compiles its own copy of the C++ sources.  Its libjpeg build must
give the JAX package's library's bytes for the same files and uniforms
(decode of a file, of bytes and of a batch, augment, fused decode +
augment): bit for bit.  ``make_affine`` is held to the JAX device formula
``affine_from_uniforms`` at 2e-3 (``tests/test_native_augment.py``'s bar).
The augment-only build (a host without libjpeg) loads without the decode
entries and augments bit for bit.  ``NativeAugment`` and the datasets'
native decode are held to the JAX package's, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu import runtime as jax_runtime
from weather_unet_tpu.data import datasets as jax_datasets
from weather_unet_tpu.data import transforms as jax_tf
from weather_unet_tpu_torch import runtime
from weather_unet_tpu_torch.data import datasets, transforms as tf

CFG = dict(degrees=10.0, resized_crop=True, crop_scale=(0.08, 1.0),
           crop_ratio=(3.0 / 4.0, 4.0 / 3.0), hflip=True, out_size=48)


@pytest.fixture(scope="module")
def built():
    """Both port builds, and the JAX package's library."""
    if not (jax_runtime.native_available() and jax_runtime.augment_available()):
        pytest.fail("the JAX package's native runtime does not load")
    jpeg = runtime.build()
    assert jpeg.mode == "libjpeg", "libjpeg is expected on this host"
    return jpeg, runtime.build(with_jpeg=False)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Seeded JPEGs: small ones (no DCT scaling at out 48) and a 260x200 one
    that the loader decodes at 3/8 scale; one file that is not a JPEG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate([(40, 56), (64, 64), (200, 260), (33, 47)]):
        yy, xx = np.mgrid[:h, :w]
        img = (rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
            xx[..., None] / 7.0 + yy[..., None] / 11.0))
            + rng.normal(0, 20, (h, w, 3)))
        paths.append(str(root / f"{i}.jpg"))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            paths[-1], quality=90)
    bad = root / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    return paths, str(bad)


def test_decode_entries_bit_equal_to_jax(built, jpegs):
    jpeg, _ = built
    paths, bad = jpegs
    for out in (32, 48):
        for p in paths:
            np.testing.assert_array_equal(
                jpeg.decode_file(p, out), jax_runtime.decode_file(p, out))
            with open(p, "rb") as f:
                data = f.read()
            np.testing.assert_array_equal(
                jpeg.decode_bytes(data, out),
                jax_runtime.decode_bytes(data, out))
        got, ok = jpeg.decode_batch(paths + [bad], out, n_threads=2)
        want, ok_j = jax_runtime.decode_batch(paths + [bad], out, n_threads=2)
        np.testing.assert_array_equal(got, want)
        assert ok == ok_j == [True] * len(paths) + [False]
    assert jpeg.decode_file(bad, 32) is None
    assert jpeg.decode_bytes(b"definitely not a jpeg", 32) is None
    # the module-level functions go through the default (libjpeg) build
    np.testing.assert_array_equal(runtime.decode_file(paths[0], 32),
                                  jax_runtime.decode_file(paths[0], 32))


def test_augment_and_fused_decode_bit_equal_to_jax(built, jpegs):
    jpeg, _ = built
    paths, bad = jpegs
    rng = np.random.default_rng(5)
    for crop in (False, True):
        cfg = dict(CFG, resized_crop=crop)
        for p in paths:
            u = rng.random(6).astype(np.float32)
            for jit in (np.full(3, -1.0, np.float32),
                        np.asarray([0.7, 1.2, 0.9], np.float32),
                        np.asarray([1.3, -1.0, 0.6], np.float32)):
                np.testing.assert_array_equal(
                    jpeg.decode_augment_file(p, u, jit, **cfg),
                    jax_runtime.decode_augment_file(p, u, jit, **cfg))
                img = jax_runtime.decode_file(p, 57)
                mat = jpeg.make_affine(57, 57, u, **cfg)
                np.testing.assert_array_equal(
                    mat, jax_runtime.make_affine(57, 57, u, **cfg))
                np.testing.assert_array_equal(
                    jpeg.augment_u8(img, mat, jit, 48),
                    jax_runtime.augment_u8(img, mat, jit, 48))
    assert jpeg.decode_augment_file(bad, u, jit, **CFG) is None


def test_make_affine_matches_jax_formula(built):
    jpeg, _ = built
    rng = np.random.default_rng(0)
    for crop in (False, True):
        cfg = jax_tf.AugmentConfig(out_size=48, resized_crop=crop)
        for _ in range(8):
            h, w = int(rng.integers(30, 200)), int(rng.integers(30, 200))
            u = rng.random(6).astype(np.float32)
            want = np.asarray(jax_tf.affine_from_uniforms(
                jnp.asarray(u), h, w, cfg))
            got = jpeg.make_affine(h, w, u, **dict(CFG, resized_crop=crop))
            np.testing.assert_allclose(got, want, atol=2e-3)


def test_augment_only_build(built, jpegs):
    """Without libjpeg the runtime is augment.cc alone: it loads, exports no
    decode entry, refuses the decode calls and augments bit for bit; the
    extreme affines (an interval past the row, tiny derivatives, inf/nan)
    zero-fill without writing out of bounds (augment.cc's interior-range
    clamp, found by an ASan fuzz)."""
    jpeg, aug_only = built
    assert aug_only.decode_available() is False and jpeg.decode_available()
    assert aug_only.mode == "augment-only" and aug_only.path != jpeg.path
    for sym in ("wut_decode_file", "wut_decode_bytes", "wut_decode_batch",
                "wut_decode_augment_file"):
        assert not hasattr(aug_only.lib, sym), sym
    with pytest.raises(RuntimeError, match="without libjpeg"):
        aug_only.decode_file(jpegs[0][0], 32)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (57, 57, 3), dtype=np.uint8)
    for _ in range(4):
        mat = aug_only.make_affine(57, 57, rng.random(6), **CFG)
        jit = np.asarray([0.8, 1.1, 1.2], np.float32)
        np.testing.assert_array_equal(aug_only.augment_u8(img, mat, jit, 48),
                                      jax_runtime.augment_u8(img, mat, jit,
                                                             48))
    small = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    mats = [
        np.asarray([0.0, 0.0, 1e9, 0.0, 0.0, 1e9], np.float32),
        np.asarray([1e-30, 0.0, -5.0, 0.0, 1e-30, -5.0], np.float32),
        np.asarray([1e30, -1e30, 0.0, -1e30, 1e30, 0.0], np.float32),
        np.asarray([np.inf, 0.0, np.nan, 0.0, -np.inf, 0.0], np.float32),
        np.asarray([0.0, 0.0, 20.0, 0.0, 0.0, 20.0], np.float32),
    ]
    for rt in (jpeg, aug_only):
        for mat in mats:
            for jit in (np.full(3, -1.0, np.float32),
                        np.asarray([1.2, 0.8, 1.1], np.float32)):
                out = rt.augment_u8(small, mat, jit, 24)
                np.testing.assert_array_equal(
                    out, jax_runtime.augment_u8(small, mat, jit, 24))


def pil_rgb(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


@pytest.mark.parametrize("route", ["libjpeg", "pillow"])
def test_native_augment_matches_jax(built, jpegs, route):
    """``NativeAugment`` draws the JAX package's keyed streams.  With the
    libjpeg runtime ``from_path`` is bit-equal to the JAX package's fused
    call.  The Pillow-decode route (augment-only runtime) is, bit for bit,
    the JAX package's native augment of Pillow's full-size decode; where
    the loader takes no DCT scaling (the small files) that is also its
    fused call's result, while the 260x200 file, which libjpeg decodes at
    3/8, comes out differently (no antialiasing either way)."""
    jpeg, aug_only = built
    paths, bad = jpegs
    kw = dict(seed=7, resized_crop=True, brightness=0.5, contrast=0.3,
              saturation=0.3)
    port = tf.NativeAugment(48, runtime=jpeg if route == "libjpeg"
                            else aug_only, **kw)
    fused, keyed = jax_tf.NativeAugment(48, **kw), jax_tf.NativeAugment(48,
                                                                        **kw)
    assert port.route == ("native (libjpeg decode)" if route == "libjpeg"
                          else "native (Pillow decode)")
    for epoch in (0, 1):
        for t in (port, fused, keyed):
            t.set_epoch(epoch)
        for p in paths + paths[:1]:     # a second draw of one path
            got, want = port.from_path(p), fused.from_path(p)
            if route == "libjpeg":
                np.testing.assert_array_equal(got, want)
                continue
            np.testing.assert_array_equal(got,
                                          keyed.augment_keyed(pil_rgb(p), p))
            if p == paths[2]:
                assert not np.array_equal(got, want)
            else:
                np.testing.assert_array_equal(got, want)
        img = jax_runtime.decode_file(paths[1], 57)
        np.testing.assert_array_equal(port.augment_keyed(img, "k"),
                                      fused.augment_keyed(img, "k"))
    with pytest.raises(OSError):
        port.from_path(bad)


def test_make_train_augment_selects_and_decode_routes(built, jpegs,
                                                      monkeypatch):
    paths, _ = jpegs
    aug = tf.make_train_augment(32)
    assert isinstance(aug, tf.NativeAugment)
    assert isinstance(tf.make_train_augment(32, prefer_native=False),
                      tf.HostAugment)
    monkeypatch.setenv("WUT_NATIVE_AUGMENT", "0")
    assert isinstance(tf.make_train_augment(32), tf.HostAugment)
    assert isinstance(tf.make_train_augment(32, prefer_native=True),
                      tf.NativeAugment)
    monkeypatch.delenv("WUT_NATIVE_AUGMENT")
    # a host that cannot build the runtime: None falls back to Pillow, True
    # raises with the compiler's output
    monkeypatch.setattr(runtime, "load", lambda: None)
    monkeypatch.setattr(runtime, "build_error", lambda: "c++: fatal: boom")
    assert isinstance(tf.make_train_augment(32), tf.HostAugment)
    with pytest.raises(RuntimeError, match="boom"):
        tf.make_train_augment(32, prefer_native=True)
    monkeypatch.undo()
    # the datasets' native decode, and WUT_NATIVE_DECODE=1
    for p in paths:
        np.testing.assert_array_equal(
            datasets._decode(p, 40, prefer_native=True),
            jax_datasets._decode(p, 40, prefer_native=True))
    monkeypatch.setenv("WUT_NATIVE_DECODE", "1")
    np.testing.assert_array_equal(datasets._decode(paths[2], 40),
                                  jax_runtime.decode_file(paths[2], 40))
    monkeypatch.delenv("WUT_NATIVE_DECODE")
    np.testing.assert_array_equal(datasets._decode(paths[2], 40),
                                  jax_datasets._decode(paths[2], 40))
    # _load hands a JPEG to the transform's fused path, on the keyed stream
    ds = datasets.ImagePathDataset(paths, out_size=64,
                                   transform=tf.NativeAugment(24, seed=2))
    ref = jax_datasets.ImagePathDataset(
        paths, out_size=64, transform=jax_tf.NativeAugment(24, seed=2))
    for i in range(len(paths)):
        np.testing.assert_array_equal(ds[i][0], ref[i][0])
