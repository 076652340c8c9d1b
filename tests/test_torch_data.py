"""The port's data pipeline against the JAX package's host code, on the CPU,
over seeded synthetic JPEGs written with Pillow: datasets, the imbalance
sampler, ``HostAugment`` on its keyed and counter streams, ``fork_stream``
and ``BatchLoader`` with ``set_epoch`` yield uint8 batches bit-equal to the
JAX package's (its ``HostAugment`` built directly: ``make_train_augment``
there picks the native augment when that runtime is built).
``normalize_batch`` within 1e-6 of JAX without a resize and 1e-5 with one;
``resize_bilinear_torch`` within 1e-5 in both conventions (the bar of
tests/test_torch_resize.py)."""

import os

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch
from PIL import Image

import weather_unet_tpu.data.datasets as jax_ds
import weather_unet_tpu.data.pipeline as jax_pipe
import weather_unet_tpu.data.sampler as jax_sampler
import weather_unet_tpu.data.transforms as jax_tf
from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.ops.resize import resize_bilinear_torch as jax_resize
from weather_unet_tpu_torch.cli.common import (
    list_images, load_flickr_frame, wrap_decode_cache)
from weather_unet_tpu_torch.data import datasets as ds
from weather_unet_tpu_torch.data import pipeline as pipe
from weather_unet_tpu_torch.data import transforms as tf
from weather_unet_tpu_torch.data.sampler import ImbalancedSampler
from weather_unet_tpu_torch.ops.resize import resize_bilinear_torch

AUG_KW = {"plain": dict(),
          "augmentation": dict(resized_crop=True, brightness=0.5,
                               contrast=0.3, saturation=0.3)}


def write_jpegs(root, names, size=(48, 40), seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for name in names:
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # smooth fields plus noise: JPEG keeps them, and they survive resize
        yy, xx = np.mgrid[:size[1], :size[0]]
        base = rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
            xx[..., None] / rng.uniform(3, 9) + yy[..., None] / 7.0))
        img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(path, quality=90)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 Flickr photos with a frame, and an i2w tree of 12 images over the
    5 classes plus the skipped z-other."""
    root = str(tmp_path_factory.mktemp("corpus"))
    flickr = os.path.join(root, "flickr")
    write_jpegs(flickr, [f"{i}.jpg" for i in range(16)], seed=1)
    rng = np.random.default_rng(2)
    df = pd.DataFrame({
        "photo": [str(i) for i in range(16)],
        "mode": ["train"] * 12 + ["test"] * 4,
        **{c: rng.standard_normal(16) for c in ds.SIGNAL_COLUMNS},
        "condition2": [jax_ds.WEATHER_CLASSES_FLICKR[i % 5]
                       for i in range(16)],
        "w_condition": [jax_ds.WEATHER_CLASSES_FLICKR[(i * 3) % 4]
                        for i in range(16)]})
    df.loc[3, "temp"] = np.nan
    pkl = os.path.join(root, "frame.pkl")
    df.to_pickle(pkl)
    classes = jax_ds.WEATHER_CLASSES_I2W + ["z-other"]
    i2w = write_jpegs(os.path.join(root, "i2w"),
                      [f"{classes[i % 6]}/{i}.jpg" for i in range(12)],
                      seed=3)
    return {"flickr": flickr, "pkl": pkl, "i2w": i2w}


def items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


def test_datasets_match_jax(corpus):
    df, mean, std = load_flickr_frame(corpus["pkl"])
    jdf = pd.read_pickle(corpus["pkl"])
    jdf, jmean, jstd = jax_ds.zscore_columns(jdf, jax_ds.SIGNAL_COLUMNS)
    pd.testing.assert_frame_equal(df, jdf)
    assert ds.SIGNAL_COLUMNS == jax_ds.SIGNAL_COLUMNS
    assert ds.class_id_from_string("snow") == jax_ds.class_id_from_string(
        "snow")
    assert ds.flickr_image_path("r", 7) == jax_ds.flickr_image_path("r", 7)
    pairs = []
    for class_id in (None, True, False):
        for imbalance in (False, True):
            pairs.append(tuple(
                m.FlickrDataset(corpus["flickr"], df, m.SIGNAL_COLUMNS,
                                out_size=32, class_id=class_id,
                                imbalance=imbalance) for m in (ds, jax_ds)))
    paths = list_images(corpus["flickr"])
    pairs.append(tuple(m.ImagePathDataset(paths, out_size=24, with_path=True)
                       for m in (ds, jax_ds)))
    pairs.append(tuple(m.ImagePathDataset(paths) for m in (ds, jax_ds)))
    pairs.append(tuple(m.ClassImageDataset(corpus["i2w"], out_size=32,
                                           inf=True) for m in (ds, jax_ds)))
    assert ds.filter_i2w_paths(corpus["i2w"]) == jax_ds.filter_i2w_paths(
        corpus["i2w"])
    assert len(pairs[-1][0]) == 10                 # z-other skipped
    for port, ref in pairs:
        assert len(port) == len(ref)
        for i in range(len(ref)):
            items_equal(port[i], ref[i])
    # the native decode is ported now: the JAX package's bytes
    np.testing.assert_array_equal(
        ds._decode(paths[0], 32, prefer_native=True),
        jax_ds._decode(paths[0], 32, prefer_native=True))


@pytest.mark.parametrize("config", list(AUG_KW))
def test_host_augment_streams_match_jax(corpus, config):
    """Keyed streams over two epochs (a path drawn twice in an epoch takes
    its second draw), the counter stream, and fork_stream's copy."""
    paths = list_images(corpus["flickr"])[:6]
    images = [ds._decode(p, 40) for p in paths]
    port = tf.make_train_augment(32, seed=5, prefer_native=False,
                                 **AUG_KW[config])
    ref = jax_tf.HostAugment(32, seed=5, **AUG_KW[config])
    assert type(port) is tf.HostAugment
    for aug_p, aug_r in ((port, ref), (tf.fork_stream(port),
                                       jax_tf.fork_stream(ref))):
        for epoch in (0, 1):
            aug_p.set_epoch(epoch)
            aug_r.set_epoch(epoch)
            for img, path in list(zip(images, paths)) * 2:
                a = aug_p.augment_keyed(img, path)
                assert a.shape == (32, 32, 3) and a.dtype == np.uint8
                assert np.array_equal(a, aug_r.augment_keyed(img, path))
        for img in images:
            assert np.array_equal(aug_p(img), aug_r(img))
    assert tf.fork_stream(port).seed == 6 and tf.fork_stream(None) is None
    # the native augment is ported now (tests/test_torch_runtime.py)
    assert type(tf.make_train_augment(32, prefer_native=True)) is (
        tf.NativeAugment)


def test_batch_loaders_match_jax(corpus):
    """Content and random loaders as the CLIs zip them (shuffle, drop_last,
    the random loader on a forked stream and seed 1, the imbalance sampler),
    over three epochs with set_epoch, 3 threads (the sampled one 1); a tail
    batch without
    drop_last; then ImbalancedSampler alone."""
    df, _, _ = load_flickr_frame(corpus["pkl"])
    sides = {}
    for name, m_ds, m_tf, m_pipe, m_smp in (
            ("port", ds, tf, pipe, ImbalancedSampler),
            ("jax", jax_ds, jax_tf, jax_pipe, jax_sampler.ImbalancedSampler)):
        aug = m_tf.HostAugment(32, resized_crop=True, brightness=0.5,
                               seed=0)
        train = m_ds.FlickrDataset(corpus["flickr"], df, m_ds.SIGNAL_COLUMNS,
                                   out_size=36, class_id=False,
                                   transform=aug)
        rand = m_ds.with_transform(train, m_tf.fork_stream(aug))
        loaders = [
            m_pipe.BatchLoader(train, 4, shuffle=True, num_workers=3),
            m_pipe.BatchLoader(rand, 4, shuffle=True, seed=1, num_workers=3),
            # one thread: a path drawn twice into one batch races for its
            # per-path draw count (_KeyedRngMixin), in either package
            m_pipe.BatchLoader(rand, 4, sampler=m_smp(rand, seed=2),
                               num_workers=1),
            m_pipe.BatchLoader(train, 5, shuffle=True, drop_last=False,
                               num_workers=3)]
        out = []
        for epoch in range(3):
            for ld in loaders:
                ld.set_epoch(epoch)
                out.append([b for b in ld])
        sides[name] = (out, [len(ld) for ld in loaders])
    (port, port_lens), (ref, ref_lens) = sides["port"], sides["jax"]
    assert port_lens == ref_lens == [4, 4, 4, 4]
    assert [len(e) for e in port] == [len(e) for e in ref]
    assert len(port[3][-1][0]) == 1                # the tail batch
    for ep, er in zip(port, ref):
        for bp, br in zip(ep, er):
            assert bp[0].dtype == np.uint8
            items_equal(bp, br)

    # the sampler alone: a subset of indices, more draws than indices
    port_ds = ds.FlickrDataset(corpus["flickr"], df, ds.SIGNAL_COLUMNS,
                               imbalance=True)
    jax_set = jax_ds.FlickrDataset(corpus["flickr"], df,
                                   jax_ds.SIGNAL_COLUMNS, imbalance=True)
    port = ImbalancedSampler(port_ds, indices=range(2, 14), num_samples=40,
                             seed=3)
    ref = jax_sampler.ImbalancedSampler(jax_set, indices=range(2, 14),
                                        num_samples=40, seed=3)
    np.testing.assert_array_equal(port.probs, ref.probs)
    for epoch in (None, 0, 7):
        if epoch is not None:
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
        assert list(port) == list(ref) and len(port) == len(ref) == 40


@pytest.mark.parametrize("out_size", [None, 24], ids=["no_resize", "resize"])
def test_normalize_batch_matches_jax(out_size):
    u8 = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3),
                                           dtype=np.uint8)
    want = np.asarray(jax_tf.normalize_batch(jnp.asarray(u8), out_size))
    got = tf.normalize_batch(torch.from_numpy(u8), out_size)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (3, 3) + want.shape[1:3]
    np.testing.assert_allclose(nhwc(got), want, rtol=0,
                               atol=1e-6 if out_size is None else 1e-5)
    assert torch.equal(tf.normalize_batch(u8, out_size), got)   # numpy in


def test_resize_bilinear_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 13, 17, 3)).astype(
        np.float32)
    for align in (True, False):
        for hw in ((26, 34), (7, 9), (13, 30)):
            want = np.asarray(jax_resize(jnp.asarray(x), *hw,
                                         align_corners=align))
            got = nhwc(resize_bilinear_torch(nchw(x), *hw,
                                             align_corners=align))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    t = nchw(x)
    assert resize_bilinear_torch(t, 13, 17) is t


def test_cpu_prefetch_passes_batches_through_and_cache_refuses(tmp_path):
    """(The decode cache is ported now: ``wrap_decode_cache`` wraps.)"""
    batches = [(np.zeros((2, 4, 4, 3), np.uint8), np.arange(2))
               for _ in range(3)]
    out = list(pipe.device_prefetch(iter(batches), "cpu", depth=2))
    assert len(out) == 3 and all(o is b for o, b in zip(out, batches))
    aug = tf.HostAugment(8)
    assert wrap_decode_cache(aug, None, 8, []) is aug
    wrapped = wrap_decode_cache(aug, str(tmp_path / "cache_dir"), 8, [])
    assert wrapped.augment is aug and wrapped.cache.base == 8
