"""The port's device augment (``data/transforms.py``: ``AugmentConfig``,
``affine_from_uniforms``, ``_affine_sample``, ``_color_jitter``,
``augment_batch``) against the JAX package's, on the CPU, and the GAN
trainer's ``device_augment``.

The port draws from a ``torch.Generator``, not JAX's threefry keys, so what
is held to JAX is the deterministic core given the draws: the affine
matrices within 1e-5 of the largest entry (the port evaluates them in
float64 and rounds once, JAX in float32: an ulp apart), the 4-tap sample
given a matrix and the jitter given its factors within 1e-5 (float32; the
port takes the JAX package's order of operations, and the sample is held
to JAX's under ``vmap``, as ``augment_batch`` runs it).  The whole
``augment_batch`` given the uniforms and factors that JAX's keys draw is
held at 1e-4: an ulp of a translation entry (7.6e-6 at 64) moves a sample
by up to that much per unit of image gradient (1 per pixel in these noise
images, in x and in y), which the jitter can scale by 1.5 * 1.3 * 1.3 and
Normalize(0.5, 0.5) by 2.  With rotation, crop and jitter off the warp is
exact: the identity, or a horizontal mirror.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_trainer import (
    BATCH, SIZE, Images, cfg_of, est_apply, loaders, assert_states_equal,
    trainer)
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.data import transforms as jax_tf
from weather_unet_tpu_torch.core.rng import fold_seed
from weather_unet_tpu_torch.data import transforms as tf
from weather_unet_tpu_torch.train.gan import build_gan_state, make_gan_step

JITTER = dict(brightness=0.5, contrast=0.3, saturation=0.3)


def configs(out_size, crop=True, **kw):
    return (jax_tf.AugmentConfig(out_size=out_size, resized_crop=crop, **kw),
            tf.AugmentConfig(out_size=out_size, resized_crop=crop, **kw))


def jax_draws(key, n, cfg):
    """The uniforms and jitter factors that JAX's ``augment_batch`` draws
    from ``key`` for ``n`` images (its ``_one_affine`` / ``_color_jitter``
    key splits)."""
    keys = jax.random.split(key, n * 2).reshape(n, 2)
    us, fs = [], []
    for i in range(n):
        k_rot, k_scale, k_ratio, k_pos, k_flip = jax.random.split(keys[i, 0],
                                                                  5)
        pos = jax.random.uniform(k_pos, (2,))
        us.append([jax.random.uniform(k_rot, ()),
                   jax.random.uniform(k_scale, ()),
                   jax.random.uniform(k_ratio, ()), pos[0], pos[1],
                   jax.random.uniform(k_flip, ())])
        fs.append([jax.random.uniform(k, (), minval=max(0.0, 1 - j),
                                      maxval=1 + j) if j else 1.0
                   for k, j in zip(jax.random.split(keys[i, 1], 3),
                                   (cfg.brightness, cfg.contrast,
                                    cfg.saturation))])
    return (torch.tensor(np.asarray(us, np.float32)),
            torch.tensor(np.asarray(fs, np.float32)))


@pytest.mark.parametrize("crop", [False, True], ids=["resize", "crop"])
def test_affine_and_sample_match_jax(crop):
    rng = np.random.default_rng(0)
    for (h, w, out) in [(64, 64, 48), (40, 56, 32), (16, 16, 16),
                        (33, 47, 64)]:
        jcfg, pcfg = configs(out, crop)
        imgs = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
        u = rng.random((3, 6)).astype(np.float32)
        want = np.stack([np.asarray(jax_tf.affine_from_uniforms(
            jnp.asarray(u[i]), h, w, jcfg)) for i in range(3)])
        mats = tf.affine_from_uniforms(torch.from_numpy(u), h, w, pcfg)
        assert mats.dtype == torch.float32 and mats.shape == (3, 2, 3)
        np.testing.assert_allclose(mats.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
        got = tf._affine_sample(torch.from_numpy(imgs),
                                torch.from_numpy(want), out).numpy()
        # batched, as augment_batch runs it
        ref = np.asarray(jax.vmap(
            lambda im, m: jax_tf._affine_sample(im, m, out))(
            jnp.asarray(imgs, jnp.float32) / 255.0, jnp.asarray(want)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_color_jitter_matches_jax():
    """Each jitter alone and all three in order (the contrast mean taken of
    the brightened image), factors from JAX's own key splits."""
    img = np.random.default_rng(1).random((2, 24, 24, 3)).astype(np.float32)
    for b, c, s in [(0.5, 0, 0), (0, 0.3, 0), (0, 0, 0.3), (0.5, 0.3, 0.3)]:
        jcfg, pcfg = configs(24, brightness=b, contrast=c, saturation=s)
        keys = jax.random.split(jax.random.key(4), 2)
        want = np.stack([np.asarray(jax_tf._color_jitter(
            keys[i], jnp.asarray(img[i]), jcfg)) for i in range(2)])
        fs = torch.tensor(np.asarray([[
            jax.random.uniform(k, (), minval=max(0.0, 1 - j), maxval=1 + j)
            if j else 1.0 for k, j in zip(jax.random.split(keys[i], 3),
                                          (b, c, s))] for i in range(2)],
            np.float32))
        got = tf._color_jitter(torch.from_numpy(img), fs, pcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("crop", [False, True], ids=["resize", "crop"])
def test_augment_batch_core_matches_jax(crop):
    rng = np.random.default_rng(2)
    for (h, out) in [(64, 48), (32, 32)]:
        jcfg, pcfg = configs(out, crop, **JITTER)
        imgs = rng.integers(0, 256, (4, h, h, 3), dtype=np.uint8)
        key = jax.random.key(int(rng.integers(1 << 30)))
        want = np.asarray(jax_tf.augment_batch(key, jnp.asarray(imgs), jcfg))
        u, fs = jax_draws(key, 4, jcfg)
        got = tf.augment_from_uniforms(torch.from_numpy(imgs), u, fs, pcfg)
        assert got.shape == (4, 3, out, out) and got.is_contiguous()
        np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)


def test_hflip_only_and_identity_are_exact():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (16, 24, 24, 3), dtype=np.uint8)
    norm = tf.normalize_batch(imgs)
    g = torch.Generator().manual_seed(3)
    same = tf.augment_batch(g, imgs, tf.AugmentConfig(
        out_size=24, degrees=0.0, hflip=False))
    assert torch.equal(same, norm)
    out = tf.augment_batch(g, imgs, tf.AugmentConfig(out_size=24,
                                                     degrees=0.0))
    n_flip = 0
    for i in range(len(imgs)):
        if torch.equal(out[i], norm[i]):
            continue
        assert torch.equal(out[i], norm[i].flip(-1)), f"sample {i}"
        n_flip += 1
    assert 0 < n_flip < len(imgs)       # both outcomes occur


def test_draws_lie_in_range_and_follow_the_seed():
    cfg = tf.AugmentConfig(out_size=32, resized_crop=True, **JITTER)
    g = torch.Generator().manual_seed(0)
    u, fs = tf.draw_uniforms(g, 4096, cfg)
    assert u.shape == (4096, 6) and fs.shape == (4096, 3)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    lo, hi = torch.tensor([0.5, 0.7, 0.7]), torch.tensor([1.5, 1.3, 1.3])
    assert bool(((fs >= lo) & (fs <= hi)).all())
    # the draws cover their ranges
    assert bool((fs.min(0).values < lo + 0.01).all())
    assert bool((fs.max(0).values > hi - 0.01).all())
    imgs = np.random.default_rng(4).integers(0, 256, (4, 40, 40, 3),
                                             np.uint8)
    a = tf.augment_batch(torch.Generator().manual_seed(7), imgs, cfg)
    b = tf.augment_batch(torch.Generator().manual_seed(7), imgs, cfg)
    c = tf.augment_batch(torch.Generator().manual_seed(8), imgs, cfg)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == (4, 3, 32, 32) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0


def test_trainer_device_augment_equals_hand_loop(tmp_path):
    """``WeatherTransferTrainer(device_augment=True, augment=True)``: each
    step warps both batches with ``augment_batch`` on a generator seeded
    from (seed + 3, global step), the content batch first."""
    cfg = cfg_of(num_epoch=1)
    data = Images(5)
    tr = trainer(tmp_path, cfg, device_augment=True, augment=True)
    tr.fit(*loaders(data))
    aug_cfg = tf.AugmentConfig(out_size=SIZE, resized_crop=True, **JITTER)
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    step = make_gan_step(gen, disc, est_apply, cfg)
    g, ga = torch.Generator(), torch.Generator()
    zeros = torch.zeros(BATCH, dtype=torch.long)
    train, rand = loaders(data)
    tl, rl = train(), rand()
    tl.set_epoch(0)
    rl.set_epoch(0)
    for gstep, ((x, *_), (r, *_)) in enumerate(zip(tl, rl), start=1):
        g.manual_seed(fold_seed(1, gstep))
        ga.manual_seed(fold_seed(3, gstep))
        images = tf.augment_batch(ga, x, aug_cfg)
        state, _ = step(state, images, zeros, tf.augment_batch(ga, r, aug_cfg),
                        zeros, g, do_g=True)
    state.epoch += 1
    assert state.global_step == 2
    assert_states_equal(tr.state, state)
