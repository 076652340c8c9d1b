"""The GAN step's branches that the training CLIs drive beyond est mode and
cls cross-entropy, held to ``weather_unet_tpu/train/gan.py`` on the CPU: cls
supervised with one-hot conditions (with and without cross-entropy), cls
semi-supervised with the classifier's softmax in the MSE, the i2w
cross-entropy targets (the random batch's class ids), and the D-only step
(``do_g=False``, the ``GD_train_ratio`` gate).

One combined step from one JAX init, jitted JAX, 16x16, batch 2, dropout 0,
with the bars of tests/test_torch_gan.py: losses rtol 2e-4, updated
parameters within the Adam sign-flip bound, Adam's moments within
``MOMENT_TOL`` of the network's largest element, u within 1e-4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_gan import (
    BATCH, LR, MOMENT_TOL, SIZE, adam_moments, assert_adam_close, jax_sds,
    load_jax_state, port_moments, port_sds)
from tests.torch_port_util import nchw, one_torch_thread  # noqa: F401
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)

BRANCHES = {
    "cls_supervised": dict(mode="cls", supervised=True),
    "cls_supervised_ce": dict(mode="cls", supervised=True, cross_ent=True),
    "cls_semi_softmax_mse": dict(mode="cls"),
    "cls_i2w_ce": dict(mode="cls", cross_ent=True, dataset="i2w"),
    "d_only": dict(mode="est"),
}


def flat(sd, keys):
    return np.concatenate([np.asarray(sd[k]).ravel() for k in keys])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_gan_step_branch_matches_jax(branch):
    kw = dict(input_size=SIZE, batch_size=BATCH, dropout_rate=0.0, lr=LR,
              **BRANCHES[branch])
    do_g = branch != "d_only"
    jcfg, cfg = jax_gan.GanConfig(**kw), GanConfig(**kw)
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    load_jax_state(state, jstate)
    # a linear estimator head on mean-pooled pixels, scaled so the softmax
    # of the cls branches is far from uniform
    est_w = 4.0 * np.random.default_rng(5).standard_normal((3, 5)).astype(
        np.float32)
    w_t = torch.from_numpy(est_w)
    jstep = jax.jit(functools.partial(
        jax_gan.make_gan_step(
            jgen, jdisc,
            lambda im: jnp.mean(im, axis=(1, 2)) @ jnp.asarray(est_w), jcfg),
        do_g=do_g))
    step = make_gan_step(gen, disc,
                         lambda im: im.mean(dim=(2, 3)) @ w_t.to(im.dtype),
                         cfg)
    rng = np.random.default_rng(23)
    images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    rand = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    c_d, c_r = np.array([4, 0], np.int32), np.array([1, 3], np.int32)
    g_before = {k: v.clone() for k, v in gen.state_dict().items()}

    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(c_d),
                       jnp.asarray(rand), jnp.asarray(c_r),
                       jax.random.key(1))
    state, m = step(state, nchw(images), torch.from_numpy(c_d), nchw(rand),
                    torch.from_numpy(c_r), train_generator(0, "cpu"),
                    do_g=do_g)

    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    got, want = port_sds(gen, disc), jax_sds(jstate)
    for g_sd, w_sd, what in zip(got, want, ("gen", "disc")):
        params = sorted(k for k in g_sd
                        if not k.endswith(("weight_u", "weight_v")))
        assert_adam_close(flat(g_sd, params), flat(w_sd, params), LR, 1,
                          what)
    for k in got[1]:
        if k.endswith("weight_u"):
            np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-4,
                                       err_msg=f"u {k}")
    count, *jax_moments = adam_moments(jstate)
    assert count == int(do_g)              # the gen Adam count
    for pair, jpair, root in zip(port_moments(state), jax_moments,
                                 (False, True)):
        nets = zip(pair, jpair, MOMENT_TOL) if do_g else [
            (pair[1], jpair[1], MOMENT_TOL[1])]       # D alone moved
        for g_sd, w_sd, tol in nets:
            keys = sorted(g_sd)
            a, b = flat(g_sd, keys), flat(w_sd, keys)
            if root:
                a, b = np.sqrt(a), np.sqrt(b)
            assert np.abs(a - b).max() <= tol * np.abs(b).max()
    if not do_g:
        # G neither updated nor given Adam state; D and u did move
        assert all(torch.equal(v, g_before[k])
                   for k, v in gen.state_dict().items())
        assert not state.gen.optimizer.state
    assert (state.gen.step, state.disc.step, state.global_step) == (
        int(do_g), 1, 1)
    assert int(jstate.global_step) == 1
