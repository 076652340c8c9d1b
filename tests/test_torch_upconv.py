"""K3's plain version (weather_unet_tpu_torch.kernels.upconv) and its
autograd against the JAX package's fused upsample+conv Pallas kernel run in
interpret mode, at the shapes of tests/test_kernels.py, and the tap tables
the CUDA kernel reads rebuilt in PyTorch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_util import (  # noqa: F401
    block_inputs, nchw, nhwc, no_thread_left, oihw, one_torch_thread)
from weather_unet_tpu.kernels import upconv_pallas
from weather_unet_tpu_torch.kernels import upconv as k3
from weather_unet_tpu_torch.ops.resize import upsample_bilinear_align_corners

UPCONV_SHAPES = ((2, 8, 8, 16, 8), (1, 16, 12, 32, 16), (2, 5, 7, 8, 4))


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_plain_matches_pallas_interpret(rng, shape):
    b, h, w, c, o = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, c, o))).astype(np.float32)
    want = np.asarray(upconv_pallas.upsample2x_conv3x3(
        jnp.asarray(x), jnp.asarray(k), interpret=True))
    tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    for fn in (k3.upsample2x_conv3x3, k3.upsample2x_conv3x3_ref):
        got = nhwc(fn(nchw(x), oihw(k)))
        assert got.shape == (b, 2 * h, 2 * w, o)
        assert float(np.abs(got - want).max()) < tol


def test_upconv_block_matches_pallas_interpret(rng):
    x, k, cb, sc, sh = block_inputs(rng)
    j = [jnp.asarray(a) for a in (x, k, cb, sc, sh)]
    want = np.asarray(upconv_pallas.upconv_block_fused(*j, True, True))
    want_ref = np.asarray(upconv_pallas.upconv_block_ref(*j, relu=True))
    t = (nchw(x), oihw(k), nchw(cb), torch.from_numpy(sc),
         torch.from_numpy(sh))
    got = nhwc(k3.upconv_block_fused(*t, True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(nhwc(k3.upconv_block_ref(*t, True)), want_ref,
                               atol=1e-5)
    assert got.min() >= 0.0                      # relu applied


def test_upconv_block_grads_match_pallas_vjp(rng):
    x, k, cb, sc, sh = block_inputs(rng)
    gj = jax.grad(lambda a, b: jnp.sum(jnp.sin(upconv_pallas.upconv_block_fused(
        a, b, jnp.asarray(cb), jnp.asarray(sc), jnp.asarray(sh), True, True))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = nchw(x).requires_grad_(), oihw(k).requires_grad_()
    torch.sin(k3.upconv_block_fused(xt, kt, nchw(cb), torch.from_numpy(sc),
                                    torch.from_numpy(sh), True)).sum().backward()
    gx, gk = np.asarray(gj[0]), np.asarray(gj[1])
    # kernel grads are O(100): compare relative, as tests/test_kernels.py does
    assert float(np.abs(nhwc(xt.grad) - gx).max()) < 2e-5 * max(
        1.0, float(np.abs(gx).max()))
    gk_t = np.transpose(kt.grad.numpy(), (2, 3, 1, 0))
    assert float(np.abs(gk_t - gk).max()) < 2e-5 * max(1.0,
                                                         float(np.abs(gk).max()))


@pytest.mark.parametrize("shape", [(2, 5, 7, 8, 4), (1, 6, 6, 3, 2)])
def test_tap_tables_rebuild_the_padded_modulated_upsample(rng, shape):
    """Redo the K3 kernel's patch arithmetic in PyTorch from the exact tables
    the wrapper hands the kernel (layout, modulation per tap, zero halo),
    then convolve without padding: it must equal the plain chain, so the
    halo carries 0 and never ``shift``."""
    b, h, w, c, o = shape
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    k = torch.from_numpy(0.3 * rng.standard_normal((o, c, 3, 3)).astype(
        np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 2.0, (b, c)).astype(np.float32))
    sh = torch.from_numpy(3.0 + rng.standard_normal((b, c)).astype(np.float32))
    idx, frac = k3._tap_tables(h, w, torch.device("cpu"))
    h2, w2 = 2 * h, 2 * w
    hi0, hi1 = idx[:h2].long(), idx[h2:2 * h2].long()
    wi0, wi1 = idx[2 * h2:2 * h2 + w2].long(), idx[2 * h2 + w2:].long()
    fy, fx = frac[:h2, None], frac[h2:][None, :]
    xm = x * sc[:, :, None, None] + sh[:, :, None, None]
    a = lambda ri, ci: xm[:, :, ri][:, :, :, ci]          # noqa: E731
    up = ((1 - fy) * ((1 - fx) * a(hi0, wi0) + fx * a(hi0, wi1))
          + fy * ((1 - fx) * a(hi1, wi0) + fx * a(hi1, wi1)))
    got = F.conv2d(F.pad(up, (1, 1, 1, 1)), k)
    want = k3.upsample2x_conv3x3_ref(x, k, scale=sc, shift=sh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        up.numpy(), upsample_bilinear_align_corners(xm).numpy(), atol=2e-6)
