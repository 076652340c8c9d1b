"""PyTorch port ops (weather_unet_tpu_torch.ops.norm, .convs) against their
JAX counterparts on the CPU, same numpy inputs.  The port runs NCHW/OIHW,
JAX NHWC/HWIO; inputs are transposed at the boundary."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, oihw, one_torch_thread)
from weather_unet_tpu.ops import convs as jconvs
from weather_unet_tpu.ops import norm as jnorm
from weather_unet_tpu_torch.ops import convs, norm


@pytest.mark.parametrize("shape", [(3, 16, 16, 32), (2, 5, 7, 8)])
def test_adain_matches_jax(rng, shape):
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    y = rng.standard_normal((shape[0], shape[-1] * 4)).astype(np.float32)
    want = np.asarray(jnorm.adain(jnp.asarray(x), jnp.asarray(y)))
    got = nhwc(norm.adain(nchw(x), torch.from_numpy(y)))
    # float32 reassociation of the H*W reductions
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_adain_scale_shift_matches_jax(rng):
    x = rng.standard_normal((3, 8, 8, 16)).astype(np.float32)
    y = rng.standard_normal((3, 64)).astype(np.float32)
    sc_j, sh_j = jnorm.adain_scale_shift(jnp.asarray(x), jnp.asarray(y))
    sc, sh = norm.adain_scale_shift(nchw(x), torch.from_numpy(y))
    assert sc.dtype == sh.dtype == torch.float32 and sc.shape == (3, 16)
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=1e-5)
    np.testing.assert_allclose(sh.numpy(), np.asarray(sh_j), atol=1e-5)
    # the factored form reproduces adain itself
    xt = nchw(x)
    out = xt * sc[:, :, None, None] + sh[:, :, None, None]
    np.testing.assert_allclose(out.numpy(),
                               norm.adain(xt, torch.from_numpy(y)).numpy(),
                               atol=1e-5)


def test_adain_variance_is_unbiased_over_four_style_values():
    """Constant x channels would give var 0 under any ddof; a two-value
    spatial map pins ddof=1 over H*W, and y pins ddof=1 over 4 values."""
    x = torch.tensor([1.0, 3.0]).reshape(1, 1, 1, 2)
    y = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
    mean, var = norm._mean_var_unbiased(x, (2, 3))
    assert float(mean) == 2.0 and float(var) == 2.0            # ddof=1
    y_mean, y_std = norm._style_stats(y, 1, 1, 0.0)
    assert float(y_mean) == 1.0
    assert abs(float(y_std) - np.sqrt(4.0 / 3.0)) < 1e-6       # ddof=1


def test_adain_bf16_two_pass_stays_finite():
    """Near-constant channels with a large mean: one-pass variance cancels
    below zero in bf16; the two-pass form must stay finite."""
    x = (300.0 + 0.01 * torch.randn(2, 4, 16, 16,
                                     generator=torch.Generator().manual_seed(0))
         ).to(torch.bfloat16)
    y = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    out = norm.adain(x, y.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("k,pad,stride", [(3, 1, 1), (1, 0, 1), (3, 1, 2)])
def test_conv2d_matches_jax(rng, k, pad, stride):
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, k, 6, 5))).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jconvs.conv2d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(bias), stride=stride,
                                    padding=pad))
    got = nhwc(convs.conv2d(nchw(x), oihw(w), torch.from_numpy(bias),
                            stride=stride, padding=pad))
    np.testing.assert_allclose(got, want, atol=1e-5)
